"""Measurement tools of the PyTorch port, run on the card."""
