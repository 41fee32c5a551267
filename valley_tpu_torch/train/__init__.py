"""Training of the PyTorch port: `trainer.Trainer` and the
``python -m valley_tpu_torch.train.train`` entry point."""
