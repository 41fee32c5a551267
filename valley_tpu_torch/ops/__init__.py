"""Attention ops of the PyTorch port: plain versions and CUDA kernels."""
