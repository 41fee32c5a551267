"""valley_tpu_torch: the PyTorch / CUDA port of valley_tpu for one NVIDIA
H100.  The JAX package ``valley_tpu`` stays the reference; this package
imports torch and never jax."""

from valley_tpu.config import (SpecialTokens, ValleyConfig, valley_7b,
                               valley_13b, valley_tiny)

__all__ = ["SpecialTokens", "ValleyConfig", "valley_7b", "valley_13b",
           "valley_tiny"]
