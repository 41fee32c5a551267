"""valley_tpu_torch: the PyTorch / CUDA port of valley_tpu for one NVIDIA
H100.  The JAX package ``valley_tpu`` stays the reference; this package
imports torch and never jax, and nothing of the JAX package: the host
code it shares with it (config, constants, tokenizer, conversation, data
pipeline) is its own copy."""

from valley_tpu_torch.config import (SpecialTokens, ValleyConfig,
                                     valley_7b, valley_13b, valley_tiny)

__all__ = ["SpecialTokens", "ValleyConfig", "valley_7b", "valley_13b",
           "valley_tiny"]
