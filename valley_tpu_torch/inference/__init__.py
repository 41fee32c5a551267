"""Inference of the PyTorch port: the engine, `completion()` and the
offline CLI."""

from valley_tpu_torch.inference.engine import (ChatSession, Engine,
                                               GenerationConfig, PrefixCache)

__all__ = ["ChatSession", "Engine", "GenerationConfig", "PrefixCache"]
