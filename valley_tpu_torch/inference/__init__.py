"""Inference of the PyTorch port: the engine, `completion()` and the
offline CLI."""

from valley_tpu_torch.inference.engine import Engine, GenerationConfig

__all__ = ["Engine", "GenerationConfig"]
