"""Inference of the PyTorch port: the engine, speculative decoding,
`completion()` and the offline CLI."""

from valley_tpu_torch.inference.engine import (ChatSession, Engine,
                                               GenerationConfig, PrefixCache)
from valley_tpu_torch.inference.speculative import (SpecChatSession,
                                                    SpecConfig, SpecDecoder)

__all__ = ["ChatSession", "Engine", "GenerationConfig", "PrefixCache",
           "SpecChatSession", "SpecConfig", "SpecDecoder"]
