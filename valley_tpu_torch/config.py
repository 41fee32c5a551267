"""Model / run configuration.

The PyTorch port's own copy of ``valley_tpu/config.py`` (numpy only, no
jax), so that the port imports nothing of the JAX package.

A single typed config tree replacing the reference's scattered
`ValleyConfig(LlamaConfig)` + `vision_tower.config` attribute plumbing
(`valley/model/valley_model.py:18-19,59-103`).  Everything a jitted function
needs (shapes, token ids, pooling method) lives here as static python values
so tracing sees them as compile-time constants.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT-L/14 vision tower (openai/clip-vit-large-patch14)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # "quick_gelu" (OpenAI CLIP / ChineseCLIP ViT-L) or "gelu" (some
    # open_clip exports).
    hidden_act: str = "quick_gelu"
    # Index into the hidden-state stack to tap; -2 reproduces
    # `mm_vision_select_layer: -2` (`valley_stage1.yaml:35`).
    select_layer: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # +1 CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class TextConfig:
    """LLaMA / Vicuna decoder."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # linear rope position interpolation (arXiv 2306.15595): divide
    # positions by this factor to address rope_scaling x
    # max_position_embeddings of context within the trained angle range
    # (the SURVEY §5 long-context extension slot; quality at >1 assumes
    # the usual brief PI fine-tune — train with the same value).  The
    # reference is hard-capped at 2048 (`valley_stage1.yaml:49`).
    rope_scaling: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


# Canonical LLaMA size presets.
LLAMA_7B = TextConfig()
LLAMA_13B = TextConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40)
LLAMA2_7B = TextConfig(rms_norm_eps=1e-5, max_position_embeddings=4096)
LLAMA2_13B = TextConfig(hidden_size=5120, intermediate_size=13824,
                        num_hidden_layers=40, num_attention_heads=40,
                        rms_norm_eps=1e-5, max_position_embeddings=4096)
# Tiny config for tests.
LLAMA_TINY = TextConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=512)
VISION_TINY = VisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=4,
                           image_size=28, patch_size=14)


@dataclass(frozen=True)
class SpecialTokens:
    """Token ids of the multimodal markers, assigned at tokenizer-extension
    time (reference stores them on `vision_tower.config`,
    `valley_model.py:363-365,379`)."""

    im_patch: int = -1
    im_start: int = -1
    im_end: int = -1
    vi_frame: int = -1
    vi_start: int = -1
    vi_end: int = -1
    pad: int = 0
    bos: int = 1
    eos: int = 2
    unk: int = 0


@dataclass(frozen=True)
class ValleyConfig:
    text: TextConfig = field(default_factory=lambda: LLAMA2_7B)
    vision: VisionConfig = field(default_factory=VisionConfig)
    tokens: SpecialTokens = field(default_factory=SpecialTokens)
    # "mean" | "max" | "temporal_importance" | "temporal_transformer"
    # (v1/v2/v3 selected via `use_patch_importance_pooling` /
    # `use_delta_transformer`, `train.py:28-29`, `valley_model.py:27-52`).
    patch_pooling_method: str = "mean"
    # Width of the temporal-transformer position table
    # (`valley_model.py:89`: sinusoidal, 2048 x hidden).
    temporal_pos_len: int = 2048
    temporal_transformer_ffn: int = 2048  # torch TransformerEncoderLayer default
    temporal_transformer_heads: int = 8

    def replace(self, **kw) -> "ValleyConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_patches(self) -> int:
        return self.vision.num_patches

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "ValleyConfig":
        raw: dict[str, Any] = json.loads(text)
        return ValleyConfig(
            text=TextConfig(**raw.get("text", {})),
            vision=VisionConfig(**raw.get("vision", {})),
            tokens=SpecialTokens(**raw.get("tokens", {})),
            **{k: v for k, v in raw.items()
               if k not in ("text", "vision", "tokens")},
        )


def valley_7b(**kw) -> ValleyConfig:
    return ValleyConfig(text=LLAMA2_7B, **kw)


def valley_13b(**kw) -> ValleyConfig:
    return ValleyConfig(text=LLAMA_13B, **kw)


def valley_tiny(**kw) -> ValleyConfig:
    """Small random-weight config used by unit tests and CI."""
    tokens = kw.pop("tokens", SpecialTokens(
        im_patch=500, im_start=501, im_end=502,
        vi_frame=503, vi_start=504, vi_end=505))
    return ValleyConfig(text=LLAMA_TINY, vision=VISION_TINY, tokens=tokens, **kw)
