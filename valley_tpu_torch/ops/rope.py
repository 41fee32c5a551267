"""Rotary position embeddings (LLaMA half-split layout), the counterpart of
``valley_tpu/ops/rope.py``: fp32 cos/sin tables with the frequency vector
tiled twice, ``x * cos + rotate_half(x) * sin`` in fp32, linear position
interpolation for ``scaling`` > 1."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, scaling: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``positions.shape + (head_dim,)``, fp32, on
    the device of ``positions``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    pos = positions.to(torch.float32)
    if scaling != 1.0:
        pos = pos / scaling
    angles = pos[..., None] * inv_freq                    # (..., d/2)
    angles = torch.cat([angles, angles], dim=-1)          # (..., d)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D), broadcast over heads.
    Computed in fp32, returned in x's dtype."""
    xf = x.to(torch.float32)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
