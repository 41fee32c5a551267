"""Temporal pooling of per-frame patch features, the PyTorch counterpart of
``valley_tpu/models/temporal.py`` for the parameter-free methods: ``mean``
(the Valley-7B default) and ``max``, each with an optional frame mask.
The ``temporal_importance`` and ``temporal_transformer`` methods are not
ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from valley_tpu_torch.config import ValleyConfig

PORTED_METHODS = ("mean", "max")


def check_method(cfg: ValleyConfig) -> None:
    if cfg.patch_pooling_method not in PORTED_METHODS:
        raise NotImplementedError(
            f"pooling method {cfg.patch_pooling_method!r} is not ported "
            f"yet (ported: {PORTED_METHODS})")


def pool_patches(cfg: ValleyConfig, patch_features: torch.Tensor,
                 frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, P, H) per-frame patch features -> (P, H).

    ``frame_mask``: optional (T,) bool of valid frames (padding at the end).
    The mean accumulates in fp32 whatever the input dtype, as ``jnp.mean``
    does for bf16.
    """
    check_method(cfg)
    x = patch_features
    if cfg.patch_pooling_method == "mean":
        if frame_mask is None:
            return x.to(torch.float32).mean(dim=0).to(x.dtype)
        m = frame_mask.to(torch.float32)
        total = (x.to(torch.float32) * m[:, None, None]).sum(dim=0)
        return (total / m.sum().clamp_min(1.0)).to(x.dtype)
    if frame_mask is None:
        return x.amax(dim=0)
    neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    return torch.where(frame_mask[:, None, None], x, neg).amax(dim=0)
