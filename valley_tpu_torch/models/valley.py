"""The Valley multimodal model, the PyTorch counterpart of
``valley_tpu/models/valley.py``: CLIP tower, linear projector, temporal
pooling and the LLaMA decoder, with the vision features spliced into the
token embeddings by a vectorised gather (no per-sample loop)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.constants import IGNORE_INDEX
from valley_tpu_torch.models import Weights, clip_vit, llama, temporal
from valley_tpu_torch.ops.attention import KERNELS, Attention


class Projector(Weights):
    NAMES = ("w", "b")


class ValleyWeights(Weights):
    NAMES = ("llama", "vision", "projector")


class VisionFeatures(NamedTuple):
    pooled: torch.Tensor     # (B, P, H) temporally pooled patch features
    frame_cls: torch.Tensor  # (B, T, H) per-frame CLS features


def init_params(cfg: ValleyConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> ValleyWeights:
    """Random weights with the shapes and scaling of the JAX
    ``valley.init_params``, drawn from ``generator`` on ``device``."""
    temporal.check_method(cfg)
    hv, hl = cfg.vision.hidden_size, cfg.text.hidden_size
    proj_w = torch.randn((hv, hl), generator=generator, dtype=torch.float32,
                         device=device) * hv ** -0.5
    return ValleyWeights({
        "llama": llama.init_params(cfg.text, generator, dtype, device),
        "vision": clip_vit.init_params(cfg.vision, generator, dtype, device),
        "projector": Projector({
            "w": proj_w.to(dtype),
            "b": torch.zeros((hl,), dtype=dtype, device=device)}),
    })


def encode_images(params: ValleyWeights, cfg: ValleyConfig,
                  images: torch.Tensor,
                  frame_mask: Optional[torch.Tensor] = None) -> VisionFeatures:
    """images: (B, T, 3, H, W) frames -> vision features.

    ``uint8`` images are raw pixels, CLIP-normalised here in fp32 and cast
    to bf16 (valley.py:63-69).  ``frame_mask``: optional (B, T) bool.  The
    tower is frozen in every recipe, so it runs under `torch.no_grad` (the
    JAX ``stop_gradient``); the projector keeps its gradient.
    """
    if images.dtype == torch.uint8:
        mean = torch.tensor(clip_vit.CLIP_MEAN, dtype=torch.float32,
                            device=images.device).reshape(1, 1, 3, 1, 1)
        std = torch.tensor(clip_vit.CLIP_STD, dtype=torch.float32,
                           device=images.device).reshape(1, 1, 3, 1, 1)
        images = ((images.to(torch.float32) / 255.0 - mean) / std).to(
            torch.bfloat16)
    b, t = images.shape[:2]
    flat = images.reshape((b * t,) + tuple(images.shape[2:]))
    with torch.no_grad():
        feats = clip_vit.encode(params["vision"], cfg.vision, flat)
    proj = params["projector"]
    feats = feats @ proj["w"] + proj["b"]
    feats = feats.reshape(b, t, feats.shape[1], feats.shape[2])

    patch = feats[:, :, 1:, :]     # (B, T, P, H)
    cls = feats[:, :, 0, :]        # (B, T, H)
    pooled = torch.stack([
        temporal.pool_patches(cfg, patch[i],
                              None if frame_mask is None else frame_mask[i])
        for i in range(b)])
    return VisionFeatures(pooled=pooled, frame_cls=cls)


def splice_embeddings(cfg: ValleyConfig, input_ids: torch.Tensor,
                      embeds: torch.Tensor,
                      feats: VisionFeatures) -> torch.Tensor:
    """Put vision features at their marker tokens: the i-th <im_patch> of a
    row (counted from the row's start, mod P) takes ``pooled[i]``, the j-th
    <vi_frame> (mod T) takes ``frame_cls[j]``, so every media span of a row
    receives the same features."""
    tok = cfg.tokens
    p = feats.pooled.shape[1]
    t = feats.frame_cls.shape[1]
    h = embeds.shape[-1]

    is_patch = input_ids == tok.im_patch
    is_frame = input_ids == tok.vi_frame
    patch_idx = (is_patch.cumsum(dim=1) - 1).clamp_min(0) % p
    frame_idx = (is_frame.cumsum(dim=1) - 1).clamp_min(0) % t

    pooled_g = torch.gather(feats.pooled, 1,
                            patch_idx[..., None].expand(-1, -1, h))
    frame_g = torch.gather(feats.frame_cls, 1,
                           frame_idx[..., None].expand(-1, -1, h))
    out = torch.where(is_patch[..., None], pooled_g.to(embeds.dtype), embeds)
    return torch.where(is_frame[..., None], frame_g.to(embeds.dtype), out)


def build_inputs_embeds(params: ValleyWeights, cfg: ValleyConfig,
                        input_ids: torch.Tensor,
                        images: Optional[torch.Tensor],
                        frame_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    embeds = llama.embed(params["llama"], input_ids)
    if images is not None:
        feats = encode_images(params, cfg, images, frame_mask)
        embeds = splice_embeddings(cfg, input_ids, embeds, feats)
    return embeds


def forward(params: ValleyWeights, cfg: ValleyConfig,
            input_ids: torch.Tensor, images: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            frame_mask: Optional[torch.Tensor] = None,
            attention: Attention = KERNELS, remat=False) -> torch.Tensor:
    """Full cacheless forward to fp32 logits (B, S, V)."""
    embeds = build_inputs_embeds(params, cfg, input_ids, images, frame_mask)
    return llama.forward(params["llama"], cfg.text, embeds, attn_mask,
                         attention=attention, remat=remat)


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean cross entropy over the shifted targets that are not
    ``IGNORE_INDEX``, from an fp32 log-softmax (valley.py:148-160)."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def loss_fn(params: ValleyWeights, cfg: ValleyConfig, batch, remat=True,
            attention: Attention = KERNELS) -> torch.Tensor:
    """Training loss of one batch (valley.py:163-171): ``batch`` holds
    ``input_ids``, ``labels`` and optionally ``attention_mask``, ``images``
    and ``frame_mask`` tensors."""
    logits = forward(params, cfg, batch["input_ids"], batch.get("images"),
                     batch.get("attention_mask"), batch.get("frame_mask"),
                     attention=attention, remat=remat)
    return shifted_cross_entropy(logits, batch["labels"])
