"""Temporal pooling of per-frame patch features, the PyTorch counterpart of
``valley_tpu/models/temporal.py``: a (T, P, H) block of per-frame patch
features becomes (P, H) by one of Valley's three variants.

* v1 ``mean`` (the Valley-7B default) and ``max``: reduce over the frames;
* v2 ``temporal_importance``: a Linear(P*H -> 1) score per frame, a softmax
  over the frames, the weighted sum;
* v3 ``temporal_transformer``: a one-layer post-norm encoder over the time
  axis of each patch (torch ``nn.TransformerEncoderLayer``'s defaults: ffn
  2048, ReLU, eps 1e-5) with the sinusoidal position table, the last valid
  step's output plus the temporal mean.

Each takes an optional (T,) frame mask, the padding at the end.  The
learned variants compute in fp32 whatever the weights' dtype (they are cast
up inside), as the JAX package does; their products are plain torch, since
the JAX package leaves them to XLA, and fp32 products on the card stay fp32
while ``torch.backends.cuda.matmul.allow_tf32`` keeps its default (False).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.models import Weights

IMPORTANCE_NAMES = ("pooling_w", "pooling_b")
TRANSFORMER_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                     "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                     "ffn1", "ffn1_bias", "ffn2", "ffn2_bias",
                     "position_matrix")


class TemporalWeights(Weights):
    """The pooling's parameters: none for mean and max; ``pooling_w`` (P*H,
    1) and ``pooling_b`` (1,) for importance pooling; the encoder layer's
    (in, out) projections, biases, norms and its (pos_len, H)
    ``position_matrix`` for the transformer (temporal.py:42-73)."""

    @classmethod
    def expected_names(cls, tensors) -> tuple:
        if not tensors:
            return ()
        return IMPORTANCE_NAMES if "pooling_w" in tensors \
            else TRANSFORMER_NAMES


def sinusoidal_position_matrix(seq_len: int, d: int,
                               n: float = 10000.0) -> torch.Tensor:
    """P[k, 2i] = sin(k / n^(2i/d)), P[k, 2i+1] = cos(k / n^(2i/d)) in fp32
    (temporal.py:28-39)."""
    k = torch.arange(seq_len, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32)[None, :]
    angles = k / n ** (2 * i / d)
    out = torch.zeros((seq_len, d), dtype=torch.float32)
    out[:, 0::2] = torch.sin(angles)
    out[:, 1::2] = torch.cos(angles)
    return out


def init_params(cfg: ValleyConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> TemporalWeights:
    """Random parameters of the configured method with the shapes and
    scaling of the JAX ``temporal.init_params`` (normal * fan_in^-1/2,
    biases zero, norms one), drawn from ``generator`` on ``device``; empty
    for mean and max."""
    h = cfg.text.hidden_size
    method = cfg.patch_pooling_method
    if method in ("mean", "max"):
        return TemporalWeights({})

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    if method == "temporal_importance":
        ph = cfg.num_patches * h
        return TemporalWeights({"pooling_w": dense(ph, (ph, 1)),
                                "pooling_b": zeros(1)})
    if method == "temporal_transformer":
        f = cfg.temporal_transformer_ffn
        return TemporalWeights({
            "wq": dense(h, (h, h)), "bq": zeros(h),
            "wk": dense(h, (h, h)), "bk": zeros(h),
            "wv": dense(h, (h, h)), "bv": zeros(h),
            "wo": dense(h, (h, h)), "bo": zeros(h),
            "ln1_scale": ones(h), "ln1_bias": zeros(h),
            "ln2_scale": ones(h), "ln2_bias": zeros(h),
            "ffn1": dense(h, (h, f)), "ffn1_bias": zeros(f),
            "ffn2": dense(f, (f, h)), "ffn2_bias": zeros(h),
            # the frozen sinusoidal table, kept so checkpoints round-trip
            "position_matrix": sinusoidal_position_matrix(
                cfg.temporal_pos_len, h).to(device=device, dtype=dtype),
        })
    raise ValueError(f"unknown pooling method {method!r}")


def _post_norm_ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def _encoder_layer_post_norm(tp: Mapping, x: torch.Tensor, num_heads: int,
                             key_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """torch ``nn.TransformerEncoderLayer`` with ``norm_first=False`` in
    eval mode (temporal.py:83-110).  x: (B, T, H) fp32; ``key_mask``: an
    optional (T,) bool, the padded steps excluded as keys."""
    f32 = {n: tp[n].to(torch.float32) for n in TRANSFORMER_NAMES
           if n != "position_matrix"}
    b, t, h = x.shape
    d = h // num_heads

    def heads(y):
        return y.reshape(b, t, num_heads, d).transpose(1, 2)

    q = heads(x @ f32["wq"] + f32["bq"])
    k = heads(x @ f32["wk"] + f32["bk"])
    v = heads(x @ f32["wv"] + f32["bv"])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    if key_mask is not None:
        logits = torch.where(key_mask[None, None, None, :], logits,
                             torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, t, h) @ f32["wo"] + f32["bo"]
    x = _post_norm_ln(x + attn, f32["ln1_scale"], f32["ln1_bias"])
    ff = torch.relu(x @ f32["ffn1"] + f32["ffn1_bias"])
    ff = ff @ f32["ffn2"] + f32["ffn2_bias"]
    return _post_norm_ln(x + ff, f32["ln2_scale"], f32["ln2_bias"])


def pool_patches(tparams: Mapping, cfg: ValleyConfig,
                 patch_features: torch.Tensor,
                 frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, P, H) per-frame patch features -> (P, H) in their dtype
    (temporal.py:113-168), ``tparams`` the method's parameters
    (`TemporalWeights`; mean and max read none).

    ``frame_mask``: optional (T,) bool of valid frames, the padding at the
    end (the transformer reads the last valid step).  The mean accumulates
    in fp32 whatever the input dtype, as ``jnp.mean`` does for bf16.
    """
    method = cfg.patch_pooling_method
    x = patch_features
    t = x.shape[0]
    m = None if frame_mask is None else frame_mask.to(torch.float32)
    if method == "mean":
        if m is None:
            return x.to(torch.float32).mean(dim=0).to(x.dtype)
        total = (x.to(torch.float32) * m[:, None, None]).sum(dim=0)
        return (total / m.sum().clamp_min(1.0)).to(x.dtype)
    if method == "max":
        if frame_mask is None:
            return x.amax(dim=0)
        neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
        return torch.where(frame_mask[:, None, None], x, neg).amax(dim=0)
    if method == "temporal_importance":
        flat = x.reshape(t, -1).to(torch.float32)
        score = flat @ tparams["pooling_w"].to(torch.float32) \
            + tparams["pooling_b"].to(torch.float32)          # (T, 1)
        if m is not None:
            score = torch.where(m[:, None] > 0, score,
                                torch.tensor(-1e30, device=x.device))
        score = torch.softmax(score, dim=0)[:, :, None]       # (T, 1, 1)
        return (score * x.to(torch.float32)).sum(dim=0).to(x.dtype)
    if method == "temporal_transformer":
        xt = x.transpose(0, 1).to(torch.float32)              # (P, T, H)
        pos = tparams["position_matrix"][:t].to(torch.float32)[None]
        enc = _encoder_layer_post_norm(tparams, xt + pos,
                                       cfg.temporal_transformer_heads,
                                       key_mask=frame_mask)
        if m is None:
            delta = enc[:, -1, :]
            mean = xt.mean(dim=1)
        else:
            last = (m.sum().to(torch.int64) - 1).clamp_min(0)
            delta = enc.index_select(1, last.reshape(1))[:, 0, :]
            mean = (xt * m[None, :, None]).sum(dim=1) / m.sum().clamp_min(1.0)
        return (delta + mean).to(x.dtype)
    raise ValueError(f"unknown pooling method {method!r}")
