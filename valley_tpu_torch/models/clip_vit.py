"""CLIP ViT-L/14 vision tower, the PyTorch counterpart of
``valley_tpu/models/clip_vit.py``: the stride-14 patch conv as reshape plus
one matmul, stacked layer weights stored (L, in, out), LayerNorm and
quickGELU in fp32, and the early exit at the tapped layer (the -2 tap runs
23 of 24 layers; the last layer and the post-LayerNorm never run).

Attention is the plain `mha_attention`, as in the JAX tower
(``use_flash=False``).  int8 tower weights are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from valley_tpu_torch.config import VisionConfig
from valley_tpu_torch.models import Weights
from valley_tpu_torch.ops.attention import mha_attention

# CLIP preprocessing statistics (the JAX tower's CLIP_MEAN / CLIP_STD).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipLayers(Weights):
    NAMES = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv",
             "wo", "bo", "ln2_scale", "ln2_bias", "fc1", "fc1_bias", "fc2",
             "fc2_bias")


class ClipWeights(Weights):
    NAMES = ("class_embedding", "patch_embedding", "position_embedding",
             "pre_ln_scale", "pre_ln_bias", "layers")


def init_params(cfg: VisionConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> ClipWeights:
    """Random weights with the shapes and scaling of the JAX
    ``clip_vit.init_params``."""
    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    h, f = cfg.hidden_size, cfg.intermediate_size
    n = cfg.num_hidden_layers
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    layers = ClipLayers({
        "ln1_scale": ones(n, h), "ln1_bias": zeros(n, h),
        "wq": dense(h, (n, h, h)), "bq": zeros(n, h),
        "wk": dense(h, (n, h, h)), "bk": zeros(n, h),
        "wv": dense(h, (n, h, h)), "bv": zeros(n, h),
        "wo": dense(h, (n, h, h)), "bo": zeros(n, h),
        "ln2_scale": ones(n, h), "ln2_bias": zeros(n, h),
        "fc1": dense(h, (n, h, f)), "fc1_bias": zeros(n, f),
        "fc2": dense(f, (n, f, h)), "fc2_bias": zeros(n, h),
    })
    return ClipWeights({
        "class_embedding": dense(h, (h,)),
        "patch_embedding": dense(patch_dim, (patch_dim, h)),
        "position_embedding": dense(h, (cfg.num_positions, h)),
        "pre_ln_scale": ones(h),
        "pre_ln_bias": zeros(h),
        "layers": layers,
    })


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * scale + bias


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def _activation(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return quick_gelu(x)
    if name == "gelu":
        return F.gelu(x.to(torch.float32)).to(x.dtype)
    raise ValueError(f"unsupported vision activation {name!r}")


def _patchify(pixel_values: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """(B, 3, H, W) -> (B, num_patches, 3*p*p) in conv-weight order
    (in_ch, kh, kw) over a row-major patch grid."""
    b, c, hh, ww = pixel_values.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = pixel_values.reshape(b, c, gh, p, gw, p)
    x = x.permute(0, 2, 4, 1, 3, 5)             # (B, gh, gw, C, p, p)
    return x.reshape(b, gh * gw, c * p * p)


def _encoder_layer(lp: ClipLayers, li: int, x: torch.Tensor,
                   cfg: VisionConfig) -> torch.Tensor:
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim

    residual = x
    x = layer_norm(x, lp["ln1_scale"][li], lp["ln1_bias"][li],
                   cfg.layer_norm_eps)
    q = (x @ lp["wq"][li] + lp["bq"][li]).reshape(b, s, nh, d)
    k = (x @ lp["wk"][li] + lp["bk"][li]).reshape(b, s, nh, d)
    v = (x @ lp["wv"][li] + lp["bv"][li]).reshape(b, s, nh, d)
    attn = mha_attention(q, k, v, causal=False)
    x = residual + (attn.reshape(b, s, h) @ lp["wo"][li] + lp["bo"][li])

    residual = x
    x = layer_norm(x, lp["ln2_scale"][li], lp["ln2_bias"][li],
                   cfg.layer_norm_eps)
    x = _activation(x @ lp["fc1"][li] + lp["fc1_bias"][li], cfg.hidden_act)
    return residual + (x @ lp["fc2"][li] + lp["fc2_bias"][li])


def encode(params: ClipWeights, cfg: VisionConfig,
           pixel_values: torch.Tensor,
           select_layer: Optional[int] = None) -> torch.Tensor:
    """(B, 3, H, W) CLIP-normalised pixels -> (B, 1+P, hidden): the CLS
    token then the patch grid, the hidden state at ``select_layer``."""
    if select_layer is None:
        select_layer = cfg.select_layer
    # hidden_states[i] is the output of layer i-1, so a tap of -n leaves
    # the last n-1 layers unused
    if select_layer < 0:
        num_layers = cfg.num_hidden_layers + select_layer + 1
    else:
        num_layers = select_layer
    num_layers = max(0, min(num_layers, cfg.num_hidden_layers))

    w_patch = params["patch_embedding"]
    x = _patchify(pixel_values, cfg).to(w_patch.dtype) @ w_patch  # (B, P, H)
    cls = params["class_embedding"].to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1)                                # (B, 1+P, H)
    x = x + params["position_embedding"][None]
    x = layer_norm(x, params["pre_ln_scale"], params["pre_ln_bias"],
                   cfg.layer_norm_eps)
    for li in range(num_layers):
        x = _encoder_layer(params["layers"], li, x, cfg)
    return x
