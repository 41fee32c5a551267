"""CLIP ViT-L/14 vision tower, the PyTorch counterpart of
``valley_tpu/models/clip_vit.py``: the stride-14 patch conv as reshape plus
one matmul, stacked layer weights stored (L, in, out), LayerNorm and
quickGELU in fp32, and the early exit at the tapped layer (the -2 tap runs
23 of 24 layers; the last layer and the post-LayerNorm never run).

Attention is the plain `mha_attention`, as in the JAX tower
(``use_flash=False``).  The encoder's GEMMs may be int8
(``ops/quant.quantize_vision_params``, worker ``--quantize-vision``): each
(in, out) int8 weight with its (1, out) scale a layer, weight-only
(``_scale``) or W8A8 (``_scale_a8``), in `_dot`.

On a tree cut over a ``model`` axis (`parallel.sharding.shard_params`)
the tower carries its `TowerParallel` as ``params.tp`` and each rank runs
its heads and MLP columns, Megatron-style (`_encoder_layer`), as JAX's
rules cut it (``valley_tpu/parallel/sharding.py:78-106``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from valley_tpu_torch.config import VisionConfig
from valley_tpu_torch.models import Weights
from valley_tpu_torch.ops.attention import mha_attention
from valley_tpu_torch.ops.quant import (RECIP_127, dequant_matmul,
                                        int8_matvec_plain)
from valley_tpu_torch.parallel.tensor import (Group, TowerParallel,
                                              tensor_parallel)

# CLIP preprocessing statistics (the JAX tower's CLIP_MEAN / CLIP_STD).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipLayers(Weights):
    """The stacked encoder layers; each int8 GEMM weight (L, in, out) is
    followed by its (L, 1, out) bf16 ``<name>_scale`` or, for W8A8,
    ``<name>_scale_a8``."""
    NAMES = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv",
             "wo", "bo", "ln2_scale", "ln2_bias", "fc1", "fc1_bias", "fc2",
             "fc2_bias")

    @classmethod
    def expected_names(cls, tensors) -> tuple:
        out = []
        for n in cls.NAMES:
            out.append(n)
            t = tensors.get(n)
            if t is not None and t.dtype == torch.int8:
                out.append(n + ("_scale_a8" if n + "_scale_a8" in tensors
                                else "_scale"))
        return tuple(out)


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


# torch._int_mm on the card takes more than this many rows
_INT_MM_MIN_ROWS = 17


def _dot(lp: ClipLayers, li: int, name: str, x: torch.Tensor,
         reduce: Optional[Group] = None) -> torch.Tensor:
    """``x @ w`` for layer ``li``'s (in, out) weight ``name``
    (clip_vit.py:102-134), in x's dtype.

    An int8 weight with ``<name>_scale`` dequantizes into an fp32 product
    (`quant.dequant_matmul`, as `llama._linear` takes an int8 weight); with
    ``<name>_scale_a8`` (W8A8) each token quantizes to int8 by its absmax
    (clamped at 1e-6) times fl32(1/127), as XLA compiles JAX's ``/ 127.0``
    under jit where the engine serves the tower, the int8 product
    accumulates exactly in int32 and rescales by the token's and the output
    channel's scales in fp32.
    The tower runs only prefill-shaped products (1 + P tokens a frame), so
    W8A8 has no sequence gate.  The JAX package leaves this product to XLA
    and it has no groups, so the port leaves it to the library's int8
    product, ``torch._int_mm``, as `llama._w8a8_dot` does: its second
    operand column-major, and on the card more than 16 rows (a smaller
    block is padded with zero rows).

    ``reduce``: the product is row-parallel over that group (x the rank's
    inputs, w its rows of the weight) and its partial sums are summed over
    the group before the cast: a float product's in x's dtype, a
    weight-only one's in fp32 (each rank's rows dequantized by the whole
    per-channel scale), W8A8's exactly in int32 before the rescale, each
    token quantized by its absmax over the group (`llama._global_amax`),
    so that its int8 activations and its result are one device's."""
    w = lp[name][li]
    if w.dtype != torch.int8:
        y = x @ w
        return y if reduce is None else reduce.sum(y)
    a8 = lp.get(name + "_scale_a8")
    if a8 is None:
        if reduce is None:
            return dequant_matmul(x, w, lp[name + "_scale"][li])
        y = int8_matvec_plain(x, w.t(), lp[name + "_scale"][li].reshape(-1))
        return reduce.sum(y).to(x.dtype)
    k, o = w.shape
    xf = x.reshape(-1, k).to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce is not None:
        amax = reduce.all_reduce_max(amax)
    ascale = amax.clamp_min(1e-6) * RECIP_127
    xq = torch.round(xf / ascale).to(torch.int8)
    rows = xq.shape[0]
    if xq.is_cuda and rows < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - rows, k))])
    y = torch._int_mm(xq, w.t().contiguous().t())[:rows]
    if reduce is not None:
        y = reduce.all_reduce(y)
    out = y.to(torch.float32) * ascale * a8[li].to(torch.float32)
    return out.reshape(x.shape[:-1] + (o,)).to(x.dtype)


def _encoder_layer(lp: ClipLayers, li: int, x: torch.Tensor,
                   cfg: VisionConfig,
                   tp: Optional[TowerParallel] = None) -> torch.Tensor:
    """One encoder layer; on a tensor-parallel rank (``tp``) over its
    heads and MLP columns: q/k/v and fc1 column-parallel (their input
    through `Group.enter`), o and fc2 row-parallel (their partial sums
    summed over the group, ``bo`` and ``fc2_bias`` added once after)."""
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    if tp is not None:
        nh = tp.heads

    residual = x
    x = layer_norm(x, lp["ln1_scale"][li], lp["ln1_bias"][li],
                   cfg.layer_norm_eps)
    if tp is not None:
        x = tp.enter(x)
    q = (_dot(lp, li, "wq", x) + lp["bq"][li]).reshape(b, s, nh, d)
    k = (_dot(lp, li, "wk", x) + lp["bk"][li]).reshape(b, s, nh, d)
    v = (_dot(lp, li, "wv", x) + lp["bv"][li]).reshape(b, s, nh, d)
    attn = mha_attention(q, k, v, causal=False)
    x = residual + (_dot(lp, li, "wo", attn.reshape(b, s, nh * d), tp)
                    + lp["bo"][li])

    residual = x
    x = layer_norm(x, lp["ln2_scale"][li], lp["ln2_bias"][li],
                   cfg.layer_norm_eps)
    if tp is not None:
        x = tp.enter(x)
    x = _activation(_dot(lp, li, "fc1", x) + lp["fc1_bias"][li],
                    cfg.hidden_act)
    return residual + (_dot(lp, li, "fc2", x, tp) + lp["fc2_bias"][li])


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
    tp = tensor_parallel(params)
    for li in range(num_layers):
        x = _encoder_layer(params["layers"], li, x, cfg, tp)
    return x
