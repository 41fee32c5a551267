"""LLaMA decoder (LLaMA-1/2, Vicuna), the PyTorch counterpart of
``valley_tpu/models/llama.py``.

Weights keep the JAX package's stacked layout: every per-layer tensor has a
leading layer axis, projections are stored (L, out, in) and a bf16
``lm_head`` (in, out), so converting a JAX tree is a dtype and device copy
(a quantized ``lm_head`` is stored (out, in): see ``ops/quant.py``).  The KV
cache is the same stacked (L, B, Smax, Hkv, D) buffer, bf16/fp32 or int8
with (L, B, Smax, Hkv) bf16 scales; this port writes it in place.  RMSNorm,
rotary and softmax run in fp32 exactly where the JAX package runs them.

Ported: the cacheless forward (training, with full per-layer
rematerialisation as an option), bucketed prefill at ``cache_index`` 0 and
single-token decode over the stacked cache, for any number of rows B, with
one slot for every row or a slot per row (continuous batching: rows that
joined at different times write at their own slots); the fused serving
layout (``wqkv``, ``w_gateup``), the decode GEMVs of up to ``MAX_ROWS``
rows (bf16 projections and ``lm_head`` through K6, per-channel int8
through K4, nibble-packed int4 with group or channel scales through K5),
W8A8 prefill for ``*_scale_a8`` trees and the int8 KV cache.  Not ported
yet, and refused with NotImplementedError: the ``"dots"`` remat policy,
the ``cross_valid`` extend branch (sessions, speculation), grouped W4A8, a
half-fused layout and LoRA.  The JAX package's split of batched decode
into a carried and a sliced cache (llama.py:538-548) works around a TPU
layout choice and has no counterpart: one cached form serves every B.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from valley_tpu_torch.config import TextConfig
from valley_tpu_torch.models import Weights
from valley_tpu_torch.ops.attention import KERNELS, Attention, \
    prefill_attention
from valley_tpu_torch.ops.quant import (MAX_ROWS, int4_dequantize,
                                        int8_matvec_plain)
from valley_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Slots = Union[int, torch.Tensor]   # one cache slot, or one per row (B,)

QUANTIZED = (torch.int8, torch.uint8)   # int8, and nibble-packed int4
# Each layout's projections, in the order its parameters are registered
ATTN_PROJ = {False: ("wq", "wk", "wv", "wo"), True: ("wqkv", "wo")}
MLP_PROJ = {False: ("w_gate", "w_up", "w_down"), True: ("w_gateup", "w_down")}


def _with_scale(tensors, names) -> list:
    """``names``, each quantized one (int8 or packed int4) followed by its
    scale's name (``<name>_scale_a8`` where the tensors hold it, else
    ``<name>_scale``)."""
    out = []
    for n in names:
        out.append(n)
        t = tensors.get(n)
        if t is not None and t.dtype in QUANTIZED:
            out.append(n + ("_scale_a8" if n + "_scale_a8" in tensors
                            else "_scale"))
    return out


class LlamaLayers(Weights):
    """The stacked decoder layers: the unfused projections or the fused
    serving layout (``wqkv``, ``w_gateup``), each int8 projection with its
    (L, out) bf16 scale, each packed int4 one ((L, out, in/2) uint8) with
    its (L, out) or grouped (L, out, in/group) bf16 scale."""
    NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
             "w_up", "w_down")

    @classmethod
    def expected_names(cls, tensors) -> tuple:
        fused = [n for n in ("wqkv", "w_gateup") if n in tensors]
        if len(fused) == 1:
            raise NotImplementedError(
                f"a half-fused layout ({fused[0]} beside unfused "
                "projections) is not ported: fuse both with "
                "fuse_llama_params")
        f = bool(fused)
        return tuple(["attn_norm", *_with_scale(tensors, ATTN_PROJ[f]),
                      "mlp_norm", *_with_scale(tensors, MLP_PROJ[f])])


class LlamaWeights(Weights):
    """Embedding, layers, final norm and ``lm_head`` (int8 or packed int4:
    with its (1, vocab) bf16 ``lm_head_scale``)."""
    NAMES = ("embed", "layers", "final_norm", "lm_head")

    @classmethod
    def expected_names(cls, tensors) -> tuple:
        head = tensors.get("lm_head")
        if head is not None and head.dtype in QUANTIZED:
            return cls.NAMES + ("lm_head_scale",)
        return cls.NAMES


@dataclass
class KVCache:
    """Stacked KV cache, updated in place by `forward_hidden`.  An int8
    cache (serving quantization) holds per-(layer, row, slot, head) absmax
    scales; they are None for float caches."""
    k: torch.Tensor                          # (L, B, Smax, Hkv, D)
    v: torch.Tensor                          # (L, B, Smax, Hkv, D)
    k_scale: Optional[torch.Tensor] = None   # (L, B, Smax, Hkv) bf16
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: TextConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads,
             cfg.head_dim)
    cache = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
    if dtype == torch.int8:
        # two distinct scale buffers, one for K and one for V
        cache.k_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                    device=device)
        cache.v_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                    device=device)
    return cache


def init_params(cfg: TextConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> LlamaWeights:
    """Random weights with the shapes and scaling of the JAX
    ``llama.init_params`` (normal * fan_in^-1/2, norms at one), drawn from
    ``generator`` on ``device``."""
    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    h, f = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.kv_heads * cfg.head_dim
    n = cfg.num_hidden_layers
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    layers = LlamaLayers({
        "attn_norm": ones(n, h),
        "wq": dense(h, (n, h, h)),
        "wk": dense(h, (n, kv, h)),
        "wv": dense(h, (n, kv, h)),
        "wo": dense(h, (n, h, h)),
        "mlp_norm": ones(n, h),
        "w_gate": dense(h, (n, f, h)),
        "w_up": dense(h, (n, f, h)),
        "w_down": dense(f, (n, h, f)),
    })
    return LlamaWeights({
        "embed": dense(h, (cfg.vocab_size, h)),
        "layers": layers,
        "final_norm": ones(h),
        "lm_head": dense(h, (h, cfg.vocab_size)),
    })


def fuse_llama_params(params):
    """Concatenate wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup along the
    out axis of the (L, out, in) storage (llama.py:111-151): decode then
    runs 4 GEMVs per layer instead of 7, with the same output rows.

    Do this before quantizing (per-out-channel scales survive the concat
    unchanged).  The concat runs where the weights lie, each original
    dropped once its fused stack is made.  Returns ``params`` (a
    `ValleyWeights`) with its layers replaced; a fused tree is returned as
    it is.
    """
    layers = params["llama"]["layers"]
    if "wqkv" in layers:
        return params
    if any(layers[n].dtype in QUANTIZED for n in ("wq", "w_gate")):
        raise ValueError("fuse before quantizing")
    lt = {n: p.data for n, p in layers.named_parameters(recurse=False)}
    for names, out in ((("wq", "wk", "wv"), "wqkv"),
                       (("w_gate", "w_up"), "w_gateup")):
        lt[out] = torch.cat([lt.pop(n) for n in names], dim=1)
        for n in names:
            delattr(layers, n)
    params.llama.layers = LlamaLayers(lt)
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """fp32 statistics; the normed value is cast back to x's dtype before
    the weight multiplies it (llama.py:158-162)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight


def embed(params: LlamaWeights, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


# W8A8 (``*_scale_a8`` trees) applies only to chunks whose sequence axis is
# at least this long (llama.py:169-179): prefill buckets are >= 128, decode
# steps take the dequant GEMV, so decode matches plain int8 given the same
# cache.
_A8_MIN_SEQ = 128


def _w8a8_dot(x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """quant(x) @ int8 w^T -> int32, fp32 rescale (llama.py:182-207).

    Activations quantize per token (row absmax / 127, clamped at 1e-6),
    the int8 x int8 product accumulates exactly in int32, and the result
    rescales by (token scale x out-channel weight scale) in fp32 before the
    cast to x's dtype.  ``w`` is (out, in).  The JAX package leaves this
    product to XLA, outside any Pallas kernel, so the port leaves it to
    the library's int8 matrix product (``torch._int_mm``), as it leaves
    plain large matmuls to torch."""
    k = x.shape[-1]
    o = w.shape[-2]
    xf = x.reshape(-1, k).to(torch.float32)
    ascale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    xq = torch.round(xf / ascale).to(torch.int8)
    y = torch._int_mm(xq, w.t())
    out = y.to(torch.float32) * ascale * scale[None, :].to(torch.float32)
    return out.reshape(x.shape[:-1] + (o,)).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
            attention: Attention, kf: bool = False) -> torch.Tensor:
    """x @ W^T for an (out, in) weight ``w`` (``kf``: x @ W for the
    (in, out) float ``lm_head``), with its scale where w is quantized: the
    one router of the decoder's products, by w's storage and the rows (the
    product of x's leading dims).

    Up to `MAX_ROWS` rows of a bf16, int8 or packed int4 weight go through
    the GEMV ``attention.matvec`` (K6, K4 or K5 by w's dtype), fp32 out; a
    bf16 product whose operands track a gradient does not, since K6 has no
    backward.  Every other product is one the JAX package leaves to XLA, so
    the port leaves it to the library: a float weight takes ``F.linear``
    (``x @ w``) in x's dtype; int8 `int8_matvec_plain` (fp32 out); int4
    dequantizes the layer's matrix and takes ``F.linear`` in x's dtype (the
    grouped einsum, llama.py:311-317), rounding the dequantized weight to
    x's dtype where JAX keeps fp32 per-group partial sums.  fp32 weights
    (the CPU's trees) take the library product at every row count."""
    rows = x.numel() // x.shape[-1]
    tracks_grad = torch.is_grad_enabled() and (x.requires_grad
                                               or w.requires_grad)
    if rows <= MAX_ROWS and (w.dtype in QUANTIZED or (
            w.dtype == torch.bfloat16 and not tracks_grad)):
        y = attention.matvec(x.reshape(rows, x.shape[-1]), w, scale, kf)
        return y.reshape(x.shape[:-1] + (y.shape[-1],))
    if w.dtype == torch.uint8:
        return F.linear(x, int4_dequantize(w, scale, x.dtype))
    if w.dtype == torch.int8:
        return int8_matvec_plain(x, w, scale)
    return x @ w if kf else F.linear(x, w)


def _proj(lp: LlamaLayers, li: int, name: str, x: torch.Tensor,
          attention: Attention) -> torch.Tensor:
    """x @ W^T for layer ``li``'s (out, in) projection ``name``
    (llama.py:246-335) through `_linear`, except an int8 weight with a
    ``_scale_a8`` scale and a sequence axis of at least `_A8_MIN_SEQ`,
    which takes `_w8a8_dot`.  The result takes x's dtype."""
    w = lp[name][li]
    scale = None
    if w.dtype in QUANTIZED:
        a8 = lp.get(name + "_scale_a8")
        scale = (lp[name + "_scale"] if a8 is None else a8)[li]
        if a8 is not None and x.dim() >= 2 and x.shape[-2] >= _A8_MIN_SEQ:
            return _w8a8_dot(x, w, scale)
    return _linear(x, w, scale, attention).to(x.dtype)


def _qkv(lp: LlamaLayers, li: int, x: torch.Tensor, cfg: TextConfig, cos,
         sin, attention: Attention):
    b, s, _ = x.shape
    if "wqkv" in lp:
        # fused serving layout: one product, then the q/k/v column slices
        # (v made contiguous: the kernels take contiguous tensors)
        h_sz = cfg.num_attention_heads * cfg.head_dim
        kv_sz = cfg.kv_heads * cfg.head_dim
        qkv = _proj(lp, li, "wqkv", x, attention)
        q = qkv[..., :h_sz]
        k = qkv[..., h_sz:h_sz + kv_sz]
        v = qkv[..., h_sz + kv_sz:].contiguous()
    else:
        q = _proj(lp, li, "wq", x, attention)
        k = _proj(lp, li, "wk", x, attention)
        v = _proj(lp, li, "wv", x, attention)
    q = q.reshape(b, s, cfg.num_attention_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(lp: LlamaLayers, li: int, x: torch.Tensor,
         attention: Attention) -> torch.Tensor:
    if "w_gateup" in lp:
        gu = _proj(lp, li, "w_gateup", x, attention)
        f = gu.shape[-1] // 2
        gate = F.silu(gu[..., :f].to(torch.float32))
        up = gu[..., f:].to(torch.float32)
    else:
        gate = F.silu(_proj(lp, li, "w_gate", x, attention).to(torch.float32))
        up = _proj(lp, li, "w_up", x, attention).to(torch.float32)
    return _proj(lp, li, "w_down", (gate * up).to(x.dtype), attention)


def _attn(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention):
    """Cacheless causal self-attention over the block."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin, attention)
    mask = None if attn_mask is None else attn_mask > 0
    out = prefill_attention(q, k, v, mask, causal=True, attention=attention)
    return _proj(lp, li, "wo", out.reshape(b, s, h), attention)


def _layer(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention):
    """One cacheless decoder layer (llama.py:526-535)."""
    eps = cfg.rms_norm_eps
    x = x + _attn(lp, li, rms_norm(x, lp["attn_norm"][li], eps), cfg, cos,
                  sin, attn_mask, attention)
    return x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps), attention)


def _use_remat(remat) -> bool:
    """The ``remat`` knob of llama.py:640-657: True/"full" recomputes each
    layer in the backward, False/None keeps its activations."""
    if remat in (True, "full"):
        return True
    if remat in (False, None):
        return False
    if remat == "dots":
        raise NotImplementedError(
            'the "dots" remat policy (save matmul outputs, recompute the '
            'elementwise glue) is not ported yet: use True/"full" or False')
    raise ValueError(f"unknown remat policy {remat!r} "
                     "(use True/'full', 'dots', or False)")


def _quantize_kv(x: torch.Tensor):
    """(B, S, H, D) -> int8 values and per-(row, slot, head) absmax scales
    (llama.py:387-392): fp32 scale max(amax, 1e-6) / 127, values
    round(x / scale) with that fp32 scale, the scale stored bf16."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _attn_cached(lp, li, x, cfg, cos, sin, cache: KVCache, cache_index: Slots,
                 kv_valid, attention: Attention):
    """Write this chunk's K/V (an int8 cache: quantized, with their scales)
    into layer ``li`` of the cache at slot ``cache_index``, or at each
    row's own slot for a (B,) ``cache_index``, then attend: one token
    against the whole cache, or a prefill chunk causally within itself on
    its unquantized K/V (the cache beyond the chunk is empty: the engine
    prefills at slot 0)."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin, attention)
    if isinstance(cache_index, torch.Tensor):
        # per-row slots.  jax.lax.dynamic_update_slice clamps a start into
        # [0, Smax - S] (JAX _cache_write, llama.py:395-405), and the pool
        # relies on it: it parks idle rows at slot Smax - 1 and still
        # advances them every step, so their writes land in the last slot
        start = cache_index.clamp(0, cache.max_len - s)
        at = (torch.arange(b, device=x.device)[:, None],
              start[:, None] + torch.arange(s, device=x.device)[None, :])
    else:
        if cache_index + s > cache.max_len:
            raise ValueError(f"writing {s} slots at {cache_index} overruns a "
                             f"cache of {cache.max_len}")
        at = (slice(None), slice(cache_index, cache_index + s))
    if cache.k_scale is not None:
        # K and V quantized in one pass (half the launches of two)
        (kq, vq), (ks, vs) = _quantize_kv(torch.stack((k, v)))
        cache.k_scale[li][at] = ks
        cache.v_scale[li][at] = vs
        cache.k[li][at] = kq
        cache.v[li][at] = vq
    else:
        cache.k[li][at] = k.to(cache.k.dtype)
        cache.v[li][at] = v.to(cache.v.dtype)
    if s == 1:
        if kv_valid is None:
            raise ValueError("decode needs the (B, Smax) kv_valid mask")
        out = attention.decode(q, cache.k, cache.v, li, kv_valid,
                               cache.k_scale, cache.v_scale)
    else:
        chunk_valid = kv_valid[:, :s] if kv_valid is not None else None
        out = prefill_attention(q, k, v, chunk_valid, causal=True,
                                attention=attention)
    return _proj(lp, li, "wo", out.reshape(b, s, h), attention)


def forward_hidden(params: LlamaWeights, cfg: TextConfig,
                   inputs_embeds: torch.Tensor,
                   attn_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[KVCache] = None,
                   cache_index: Slots = 0,
                   kv_valid: Optional[torch.Tensor] = None,
                   cross_valid: Optional[torch.Tensor] = None,
                   attention: Attention = KERNELS, remat=False):
    """Run the decoder stack.  Returns (hidden, cache_or_None).

    inputs_embeds: (B, S, H).  attn_mask: (B, S) padding mask of the
    cacheless path.  positions: (B, S) rotary positions (default arange,
    plus ``cache_index`` with a cache).  With a cache, the chunk is written
    at slot ``cache_index``, an int or a (B,) tensor of per-row slots
    (clamped into the cache, as JAX's dynamic_update_slice clamps), and
    ``kv_valid`` (B, Smax) marks attendable slots.  ``attention`` picks
    the kernels (default) or their plain versions.  ``remat`` (cacheless path only): True/"full" wraps each
    layer in `torch.utils.checkpoint`, so the backward recomputes its
    forward (the attention forward then runs twice per layer).
    """
    b, s, _ = inputs_embeds.shape
    use_remat = _use_remat(remat)
    if use_remat and cache is not None:
        raise ValueError("remat applies to the cacheless forward only")
    if cross_valid is not None:
        raise NotImplementedError(
            "the cross_valid extend branch (multi-turn KV reuse, speculative "
            "verification) is not ported yet")
    if cache is not None:
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            if tuple(cache_index.shape) != (b,):
                raise ValueError(f"per-row cache slots of shape "
                                 f"{tuple(cache_index.shape)} for {b} rows")
            cache_index = cache_index.to(inputs_embeds.device, torch.int64)
        else:
            cache_index = int(cache_index)
    if positions is None:
        base = torch.arange(s, device=inputs_embeds.device)[None, :]
        if cache is not None:
            base = base + (cache_index[:, None] if isinstance(
                cache_index, torch.Tensor) else cache_index)
        positions = base.expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)

    lp = params["layers"]
    eps = cfg.rms_norm_eps
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        if cache is None:
            if use_remat:
                x = checkpoint(_layer, lp, li, x, cfg, cos, sin, attn_mask,
                               attention, use_reentrant=False)
            else:
                x = _layer(lp, li, x, cfg, cos, sin, attn_mask, attention)
            continue
        hn = rms_norm(x, lp["attn_norm"][li], eps)
        x = x + _attn_cached(lp, li, hn, cfg, cos, sin, cache, cache_index,
                             kv_valid, attention)
        x = x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps),
                     attention)
    return rms_norm(x, params["final_norm"], eps), cache


def logits_from_hidden(params: LlamaWeights, hidden: torch.Tensor,
                       attention: Attention = KERNELS) -> torch.Tensor:
    """fp32 logits (llama.py:777-787) through `_linear`: a float
    ``lm_head`` is stored (in, out), a quantized one ((out, in), packed for
    int4, see ``ops/quant.py``) comes with its (1, vocab) scale."""
    w = params["lm_head"]
    if w.dtype not in QUANTIZED:
        return _linear(hidden, w, None, attention, kf=True).to(torch.float32)
    return _linear(hidden, w, params["lm_head_scale"].reshape(-1),
                   attention).to(torch.float32)


def forward(params: LlamaWeights, cfg: TextConfig,
            inputs_embeds: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            attention: Attention = KERNELS, remat=False) -> torch.Tensor:
    """Cacheless forward: (B, S, H) -> fp32 logits (B, S, V)."""
    hidden, _ = forward_hidden(params, cfg, inputs_embeds, attn_mask,
                               attention=attention, remat=remat)
    return logits_from_hidden(params, hidden, attention)
