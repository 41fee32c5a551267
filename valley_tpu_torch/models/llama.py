"""LLaMA decoder (LLaMA-1/2, Vicuna), the PyTorch counterpart of
``valley_tpu/models/llama.py``.

Weights keep the JAX package's stacked layout: every per-layer tensor has a
leading layer axis, projections are stored (L, out, in) and a bf16
``lm_head`` (in, out), so converting a JAX tree is a dtype and device copy
(a quantized ``lm_head`` is stored (out, in): see ``ops/quant.py``).  The KV
cache is the same stacked (L, B, Smax, Hkv, D) buffer, bf16/fp32 or int8
with (L, B, Smax, Hkv) bf16 scales; this port writes it in place.  RMSNorm,
rotary and softmax run in fp32 exactly where the JAX package runs them.

Ported: the cacheless forward (training, with per-layer
rematerialisation, full or ``"dots"``, as an option, and LoRA adapters
with their training-time dropout; on a tree cut over a ``model`` axis, on
the rank's heads and MLP columns with Megatron's collectives,
`parallel.tensor`), bucketed prefill at ``cache_index`` 0 and
single-token decode over the stacked cache, for any number of rows B, with
one slot for every row or a slot per row (continuous batching: rows that
joined at different times write at their own slots); the fused serving
layout (``wqkv``, ``w_gateup``), the decode GEMVs of up to ``MAX_ROWS``
rows (bf16 projections and ``lm_head`` through K6, per-channel int8
through K4, nibble-packed int4 with group or channel scales through K5),
W8A8 prefill for int8 ``*_scale_a8`` trees, grouped W4A8 prefill for int4
ones (K8), grouped int8 scales, the int8 KV cache, and the
``cross_valid`` extend branch (a chunk appended to a session's cache
attends every valid slot and itself causally: multi-turn KV reuse).  Not
ported, and refused with NotImplementedError: a half-fused layout.
Adapters ride on the unfused, unquantized layout only, as in JAX (merge
them first to fuse or quantize: ``train/lora.py``).  The JAX package's
split of batched decode into a carried and a sliced cache
(llama.py:538-548) works around a TPU layout choice and has no
counterpart: one cached form serves every B.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from valley_tpu_torch.config import TextConfig
from valley_tpu_torch.models import Weights
from valley_tpu_torch.ops.attention import KERNELS, Attention, \
    mha_attention, prefill_attention
from valley_tpu_torch.ops.quant import (MAX_ROWS, RECIP_127, dequantize,
                                        int8_matvec_plain, unpack_int4)
from valley_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from valley_tpu_torch.ops.w4a8 import quantize_tokens_plain
from valley_tpu_torch.parallel.tensor import TensorParallel, tensor_parallel

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


def is_lora_name(name: str) -> bool:
    """Whether a layer tensor's name is a LoRA factor or the scale."""
    return name.endswith(("_lora_a", "_lora_b")) or name == "lora_scale"


class LlamaLayers(Weights):
    """The stacked decoder layers: the unfused projections or the fused
    serving layout (``wqkv``, ``w_gateup``), each int8 projection with its
    (L, out) bf16 scale, each packed int4 one ((L, out, in/2) uint8) with
    its (L, out) or grouped (L, out, in/group) bf16 scale.  An unfused
    float layout may carry LoRA adapters (llama.py:338-347): for a target
    ``<name>``, ``<name>_lora_a`` (L, in, r) and ``<name>_lora_b`` (L, r,
    out), with one ``lora_scale`` (L, 1, 1)."""
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
        names = ["attn_norm", *_with_scale(tensors, ATTN_PROJ[f]),
                 "mlp_norm", *_with_scale(tensors, MLP_PROJ[f])]
        lora = [n for n in ATTN_PROJ[f] + MLP_PROJ[f]
                if n + "_lora_a" in tensors]
        if lora or any(is_lora_name(n) for n in tensors):
            if f or any(tensors[n].dtype in QUANTIZED
                        for n in ATTN_PROJ[f] + MLP_PROJ[f]):
                raise NotImplementedError(
                    "LoRA adapters on a fused or quantized layout: merge "
                    "them first (train/lora.merge_lora), as JAX's "
                    "fuse_llama_params asks")
            names += [n + s for n in lora for s in ("_lora_a", "_lora_b")]
            names.append("lora_scale")
        return tuple(names)


class LlamaWeights(Weights):
    """Embedding, layers, final norm and ``lm_head`` (int8 or packed int4:
    with its (1, vocab) bf16 ``lm_head_scale``).  ``tp``: the
    `parallel.tensor.TensorParallel` of a tree cut over a ``model`` axis
    (`parallel.sharding.shard_params`), whose collectives the cached
    forward, `embed` and `logits_from_hidden` then run; None on one
    device."""
    NAMES = ("embed", "layers", "final_norm", "lm_head")
    tp: Optional[TensorParallel] = None

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
               dtype=torch.bfloat16, device=None,
               kv_heads: Optional[int] = None) -> KVCache:
    """A zeroed cache of ``kv_heads`` heads (default the config's: a
    tensor-parallel rank's are its `TensorParallel.kv_heads`)."""
    shape = (cfg.num_hidden_layers, batch, max_len, kv_heads or cfg.kv_heads,
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
    if "lora_scale" in layers:
        raise ValueError("fuse before adding LoRA adapters")
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
    """The ids' rows of the embedding; vocabulary-parallel on a tree cut
    over a ``model`` axis (`TensorParallel.embed`)."""
    tp = tensor_parallel(params)
    if tp is not None:
        return tp.embed(params["embed"], input_ids)
    return params["embed"][input_ids]


# W8A8 and W4A8 (``*_scale_a8`` trees) apply only to chunks whose sequence
# axis is at least this long (llama.py:169-179): prefill buckets are >= 128,
# decode steps take the dequant GEMV, so decode matches plain int8 (int4g)
# given the same cache.
_A8_MIN_SEQ = 128


# the plain per-token quantization of W8A8 and W4A8 (llama.py:196-199,
# 232-235): x (..., K) -> (int8 (T, K), fp32 (T, 1) scales)
_quantize_tokens = quantize_tokens_plain


def _global_amax(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Each token's absmax over the inputs of every rank of the ``model``
    group: a row-parallel projection's activations quantize by the whole
    row's absmax, as one device does (XLA reduces it over the group)."""
    amax = x.reshape(-1, x.shape[-1]).to(torch.float32).abs().amax(dim=-1)
    return tp.all_reduce_max(amax)


def _w8a8_dot(x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """quant(x) @ int8 w^T -> int32, fp32 rescale (llama.py:182-207).

    Activations quantize per token (row absmax clamped at 1e-6, times
    fl32(1/127) as XLA compiles JAX's ``/ 127.0`` under jit),
    the int8 x int8 product accumulates exactly in int32, and the result
    rescales by (token scale x out-channel weight scale) in fp32 before the
    cast to x's dtype.  ``w`` is (out, in).  The JAX package leaves this
    product to XLA, outside any Pallas kernel, so the port leaves it to
    the library's int8 matrix product (``torch._int_mm``), as it leaves
    plain large matmuls to torch.  A packed int4 ``w`` with per-channel
    scales (int4ga8's tree where the group does not divide K) takes its
    int4 values as int8, as JAX's does.  A row-parallel ``tp`` product
    quantizes by the tokens' absmax over the group and sums the int32
    partial products over it, exactly, as XLA does: the result is one
    device's bit for bit."""
    if w.dtype == torch.uint8:
        w = unpack_int4(w)
    amax = None if tp is None else _global_amax(x, tp)
    xq, ascale = _quantize_tokens(x, amax)
    y = torch._int_mm(xq, w.t())
    if tp is not None:
        y = tp.all_reduce(y)
    out = y.to(torch.float32) * ascale * scale[None, :].to(torch.float32)
    return out.reshape(x.shape[:-1] + (w.shape[-2],)).to(x.dtype)


def _w4a8_group_dot(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    attention: Attention = KERNELS,
                    tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Grouped W4A8 (llama.py:210-243): x quantized per token by
    ``attention.quantize`` (K8q, `ops.w4a8.quantize_tokens`, or
    `_quantize_tokens`, bit-equal), then ``attention.group_gemm`` (K8,
    `ops.w4a8.w4a8_group_gemm`, or its plain version) against the packed
    (out, in/2) ``w`` and its (out, in/gs) group scales: each group's
    int8 x int4 sum exact in int32, times the group's scale in fp32,
    summed over the groups, times the token's scale, cast to x's dtype.
    K8 sums the groups in order; XLA's reduction may take another order,
    so the result agrees with JAX's to the rounding of an fp32 sum of
    K/gs terms.  A row-parallel ``tp`` product quantizes by the tokens'
    absmax over the group, each rank's fp32 partial sum over its groups
    summed over the group before the cast."""
    if tp is None:
        xq, ascale = attention.quantize(x)
        y = attention.group_gemm(xq, ascale.reshape(-1), w, scale, x.dtype)
    else:
        xq, ascale = attention.quantize(x, _global_amax(x, tp))
        y = tp.all_reduce(attention.group_gemm(
            xq, ascale.reshape(-1), w, scale, torch.float32)).to(x.dtype)
    return y.reshape(x.shape[:-1] + (w.shape[0],))


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
    grouped8 = w.dtype == torch.int8 and scale.dim() == 2 \
        and scale.shape[0] == w.shape[0]
    if rows <= MAX_ROWS and not grouped8 and (w.dtype in QUANTIZED or (
            w.dtype == torch.bfloat16 and not tracks_grad)):
        y = attention.matvec(x.reshape(rows, x.shape[-1]), w, scale, kf)
        return y.reshape(x.shape[:-1] + (y.shape[-1],))
    if w.dtype == torch.uint8 or grouped8:
        return F.linear(x, dequantize(w, scale, x.dtype))
    if w.dtype == torch.int8:
        return int8_matvec_plain(x, w, scale)
    return x @ w if kf else F.linear(x, w)


# stable per-projection ids for the adapter dropout's keys (llama.py:166)
_PROJ_IDS = {"wq": 0, "wk": 1, "wv": 2, "wo": 3,
             "w_gate": 4, "w_up": 5, "w_down": 6}

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data``, as ``jax.random.fold_in``
    derives one (a splitmix64 round over both, kept to 63 bits so that it
    passes as an int64 wherever torch records arguments: a different
    function, so the keys, and the masks drawn from them, are not JAX's)."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def dropout_mask(key: int, shape, keep: float, device) -> torch.Tensor:
    """The bool keep-mask of ``shape`` (True with probability ``keep``)
    drawn from a generator seeded by ``key`` alone (torch's Philox stream
    on the card), so a rematerialised layer draws the same bits again."""
    gen = torch.Generator(device).manual_seed(key)
    return torch.rand(shape, generator=gen, device=device) < keep


def _adapter_mask(key: int, x: torch.Tensor, keep: float,
                  row: Optional[TensorParallel] = None) -> torch.Tensor:
    """The keep-mask of an adapter's input ``x``: `dropout_mask` of x's
    shape; for a row-parallel adapter (``row``: its `TensorParallel`)
    drawn over the one-device inputs and narrowed to the rank's, so that
    every rank applies its columns of the one-device mask."""
    if row is None:
        return dropout_mask(key, x.shape, keep, x.device)
    start, full = row.in_span(x.shape[-1])
    return dropout_mask(key, x.shape[:-1] + (full,), keep,
                        x.device).narrow(-1, start, x.shape[-1])


def _proj(lp: Mapping, li: int, name: str, x: torch.Tensor,
          attention: Attention, lora_key: Optional[int] = None,
          lora_dropout: float = 0.0,
          reduce: Optional[TensorParallel] = None) -> torch.Tensor:
    """x @ W^T for layer ``li``'s (out, in) projection ``name``
    (llama.py:246-347) through `_linear`, except a weight with a
    ``_scale_a8`` scale and a sequence axis of at least `_A8_MIN_SEQ`: an
    int4 one with group scales takes `_w4a8_group_dot`, an int8 one, or an
    int4 one with per-channel scales, `_w8a8_dot`, as JAX routes them.  The
    result takes x's dtype.  A projection
    with adapters adds ``((x' @ A) @ B) * scale`` in x's dtype, x' being x
    under inverted dropout (rate ``lora_dropout``, the layer's key
    ``lora_key`` folded with the projection's id) when a key is given and
    x itself otherwise; the JAX package computes this branch with plain
    XLA products, and so the port with torch's.  ``reduce``: the
    projection is row-parallel over that `TensorParallel`'s group (x the
    rank's inputs, A the rank's rows of it, B whole), and its partial
    sums, the adapter's added, are summed over the group (`TensorParallel.
    sum`) before the cast."""
    w = lp[name][li]
    scale = None
    if w.dtype in QUANTIZED:
        a8 = lp.get(name + "_scale_a8")
        scale = (lp[name + "_scale"] if a8 is None else a8)[li]
        if a8 is not None and x.dim() >= 2 and x.shape[-2] >= _A8_MIN_SEQ:
            if scale.dim() == w.dim():
                return _w4a8_group_dot(x, w, scale, attention, reduce)
            return _w8a8_dot(x, w, scale, reduce)
    out = _linear(x, w, scale, attention)
    a = lp.get(name + "_lora_a")
    if a is not None:
        xl = x
        if lora_key is not None and lora_dropout > 0.0:
            keep = 1.0 - lora_dropout
            mask = _adapter_mask(fold_in(lora_key, _PROJ_IDS[name]), x,
                                 keep, reduce)
            xl = torch.where(mask, x / keep, 0).to(x.dtype)
        delta = (xl @ a[li]) @ lp[name + "_lora_b"][li]
        out = out.to(x.dtype) + delta * lp["lora_scale"][li][0, 0]
    if reduce is not None:
        out = reduce.sum(out)
    return out.to(x.dtype)


def _heads(cfg: TextConfig, tp: Optional[TensorParallel]) -> tuple:
    """(query heads, kv heads) one rank computes: the config's, or a
    tensor-parallel rank's share."""
    if tp is None:
        return cfg.num_attention_heads, cfg.kv_heads
    return tp.heads, tp.kv_heads


def _qkv(lp: Mapping, li: int, x: torch.Tensor, cfg: TextConfig, cos,
         sin, attention: Attention, tp: Optional[TensorParallel] = None,
         **lora):
    b, s, _ = x.shape
    nh, nkv = _heads(cfg, tp)
    if tp is not None:
        x = tp.enter(x)
    if "wqkv" in lp:
        # fused serving layout: one product, then the q/k/v column slices
        # (v made contiguous: the kernels take contiguous tensors)
        h_sz = nh * cfg.head_dim
        kv_sz = nkv * cfg.head_dim
        qkv = _proj(lp, li, "wqkv", x, attention, **lora)
        q = qkv[..., :h_sz]
        k = qkv[..., h_sz:h_sz + kv_sz]
        v = qkv[..., h_sz + kv_sz:].contiguous()
    else:
        q = _proj(lp, li, "wq", x, attention, **lora)
        k = _proj(lp, li, "wk", x, attention, **lora)
        v = _proj(lp, li, "wv", x, attention, **lora)
    q = q.reshape(b, s, nh, cfg.head_dim)
    k = k.reshape(b, s, nkv, cfg.head_dim)
    v = v.reshape(b, s, nkv, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(lp: Mapping, li: int, x: torch.Tensor, attention: Attention,
         tp: Optional[TensorParallel] = None, **lora) -> torch.Tensor:
    if tp is not None:
        x = tp.enter(x)
    if "w_gateup" in lp:
        gu = _proj(lp, li, "w_gateup", x, attention, **lora)
        f = gu.shape[-1] // 2
        gate = F.silu(gu[..., :f].to(torch.float32))
        up = gu[..., f:].to(torch.float32)
    else:
        gate = F.silu(_proj(lp, li, "w_gate", x, attention, **lora).to(
            torch.float32))
        up = _proj(lp, li, "w_up", x, attention, **lora).to(torch.float32)
    return _proj(lp, li, "w_down", (gate * up).to(x.dtype), attention,
                 reduce=tp, **lora)


def _attn(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention,
          tp: Optional[TensorParallel] = None, **lora):
    """Cacheless causal self-attention over the block (on a tensor-parallel
    rank: over its heads, with ``wo``'s partial sums summed)."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin, attention, tp, **lora)
    mask = None if attn_mask is None else attn_mask > 0
    out = prefill_attention(q, k, v, mask, causal=True, attention=attention)
    return _proj(lp, li, "wo", out.reshape(b, s, -1), attention,
                 reduce=tp, **lora)


def _layer(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention,
           lora_key: Optional[int] = None, lora_dropout: float = 0.0,
           tp: Optional[TensorParallel] = None):
    """One cacheless decoder layer (llama.py:526-535); ``lora_key`` is the
    layer's adapter-dropout key (`_proj`); ``tp``: the rank's
    `TensorParallel` on a tree cut over a ``model`` axis."""
    eps = cfg.rms_norm_eps
    lora = dict(lora_key=lora_key, lora_dropout=lora_dropout)
    x = x + _attn(lp, li, rms_norm(x, lp["attn_norm"][li], eps), cfg, cos,
                  sin, attn_mask, attention, tp, **lora)
    return x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps), attention,
                    tp, **lora)


def _per_layer(lp: LlamaLayers) -> dict:
    """{name: the (L, ...) stack unbound into its L layers}.  Indexing a
    stacked parameter once per layer makes autograd write a zeroed tensor
    the size of the whole stack for every layer and add each into the
    gradient; the layers' views of one ``unbind`` take their gradients
    apart and stack them once.  On a sharded tree each layer's view goes
    through the stack's read (`LlamaLayers.reads`), which gathers that
    layer when the layer reads it."""
    out = {}
    for n, p in lp.named_parameters(recurse=False):
        read = lp.reads.get(n)
        out[n] = p.unbind(0) if read is None else read(p.unbind(0))
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy's choice for each op of a layer's forward:
    save the output of a product with no batch dimension (``aten.mm`` and
    ``aten.addmm``: every projection, fused or not, and the adapters'), as
    JAX's ``dots_with_no_batch_dims_saveable``; recompute every other op
    (the norms, rope, SwiGLU, the casts, attention's batched products)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(remat) -> Optional[str]:
    """The ``remat`` knob of llama.py:640-657: True/"full" recomputes each
    layer in the backward, "dots" keeps its products' outputs and
    recomputes the rest, False/None keeps every activation (None)."""
    if remat in (True, "full"):
        return "full"
    if remat in (False, None):
        return None
    if remat == "dots":
        return "dots"
    raise ValueError(f"unknown remat policy {remat!r} "
                     "(use True/'full', 'dots', or False)")


def _checkpoint_kwargs(policy: str) -> dict:
    """`torch.utils.checkpoint` arguments of a remat policy: "dots" passes
    the selective-checkpoint contexts of `_dots_policy`.  K1, a call into
    its own library that no policy sees, runs again in the recompute under
    either policy, as JAX recomputes its Pallas call."""
    if policy == "full":
        return {}
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}


def _quantize_kv(x: torch.Tensor):
    """(B, S, H, D) -> int8 values and per-(row, slot, head) absmax scales
    (llama.py:387-392): fp32 scale max(amax, 1e-6) times fl32(1/127),
    values round(x / scale) with that fp32 scale, the scale stored bf16.
    JAX writes ``/ 127.0``, which XLA compiles under jit, as the engine
    serves it, into the reciprocal's product (the quotient differs in the
    last bit of some scales); on the card torch took the same product for
    the quotient."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) * RECIP_127
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _cache_layer(cache: KVCache, li: int, dtype: torch.dtype):
    """Layer ``li``'s (B, Smax, Hkv, D) K and V in ``dtype``; an int8 cache
    dequantized as ``k * k_scale`` in that dtype (llama.py:408-417)."""
    ck, cv = cache.k[li], cache.v[li]
    if cache.k_scale is None:
        return ck, cv
    return (ck.to(dtype) * cache.k_scale[li][..., None].to(dtype),
            cv.to(dtype) * cache.v_scale[li][..., None].to(dtype))


def _extend_bias(cross_valid: torch.Tensor, cache_index: Slots, s: int
                 ) -> torch.Tensor:
    """(B, 1, S, Smax) additive bias of a chunk of ``s`` tokens written at
    ``cache_index`` (scalar or per row, unclamped as in JAX): 0 where a
    query attends, -1e9 elsewhere.  Query i attends every ``cross_valid``
    slot and the chunk's slots up to its own (llama.py:482-494)."""
    b, smax = cross_valid.shape
    dev = cross_valid.device
    slots = torch.arange(smax, device=dev)
    ci = torch.as_tensor(cache_index, device=dev).reshape(-1).expand(b)
    rel = slots[None, :] - ci[:, None]                    # (B, Smax)
    in_chunk = (rel >= 0) & (rel < s)
    causal = rel[:, None, :] <= torch.arange(s, device=dev)[None, :, None]
    mask = cross_valid[:, None, :] | (in_chunk[:, None, :] & causal)
    return torch.where(mask[:, None], 0.0, -1e9)


def _attn_cached(lp, li, x, cfg, cos, sin, cache: KVCache, cache_index: Slots,
                 kv_valid, attention: Attention, cross_bias=None,
                 tp: Optional[TensorParallel] = None):
    """Write this chunk's K/V (an int8 cache: quantized, with their scales)
    into layer ``li`` of the cache at slot ``cache_index``, or at each
    row's own slot for a (B,) ``cache_index``, then attend: one token
    against the whole cache; with ``cross_bias`` (`_extend_bias`), a chunk
    appended to a session's cache against every valid slot and itself
    causally, through the plain `mha_attention` over the layer read back
    (dequantized) from the cache, as JAX does (``use_flash=False``); or a
    prefill chunk causally within itself on its unquantized K/V (the cache
    beyond the chunk is empty: the engine prefills at slot 0).  On a
    tensor-parallel rank (``tp``) the heads are the rank's, the cache
    holds the kv heads they read, and the ``wo`` product's partial sums
    are summed over the group."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin, attention, tp)
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
    elif cross_bias is not None:
        ck, cv = _cache_layer(cache, li, q.dtype)
        out = mha_attention(q, ck, cv, cross_bias)
    else:
        chunk_valid = kv_valid[:, :s] if kv_valid is not None else None
        out = prefill_attention(q, k, v, chunk_valid, causal=True,
                                attention=attention)
    return _proj(lp, li, "wo", out.reshape(b, s, -1), attention, reduce=tp)


def forward_hidden(params: LlamaWeights, cfg: TextConfig,
                   inputs_embeds: torch.Tensor,
                   attn_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[KVCache] = None,
                   cache_index: Slots = 0,
                   kv_valid: Optional[torch.Tensor] = None,
                   cross_valid: Optional[torch.Tensor] = None,
                   attention: Attention = KERNELS, remat=False,
                   lora_rng: Optional[int] = None,
                   lora_dropout: float = 0.0):
    """Run the decoder stack.  Returns (hidden, cache_or_None).

    inputs_embeds: (B, S, H).  attn_mask: (B, S) padding mask of the
    cacheless path.  positions: (B, S) rotary positions (default arange,
    plus ``cache_index`` with a cache).  With a cache, the chunk is written
    at slot ``cache_index``, an int or a (B,) tensor of per-row slots
    (clamped into the cache, as JAX's dynamic_update_slice clamps), and
    ``kv_valid`` (B, Smax) marks attendable slots; a chunk of more than one
    token given ``cross_valid`` (B, Smax), the slots valid before it, is
    appended to a session's cache (`_attn_cached`).  ``attention`` picks
    the kernels (default) or their plain versions.  ``remat`` (cacheless
    path only): True/"full" wraps each layer in `torch.utils.checkpoint`,
    so the backward recomputes its forward; "dots" saves the layer's
    products' outputs and recomputes the rest (`_dots_policy`).  The
    attention forward runs twice per layer under either.
    ``lora_rng`` (cacheless path only): the integer key of a training
    step's adapter dropout at rate ``lora_dropout``, folded with each
    layer's index (None: no dropout, as at inference).
    """
    b, s, _ = inputs_embeds.shape
    policy = _remat_policy(remat)
    if policy is not None and cache is not None:
        raise ValueError("remat applies to the cacheless forward only")
    if cross_valid is not None and cache is None:
        raise ValueError("cross_valid extends a cache: pass the cache")
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
    # one bias for every layer (JAX builds it per layer, inside the scan)
    cross_bias = _extend_bias(cross_valid, cache_index, s) \
        if cross_valid is not None and s > 1 else None

    if lora_rng is not None and cache is not None:
        raise ValueError("adapter dropout applies to the cacheless forward "
                         "only")
    tp = tensor_parallel(params)
    lp = params["layers"]
    if cache is None and torch.is_grad_enabled():
        lp = _per_layer(lp)
    eps = cfg.rms_norm_eps
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        if cache is None:
            key = None if lora_rng is None else fold_in(lora_rng, li)
            if policy is not None:
                x = checkpoint(_layer, lp, li, x, cfg, cos, sin, attn_mask,
                               attention, key, lora_dropout, tp,
                               use_reentrant=False,
                               **_checkpoint_kwargs(policy))
            else:
                x = _layer(lp, li, x, cfg, cos, sin, attn_mask, attention,
                           key, lora_dropout, tp)
            continue
        hn = rms_norm(x, lp["attn_norm"][li], eps)
        x = x + _attn_cached(lp, li, hn, cfg, cos, sin, cache, cache_index,
                             kv_valid, attention, cross_bias, tp)
        x = x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps),
                     attention, tp)
    return rms_norm(x, params["final_norm"], eps), cache


def logits_from_hidden(params: LlamaWeights, hidden: torch.Tensor,
                       attention: Attention = KERNELS,
                       gather: bool = True) -> torch.Tensor:
    """fp32 logits (llama.py:777-787) through `_linear`: a float
    ``lm_head`` is stored (in, out), a quantized one ((out, in), packed for
    int4, see ``ops/quant.py``) comes with its (1, vocab) scale.  On a
    tree cut over a ``model`` axis each rank computes its vocabulary's
    columns (its input through `TensorParallel.enter`) and every rank gets
    all of them (`Group.gather_columns`, before the cast to fp32: a bf16
    product's columns move at half the bytes, the same values); with
    ``gather`` False (the training loss, `TensorParallel.cross_entropy`)
    each rank keeps its own (..., vocab/N) columns."""
    tp = tensor_parallel(params)
    if tp is not None:
        hidden = tp.enter(hidden)
    w = params["lm_head"]
    if w.dtype not in QUANTIZED:
        out = _linear(hidden, w, None, attention, kf=True)
    else:
        out = _linear(hidden, w, params["lm_head_scale"].reshape(-1),
                      attention)
    if tp is not None and gather:
        out = tp.gather_columns(out)
    return out.to(torch.float32)


def forward(params: LlamaWeights, cfg: TextConfig,
            inputs_embeds: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            attention: Attention = KERNELS, remat=False,
            lora_rng: Optional[int] = None,
            lora_dropout: float = 0.0, gather: bool = True) -> torch.Tensor:
    """Cacheless forward: (B, S, H) -> fp32 logits (B, S, V) (``gather``:
    `logits_from_hidden`)."""
    hidden, _ = forward_hidden(params, cfg, inputs_embeds, attn_mask,
                               attention=attention, remat=remat,
                               lora_rng=lora_rng, lora_dropout=lora_dropout)
    return logits_from_hidden(params, hidden, attention, gather=gather)
