"""Decode attention over the stacked KV cache: the CUDA kernel
(``csrc/decode_attn.cu``), its plain PyTorch version, and the wrapper that
runs one or the other.

Counterpart of ``valley_tpu/ops/decode_pallas.py`` (bf16 cache, and the
int8 cache with per-(layer, row, slot, head) bf16 scales), whose oracle is
``valley_tpu/ops/attention.py:decode_attention`` over layer ``li``.  The
wrapper takes the plain version for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  A block per (row, kv head, chunk of
``chunk`` slots) skips what the mask leaves out and writes its chunk's
partials to the wrapper's scratch; a second kernel merges each (row, kv
head)'s chunks in chunk order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from valley_tpu_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)


def _head_scale(s: torch.Tensor) -> torch.Tensor:
    """(B, Smax, Hkv) slot scales -> (B, Hkv, 1, Smax) fp32 factors for
    the grouped (B, Hkv, n_rep, Smax) logits (attention.py:69-74 repeats
    them over the query heads instead)."""
    return s.to(torch.float32).transpose(1, 2)[:, :, None, :]


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, li: int,
                           valid: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token attention against layer ``li`` of the stacked cache.

    q: (B, 1, H, D); k_all/v_all: (L, B, Smax, Hkv, D); valid: (B, Smax)
    bool, True for attendable slots; k_scale/v_scale: (L, B, Smax, Hkv)
    for an int8 cache.  The cache is cast to q's dtype; fp32 logits (times
    the K scales), -1e9 on invalid slots, fp32 softmax, probabilities
    (times the V scales) cast to q's dtype before PV, fp32 accumulation;
    returns (B, 1, H, D) in q.dtype.  Query head j reads kv head
    j // (H // Hkv), as ``_repeat_kv`` lays them out.
    """
    b, _, h, d = q.shape
    hkv = k_all.shape[3]
    k = k_all[li].to(q.dtype)
    v = v_all[li].to(q.dtype)
    qg = q.float().reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) * d ** -0.5
    if k_scale is not None:
        logits = logits * _head_scale(k_scale[li])
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * _head_scale(v_scale[li])
    out = torch.einsum("bgrs,bsgd->bgrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


@functools.cache
def _lib():
    """The built library, with its compile-time constants read once:
    ``chunk`` (cache slots per block) and ``max_rep`` (query heads per kv
    head)."""
    return configure(_build.load("decode_attn"))


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a library built from
    ``csrc/decode_attn.cu`` and read its constants; returns it."""
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.decode_attn_bf16.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp,
                                     vp, vp, vp, i, i, i, i, i, i, i,
                                     ctypes.c_float, vp]
    lib.decode_attn_bf16.restype = i
    lib.decode_attn_int8.argtypes = [vp, vp, vp, vp, vp, vp,
                                     ctypes.c_longlong, vp, vp, vp, vp, i, i,
                                     i, i, i, i, i, ctypes.c_float, vp]
    lib.decode_attn_int8.restype = i
    lib.decode_attn_chunk.restype = i
    lib.decode_attn_max_rep.restype = i
    lib.chunk = lib.decode_attn_chunk()
    lib.max_rep = lib.decode_attn_max_rep()
    return lib


def _check(q, k_all, v_all, li, valid, max_rep, k_scale=None,
           v_scale=None):
    quant = k_scale is not None or v_scale is not None
    cache = torch.int8 if quant else torch.bfloat16
    if (q.dtype != torch.bfloat16 or k_all.dtype != cache
            or v_all.dtype != cache):
        raise TypeError(
            f"decode kernel takes a bf16 query with a bf16 cache, or an int8 "
            f"cache with its K and V scales; got q {q.dtype}, cache "
            f"{k_all.dtype}/{v_all.dtype}, "
            f"{'with' if quant else 'without'} scales")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"want q (B, 1, H, D), got {tuple(q.shape)}")
    if k_all.dim() != 5 or k_all.shape != v_all.shape:
        raise ValueError(f"want k_all/v_all (L, B, Smax, Hkv, D), got "
                         f"{tuple(k_all.shape)}, {tuple(v_all.shape)}")
    b, _, h, d = q.shape
    n_layers, cb, smax, hkv, cd = k_all.shape
    if cb != b or cd != d:
        raise ValueError("cache batch and head_dim must equal q's")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if h % hkv or not 1 <= h // hkv <= max_rep:
        raise ValueError(f"{h} query heads over {hkv} kv heads: the kernel "
                         f"serves 1..{max_rep} query heads per kv head")
    if not 0 <= li < n_layers:
        raise IndexError(f"layer {li} outside the cache's {n_layers}")
    if valid.dtype != torch.bool or valid.shape != (b, smax):
        raise ValueError(f"valid must be bool (B, Smax), got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if valid.stride(1) != 1:
        raise ValueError("valid must have unit stride along Smax")
    if valid.device != q.device:
        raise ValueError(f"valid is on {valid.device}, q on {q.device}")
    tensors = [("q", q), ("k_all", k_all), ("v_all", v_all)]
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.bfloat16 \
                    or t.shape != k_all.shape[:4]:
                raise ValueError(
                    f"{name} must be bf16 (L, B, Smax, Hkv) = "
                    f"{tuple(k_all.shape[:4])}, got "
                    f"{None if t is None else (t.dtype, tuple(t.shape))}")
            tensors.append((name, t))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_stacked(q: torch.Tensor, k_all: torch.Tensor,
                             v_all: torch.Tensor, li: int,
                             valid: torch.Tensor,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Decode attention for layer ``li`` read in place from the stacked
    cache.  Same arguments and result as `decode_attention_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous
    bf16 query with a bf16 cache, or with an int8 cache and its bf16
    (L, B, Smax, Hkv) scales, head_dim 16, 32, 64 or 128 and at most 8
    query heads per kv head; they run the kernel, and anything else raises.
    Each kernel launch adds one to ``decode_attention_stacked.launches``.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, li, valid, k_scale,
                                      v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    lib = _lib()
    _check(q, k_all, v_all, li, valid, lib.max_rep, k_scale, v_scale)
    b, _, h, d = q.shape
    _, _, smax, hkv, _ = k_all.shape
    n_split = -(-smax // lib.chunk)
    dev = q.device
    part_acc = torch.empty((b, h, n_split, d), dtype=torch.float32,
                           device=dev)
    part_m = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (valid.data_ptr(), valid.stride(0), part_acc.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), int(li), b,
            smax, hkv, h // hkv, d, n_split, d ** -0.5, stream)
    if k_scale is None:
        err = lib.decode_attn_bf16(q.data_ptr(), k_all.data_ptr(),
                                   v_all.data_ptr(), *tail)
        _build.check(err, "decode_attn_bf16")
    else:
        err = lib.decode_attn_int8(q.data_ptr(), k_all.data_ptr(),
                                   v_all.data_ptr(), k_scale.data_ptr(),
                                   v_scale.data_ptr(), *tail)
        _build.check(err, "decode_attn_int8")
    _build.count_launch(decode_attention_stacked)
    return out


decode_attention_stacked.launches = 0
