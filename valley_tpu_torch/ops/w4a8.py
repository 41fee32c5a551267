"""The grouped W4A8 product of prefill chunks (K8, ``csrc/w4a8_group_gemm.cu``)
with its plain PyTorch version and the wrapper that runs one or the other.

The product of ``valley_tpu/models/llama.py:210`` `_w4a8_group_dot`, which
the JAX package leaves to XLA: int8 activations (quantized per token by
`llama._w4a8_group_dot`, as in JAX) against a nibble-packed int4 weight with
one bf16 scale per output and group of `GROUP` inputs, each group's sum
exact in int32, then in fp32 times the group's scale, summed over the
groups in order, times the token's scale.  No Pallas kernel computes it, and
no single library call does (an int8 matrix product has no per-group
rescale), so K8 is written by hand.  It serves the chunks of at least
`MIN_ROWS` rows that `llama._proj` sends it (prefill buckets, long
extends); decode stays on K5.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops.quant import unpack_int4

# the inputs a group (the kernel's GROUP; JAX's int4ga8/int4gpa8 group)
GROUP = 128
# `llama._A8_MIN_SEQ`: the rows of the smallest chunk the decoder sends here
MIN_ROWS = 128


def w4a8_group_plain(xq: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[t, f] = a[t] * sum_g float(sum_{i in g} xq[t, i] w[f, i]) s[f, g],
    cast to ``out_dtype``.

    xq: (T, K) int8; a: (T,) fp32; w: (F, K/2) uint8 nibble pairs
    (`quant.pack_int4`); scale: (F, G) bf16, G groups of K/G inputs (K8's
    G is K/`GROUP`; the plain version takes any even group size).  Each
    group's (T, F) sum is one fp64 matrix product of the integer values,
    exact (every partial sum an integer under 2^24), so the (T, F, G)
    partial tensor is never built; the fp32 sum over the groups runs in
    group order, each term rounded before it is added, the arithmetic of
    K8."""
    t, k = xq.shape
    f, n_groups = w.shape[0], scale.shape[-1]
    gs = k // n_groups
    if k % n_groups or gs % 2 or scale.shape != (f, n_groups) \
            or 2 * w.shape[1] != k:
        raise ValueError(f"xq {tuple(xq.shape)}, w {tuple(w.shape)} and "
                         f"scale {tuple(scale.shape)} are not a grouped "
                         f"W4A8 product")
    s = scale.to(torch.float32)
    x64 = xq.to(torch.float64)
    acc = torch.zeros((t, f), dtype=torch.float32, device=xq.device)
    for g in range(n_groups):
        wg = unpack_int4(w[:, g * gs // 2:(g + 1) * gs // 2])   # (F, gs)
        part = x64[:, g * gs:(g + 1) * gs] @ wg.to(torch.float64).t()
        acc = acc + part.to(torch.float32) * s[:, g]
    return (acc * a.reshape(t, 1).to(torch.float32)).to(out_dtype)


@functools.cache
def _lib():
    """The built K8 library, its group size checked against `GROUP`."""
    lib = _build.load("w4a8_group_gemm")
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.w4a8_group_gemm.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.w4a8_group_gemm.restype = i
    lib.w4a8_group_size.restype = i
    if lib.w4a8_group_size() != GROUP:
        raise RuntimeError(f"w4a8_group_gemm.cu takes groups of "
                           f"{lib.w4a8_group_size()}, ops/w4a8.py expects "
                           f"{GROUP}")
    return lib


def _check(xq, a, w, scale, out_dtype) -> None:
    if xq.dtype != torch.int8 or a.dtype != torch.float32 \
            or w.dtype != torch.uint8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"K8 takes int8 xq, fp32 a, uint8 (packed) w and a "
                        f"bf16 scale, got {xq.dtype}, {a.dtype}, {w.dtype}, "
                        f"{scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K8 writes fp32 or bf16, not {out_dtype}")
    if xq.dim() != 2 or a.dim() != 1 or w.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"want xq (T, K), a (T,), w (F, K/2), scale (F, "
                         f"K/{GROUP}), got {tuple(xq.shape)}, "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    t, k = xq.shape
    f = w.shape[0]
    if k % GROUP or 2 * w.shape[1] != k or a.shape[0] != t \
            or scale.shape != (f, k // GROUP):
        raise ValueError(f"K8 needs K a multiple of {GROUP}: xq "
                         f"{tuple(xq.shape)}, a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")
    if t < MIN_ROWS:
        raise ValueError(f"K8 serves chunks of at least {MIN_ROWS} rows, got "
                         f"{t} (decode takes K5)")
    if t >= 2 ** 31 // max(f, k):
        raise ValueError(f"K8 indexes in int: T {t}, K {k}, F {f}")
    for name, v in (("xq", xq), ("a", a), ("w", w), ("scale", scale)):
        if v.device != xq.device:
            raise ValueError(f"{name} is on {v.device}, xq on {xq.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # xq and w are read in 16-byte vectors
    for name, v in (("xq", xq), ("w", w)):
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def w4a8_group_gemm(xq: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The grouped W4A8 product: same arguments and result as
    `w4a8_group_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous
    int8 xq of at least `MIN_ROWS` rows with K a multiple of `GROUP`, an
    fp32 (T,) a, a uint8 (F, K/2) w and a bf16 (F, K/GROUP) scale, and
    ``out_dtype`` fp32 or bf16; they run K8, and anything else raises.
    Each kernel launch adds one to ``w4a8_group_gemm.launches``.
    """
    if xq.device.type == "cpu":
        return w4a8_group_plain(xq, a, w, scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no W4A8 product for device {xq.device}")
    _check(xq, a, w, scale, out_dtype)
    lib = _lib()
    t, k = xq.shape
    f = w.shape[0]
    out = torch.empty((t, f), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.w4a8_group_gemm(xq.data_ptr(), a.data_ptr(), w.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), t, k, f,
                              int(out_dtype == torch.bfloat16), stream)
    _build.check(err, "w4a8_group_gemm")
    _build.count_launch(w4a8_group_gemm)
    return out


w4a8_group_gemm.launches = 0
