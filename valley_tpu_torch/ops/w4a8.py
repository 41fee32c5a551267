"""The grouped W4A8 product of prefill chunks (K8, ``csrc/w4a8_group_gemm.cu``)
and the per-token int8 quantization of its activations (K8q, the same
source), each with its plain PyTorch version and the wrapper that runs one
or the other.

The product of ``valley_tpu/models/llama.py:210`` `_w4a8_group_dot`, which
the JAX package leaves to XLA: int8 activations quantized per token
(`quantize_tokens`, llama.py:232-235) against a nibble-packed int4 weight
with one bf16 scale per output and group of inputs, each group's sum exact
in int32, then in fp32 times the group's scale, summed over the groups in
order, times the token's scale.  No Pallas kernel computes it, and no
single library call does (an int8 matrix product has no per-group
rescale), so K8 is written by hand.  It serves the chunks of at least
`MIN_ROWS` rows that `llama._proj` sends it (prefill buckets, long
extends); decode stays on K5.  K8 takes every group size that is a
multiple of `QUANTUM` and divides K; the plain version any even one, so a
tree with other groups is refused on the card where it is made
(`check_card_group`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops.quant import RECIP_127, unpack_int4

# K8's group sizes are multiples of this (one wgmma's 32 inputs)
QUANTUM = 32
# `llama._A8_MIN_SEQ`: the rows of the smallest chunk the decoder sends here
MIN_ROWS = 128


def check_card_group(group_size: int, k: int, device) -> None:
    """Refuse a W4A8 projection of K inputs that K8 cannot serve on
    ``device``: on the card, scales grouped by ``group_size`` (which
    divides K) where it is not a multiple of `QUANTUM`.  A group that does
    not divide K gives per-channel scales, which W8A8 serves, and the CPU
    runs the plain version at every group size.  Called where a tree is
    quantized or loaded, so the refusal comes before the first prefill."""
    if torch.device(device).type == "cuda" and group_size \
            and k % group_size == 0 and group_size % QUANTUM:
        raise ValueError(
            f"W4A8 group size {group_size} is not a multiple of {QUANTUM}: "
            f"K8, the card's grouped W4A8 product, takes groups of "
            f"{QUANTUM}, {2 * QUANTUM}, ... that divide K ({k}); quantize "
            f"with such a group, or serve this tree on the CPU")


def quantize_tokens_plain(x: torch.Tensor,
                          amax: Optional[torch.Tensor] = None) -> tuple:
    """x (..., K) -> (int8 (T, K), fp32 (T, 1) scales): each token by its
    absmax clamped at 1e-6 times fl32(1/127), its values divided by that
    scale (correctly rounded) and rounded half to even (llama.py:232-235).
    ``amax`` (T,) fp32, where given, is each token's absmax over a wider
    row than x's (a tensor-parallel rank's share of the inputs).
    JAX's function writes ``/ 127.0``, which XLA compiles under jit, as the
    package serves it, into this product with the reciprocal; run op by op
    it divides, which differs in the last bit of some scales.  The product
    is the same on the CPU and the card, and K8q's."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True) if amax is None \
        else amax.reshape(-1, 1).to(torch.float32)
    ascale = amax.clamp_min(1e-6) * RECIP_127
    return torch.round(xf / ascale).to(torch.int8), ascale


def w4a8_group_plain(xq: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[t, f] = a[t] * sum_g float(sum_{i in g} xq[t, i] w[f, i]) s[f, g],
    cast to ``out_dtype``.

    xq: (T, K) int8; a: (T,) fp32; w: (F, K/2) uint8 nibble pairs
    (`quant.pack_int4`); scale: (F, G) bf16, G groups of K/G inputs (K8
    takes multiples of `QUANTUM`, the plain version any even size).  Each
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
    """The built K8/K8q library, its group quantum checked against
    `QUANTUM`."""
    lib = _build.load("w4a8_group_gemm")
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.w4a8_group_gemm.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.w4a8_group_gemm.restype = i
    lib.w4a8_quantize_tokens.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.w4a8_quantize_tokens.restype = i
    lib.w4a8_group_quantum.restype = i
    if lib.w4a8_group_quantum() != QUANTUM:
        raise RuntimeError(f"w4a8_group_gemm.cu takes groups in multiples of "
                           f"{lib.w4a8_group_quantum()}, ops/w4a8.py expects "
                           f"{QUANTUM}")
    return lib


def _check(xq, a, w, scale, out_dtype) -> int:
    """Raise on what K8 does not take; returns the group size."""
    if xq.dtype != torch.int8 or a.dtype != torch.float32 \
            or w.dtype != torch.uint8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"K8 takes int8 xq, fp32 a, uint8 (packed) w and a "
                        f"bf16 scale, got {xq.dtype}, {a.dtype}, {w.dtype}, "
                        f"{scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K8 writes fp32 or bf16, not {out_dtype}")
    if xq.dim() != 2 or a.dim() != 1 or w.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"want xq (T, K), a (T,), w (F, K/2), scale (F, "
                         f"G), got {tuple(xq.shape)}, {tuple(a.shape)}, "
                         f"{tuple(w.shape)}, {tuple(scale.shape)}")
    t, k = xq.shape
    f, n_groups = w.shape[0], scale.shape[1]
    if 2 * w.shape[1] != k or a.shape[0] != t or scale.shape[0] != f \
            or n_groups == 0 or k % n_groups:
        raise ValueError(f"not a grouped W4A8 product: xq "
                         f"{tuple(xq.shape)}, a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")
    gs = k // n_groups
    if gs % QUANTUM:
        raise ValueError(f"K8 takes groups that are a multiple of {QUANTUM} "
                         f"inputs, got {gs} (K {k}, {n_groups} groups)")
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
    # TMA reads xq and w from 16-byte aligned addresses
    for name, v in (("xq", xq), ("w", w)):
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return gs


def w4a8_group_gemm(xq: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The grouped W4A8 product: same arguments and result as
    `w4a8_group_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous
    int8 xq of at least `MIN_ROWS` rows, an fp32 (T,) a, a uint8 (F, K/2) w
    and a bf16 (F, G) scale whose group K/G is a multiple of `QUANTUM`, and
    ``out_dtype`` fp32 or bf16; they run K8, and anything else raises.
    Each kernel launch adds one to ``w4a8_group_gemm.launches``.
    """
    if xq.device.type == "cpu":
        return w4a8_group_plain(xq, a, w, scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no W4A8 product for device {xq.device}")
    gs = _check(xq, a, w, scale, out_dtype)
    lib = _lib()
    t, k = xq.shape
    f = w.shape[0]
    out = torch.empty((t, f), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.w4a8_group_gemm(xq.data_ptr(), a.data_ptr(), w.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), t, k, f, gs,
                              int(out_dtype == torch.bfloat16), stream)
    _build.check(err, "w4a8_group_gemm")
    _build.count_launch(w4a8_group_gemm)
    return out


w4a8_group_gemm.launches = 0


def quantize_tokens(x: torch.Tensor,
                    amax: Optional[torch.Tensor] = None) -> tuple:
    """Per-token int8 quantization: same arguments and result as
    `quantize_tokens_plain`.

    CPU tensors run the plain version.  A CUDA x (bf16 or fp32, K a
    multiple of 8; made contiguous), with an fp32 (T,) ``amax`` or none,
    runs K8q (which then reads each token's absmax from ``amax`` instead of
    computing it), and anything else raises.  Each kernel launch adds one
    to ``quantize_tokens.launches``.
    """
    if x.device.type == "cpu":
        return quantize_tokens_plain(x, amax)
    if x.device.type != "cuda":
        raise ValueError(f"no token quantization for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K8q takes bf16 or fp32 activations, not {x.dtype}")
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    t = x2.shape[0]
    if k % 8 or t == 0 or t * k >= 2 ** 31:
        raise ValueError(f"K8q takes K a multiple of 8 and T * K under 2^31, "
                         f"got T {t}, K {k}")
    if x2.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if amax is not None:
        amax = amax.reshape(-1)
        if amax.dtype != torch.float32 or amax.shape != (t,) \
                or amax.device != x.device:
            raise ValueError(f"amax must be fp32 ({t},) on {x.device}, got "
                             f"{amax.dtype} {tuple(amax.shape)} on "
                             f"{amax.device}")
        amax = amax.contiguous()
    lib = _lib()
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    a = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.w4a8_quantize_tokens(x2.data_ptr(),
                                   None if amax is None else amax.data_ptr(),
                                   xq.data_ptr(), a.data_ptr(), t, k,
                                   int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "w4a8_quantize_tokens")
    _build.count_launch(quantize_tokens)
    return xq, a


quantize_tokens.launches = 0
