"""The decode GEMVs: the bf16 GEMV (K6, ``csrc/bf16_matvec.cu``) with its
plain PyTorch version, and `matvec`, which picks the GEMV of a weight's
storage: K6 for bf16, the int8 GEMV (K4) for int8 and the grouped-int4
GEMV (K5) for nibble-packed uint8 (both in ``ops/quant.py``).

K6 replaces the Pallas bf16 GEMVs of ``tools/exp_pallas_gemv.py``
(``matvec``, x (rows, H) @ w (H, F) -> fp32) and
``tools/exp_pallas_gemv2.py`` (``matvec_vpu``, the same at one row;
``matvec_vpu_bf16acc``, each product rounded to bf16 before the fp32 sum,
K6's ``round_products`` variant).  It takes w in either layout: (F, K), as
the decoder stores its projections, or (K, F) (``kf=True``), the tools'
own layout and the bf16 ``lm_head``'s.  It has no backward: on a CUDA
tensor that requires grad it raises, and `llama._linear` sends it only
products that track no gradient.

Each wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops.quant import (MAX_ROWS, int4_matvec,
                                        int4_matvec_plain, int8_matvec,
                                        int8_matvec_plain)


def bf16_matvec_plain(x: torch.Tensor, w: torch.Tensor, kf: bool = False,
                      round_products: bool = False) -> torch.Tensor:
    """y[..., o] = sum_k x[..., k] w[o, k] (``kf``: w[k, o]) in fp32.

    x: (..., K) bf16; w: (F, K), or (K, F) with ``kf``.  Returns (..., F)
    fp32: ``x.float() @ w.float().T`` (``@ w.float()``).  With
    ``round_products`` each product is rounded to bf16 and the rounded
    products are summed in fp32, as ``matvec_vpu_bf16acc``
    (tools/exp_pallas_gemv2.py:69-71) does, one row of x at a time."""
    wf = w.float() if kf else w.float().t()          # (K, F)
    xf = x.float()
    if not round_products:
        return xf @ wf
    flat = xf.reshape(-1, xf.shape[-1])
    rows = [(r[:, None] * wf).bfloat16().float().sum(dim=0) for r in flat]
    return torch.stack(rows).reshape(x.shape[:-1] + (wf.shape[1],))


@functools.cache
def _lib():
    """The built K6 library, its row limit checked against `MAX_ROWS`."""
    lib = _build.load("bf16_matvec")
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.bf16_matvec.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    lib.bf16_matvec.restype = i
    lib.bf16_matvec_max_rows.restype = i
    lib.max_rows = lib.bf16_matvec_max_rows()
    if lib.max_rows != MAX_ROWS:
        raise RuntimeError(f"bf16_matvec.cu serves {lib.max_rows} rows, "
                           f"ops/quant.py expects {MAX_ROWS}")
    return lib


def _check(x, w, kf: bool, max_rows: int) -> tuple:
    """K6's argument checks; returns (B, K, F)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"bf16 matvec takes bf16 x and w, got {x.dtype}, "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"want x (B, K) and w {'(K, F)' if kf else '(F, K)'}"
                         f", got {tuple(x.shape)}, {tuple(w.shape)}")
    b, k = x.shape
    f = w.shape[1] if kf else w.shape[0]
    if (w.shape[0] if kf else w.shape[1]) != k:
        raise ValueError(f"x (B, {k}) against w {tuple(w.shape)} "
                         f"({'(K, F)' if kf else '(F, K)'})")
    if not 1 <= b <= max_rows:
        raise ValueError(f"bf16 matvec takes 1..{max_rows} rows, got {b}")
    if not kf and k % 8:
        raise ValueError(f"bf16 matvec on an (F, K) weight needs K a "
                         f"multiple of 8 (16-byte loads), got {k}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError("bf16 matvec has no backward: call it on tensors "
                         "that track no gradient")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, k, f


def bf16_matvec(x: torch.Tensor, w: torch.Tensor, kf: bool = False,
                round_products: bool = False) -> torch.Tensor:
    """x @ w^T (``kf``: x @ w) for a few rows of a bf16 weight: same
    arguments and result as `bf16_matvec_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous,
    16-byte aligned bf16 x of at most `MAX_ROWS` rows and w (an (F, K) w
    with K a multiple of 8), neither tracking a gradient; they run the
    kernel, and anything else raises.  Each kernel launch adds one to
    ``bf16_matvec.launches``.
    """
    if x.device.type == "cpu":
        return bf16_matvec_plain(x, w, kf, round_products)
    if x.device.type != "cuda":
        raise ValueError(f"no bf16 matvec for device {x.device}")
    lib = _lib()
    b, k, f = _check(x, w, kf, lib.max_rows)
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bf16_matvec(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, k, f,
                          int(kf), int(round_products), stream)
    _build.check(err, "bf16_matvec")
    _build.count_launch(bf16_matvec)
    return out


bf16_matvec.launches = 0


def matvec(x: torch.Tensor, w: torch.Tensor, scale=None,
           kf: bool = False) -> torch.Tensor:
    """The decode GEMV of w's storage, (B <= `MAX_ROWS`, K) rows to (B, F)
    fp32: `bf16_matvec` (K6) for a bf16 w, (F, K) or with ``kf`` (K, F);
    `int4_matvec` (K5) for a packed uint8 (F, K/2) w with its (F, G) or
    (F,) scale; `int8_matvec` (K4) for an int8 (F, K) w with its (F,)
    scale."""
    if w.dtype == torch.bfloat16:
        return bf16_matvec(x, w, kf)
    if kf:
        raise ValueError(f"a {w.dtype} weight is stored (F, K), not (K, F)")
    if w.dtype == torch.uint8:
        return int4_matvec(x, w, scale)
    if w.dtype == torch.int8:
        return int8_matvec(x, w, scale)
    raise TypeError(f"no decode GEMV for a {w.dtype} weight")


def matvec_plain(x: torch.Tensor, w: torch.Tensor, scale=None,
                 kf: bool = False) -> torch.Tensor:
    """`matvec`'s plain version: `bf16_matvec_plain`, `int4_matvec_plain`
    or `int8_matvec_plain` by w's storage."""
    if w.dtype == torch.bfloat16:
        return bf16_matvec_plain(x, w, kf)
    if kf:
        raise ValueError(f"a {w.dtype} weight is stored (F, K), not (K, F)")
    if w.dtype == torch.uint8:
        return int4_matvec_plain(x, w, scale)
    if w.dtype == torch.int8:
        return int8_matvec_plain(x, w, scale)
    raise TypeError(f"no decode GEMV for a {w.dtype} weight")
