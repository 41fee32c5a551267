"""Flash attention: the CUDA forward (K1, ``csrc/flash_fwd.cu``) and
backward (K2, ``csrc/flash_bwd.cu``) kernels, their plain PyTorch versions,
the wrappers that run one or the other, and `FlashAttention`, the autograd
function that joins them.

Counterpart of ``valley_tpu/ops/flash_attention.py`` (the Pallas
``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``, and their oracle
``_xla_attention``).  Each wrapper takes the plain version for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from valley_tpu_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None, *,
                          causal: bool = False, return_lse: bool = False):
    """fp32 softmax(QK^T d^-1/2)V with the kernel's semantics.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D); kv_mask: (B, Sk) bool, True =
    attend (None = all).  Everything runs in fp32, as the kernel keeps P in
    fp32 for PV; the output takes q's dtype.  A row with no key to attend
    outputs 0.  With ``return_lse`` also returns the (B*H, Sq) fp32
    logsumexp.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if kv_mask is None:
        kv_mask = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    mask = kv_mask.to(torch.bool)[:, None, None, :]
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        mask = mask & cm.tril(sk - sq)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / denom, v.float()).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom)).reshape(b * h, sq)
    return out


@functools.cache
def _kernel():
    fn = _build.load("flash_fwd").flash_fwd_bf16
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_bwd").flash_bwd_bf16
    vp = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                   i, i, i, i, i, i, ctypes.c_float, vp]
    fn.restype = i
    return fn


def _check(q, k, v, kv_mask, causal):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, H, D) and k/v (B, Sk, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError("k/v batch, heads and head_dim must equal q's "
                         "(repeat GQA heads before the call)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if causal and sq != k.shape[1]:
        raise ValueError("causal flash attention needs Sq == Sk")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or kv_mask.shape != (b, k.shape[1]):
            raise ValueError(f"kv_mask must be bool (B, Sk), got "
                             f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
        if kv_mask.device != q.device or kv_mask.stride(1) != 1:
            raise ValueError("kv_mask must lie on q's device with unit "
                             "stride along Sk")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, return_lse: bool = False):
    """Fused prefill attention.  Same arguments and result as
    `flash_attention_plain`; q/k/v must have equal head counts.

    CPU tensors run the plain version.  CUDA tensors must be contiguous
    bf16 with head_dim 16, 32, 64 or 128 and run the kernel; anything else
    raises.
    Each kernel launch adds one to ``flash_attention.launches``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal=causal,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    _check(q, k, v, kv_mask, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if kv_mask is None:
        kv_mask = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_mask.data_ptr(), kv_mask.stride(0), out.data_ptr(),
                    lse.data_ptr(), b, h, sq, sk, d, int(causal), d ** -0.5,
                    stream)
    _build.check(err, "flash_fwd_bf16")
    _build.count_launch(flash_attention)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, laid out (B*H, Sq) like the lse."""
    b, sq, h, _ = out.shape
    d = (dout.float() * out.float()).sum(dim=-1)          # (B, Sq, H)
    return d.transpose(1, 2).reshape(b * h, sq).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor],
                              out: torch.Tensor, lse: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool = False):
    """The backward kernel's formulas written out in fp32: not autograd of
    the forward, but P recomputed from the forward's (B*H, Sq) ``lse``,
    delta = rowsum(dO * O), dS = P * (dP - delta) * d^-1/2.  The mask is a
    predicate (P = 0 where a key is masked), so fully masked rows give 0.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    if kv_mask is None:
        kv_mask = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    mask = kv_mask.to(torch.bool)[:, None, None, :]
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        mask = mask & cm.tril(sk - sq)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(b, h, sq, 1)), 0.0)
    delta = attention_delta(out, dout).reshape(b, h, sq, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = False):
    """Fused attention backward.  Same arguments and result as
    `flash_attention_bwd_plain`: ``out`` and ``lse`` are what the forward
    returned, ``dout`` the gradient of ``out``.

    CPU tensors run the plain version.  CUDA tensors take the forward
    kernel's checks, plus bf16 contiguous ``out``/``dout`` shaped like q and
    a contiguous fp32 (B*H, Sq) ``lse``; they run the kernel (delta is a
    PyTorch reduction, as the JAX package leaves it to XLA), and anything
    else raises.  Each kernel launch adds one to
    ``flash_attention_bwd.launches``.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout,
                                         causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward for device "
                         f"{q.device}")
    _check(q, k, v, kv_mask, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on q's device")
    if lse.dtype != torch.float32 or lse.shape != (b * h, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 (B*H, Sq) on q's "
                         f"device, got {lse.dtype} {tuple(lse.shape)}")
    if kv_mask is None:
        kv_mask = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    delta = attention_delta(out, dout)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        kv_mask.data_ptr(), kv_mask.stride(0), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
                        int(causal), d ** -0.5, stream)
    _build.check(err, "flash_bwd_bf16")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """softmax(QK^T d^-1/2)V under autograd: `flash_attention` forward
    (K1, keeping its lse), `flash_attention_bwd` backward (K2), as the
    JAX package's ``custom_vjp`` pairs its two kernels.  On CPU tensors both
    directions run their plain versions; on CUDA tensors both launch their
    kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out, lse = flash_attention(q, k, v, kv_mask, causal=causal,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             kv_mask: Optional[torch.Tensor] = None, *,
                             causal: bool = False) -> torch.Tensor:
    """`flash_attention` with a gradient: `FlashAttention.apply`."""
    return FlashAttention.apply(q, k, v, kv_mask, causal)
