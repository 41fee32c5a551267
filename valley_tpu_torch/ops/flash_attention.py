"""Prefill attention: the CUDA flash kernel (``csrc/flash_fwd.cu``), its
plain PyTorch version, and the wrapper that runs one or the other.

Counterpart of ``valley_tpu/ops/flash_attention.py`` (the Pallas
``_fwd_kernel`` and its oracle ``_xla_attention``).  The wrapper takes the
plain version for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
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
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
