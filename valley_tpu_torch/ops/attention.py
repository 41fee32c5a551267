"""Attention ops: plain PyTorch counterparts of ``valley_tpu/ops/attention.py``
and the choice between the CUDA kernels and their plain versions.

`mha_attention` and `decode_attention` are the plain functions the JAX
package falls back to (CLIP attention always runs `mha_attention`, as the
JAX tower forces ``use_flash=False``).  The LLaMA decoder reaches its
kernels through an `Attention` choice instead: `KERNELS` (the default)
holds the prefill attention with the flash kernels in both directions
(`FlashAttention`: K1 forward, K2 backward), the decode kernel's wrapper
(K3, bf16 or int8 cache) and the decode GEMVs' (`ops.matvec.matvec`: the
bf16 GEMV K6, the int8 GEMV K4 and the grouped-int4 GEMV K5 by the
weight's storage), the projections of a few rows, which take their plain
versions for tensors on the CPU and launch the kernels for CUDA tensors; `PLAIN` holds the plain versions themselves, differentiated by
autograd, for comparing a run on the card with the kernels against one
without.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.flash_attention import (flash_attention_autograd,
                                                  flash_attention_plain)
from valley_tpu_torch.ops.matvec import matvec, matvec_plain


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) for grouped-query attention."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  causal: bool = False) -> torch.Tensor:
    """Plain multi-head attention.

    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D); bias: broadcastable to
    (B, H, Sq, Sk), additive in fp32.  fp32 logits and softmax,
    probabilities cast to v's dtype before PV, fp32 accumulation; returns
    (B, Sq, H, D) in q's dtype.
    """
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, -1e9)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length_mask: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain single-token attention against one layer's (B, Smax, Hkv, D)
    cache; ``length_mask`` (B, Smax) bool marks valid slots.  With an int8
    cache, ``k_scale``/``v_scale`` (B, Smax, Hkv) multiply the logits and
    the probabilities, never the cache values."""
    scales = [None if s is None else s[None] for s in (k_scale, v_scale)]
    return decode_attention_plain(q, k_cache[None], v_cache[None], 0,
                                  length_mask, *scales)


class Attention(NamedTuple):
    """The kernels of the LLaMA decoder's paths, or their plain versions.

    prefill(q, k, v, kv_mask, causal=...) with equal head counts;
    decode(q, k_all, v_all, li, valid, k_scale=None, v_scale=None) over
    the stacked cache; matvec(x, w, scale=None, kf=False) the GEMV of (B
    <= ``quant.MAX_ROWS``, K) rows against a bf16 weight, (F, K) or (K, F)
    with ``kf``, an (F, K) int8 weight with an (F,) scale, or an (F, K/2)
    packed int4 one with (F, G) group or (F,) channel scales, chosen by
    w's dtype.
    """
    prefill: Callable[..., torch.Tensor]
    decode: Callable[..., torch.Tensor]
    matvec: Callable[..., torch.Tensor]


KERNELS = Attention(flash_attention_autograd, decode_attention_stacked,
                    matvec)
PLAIN = Attention(flash_attention_plain, decode_attention_plain,
                  matvec_plain)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: Optional[torch.Tensor], *, causal: bool,
                      attention: Attention = KERNELS) -> torch.Tensor:
    """Causal prefill attention with a (B, Sk) validity mask: GQA heads
    repeated, then ``attention.prefill``."""
    n_rep = q.shape[2] // k.shape[2]
    return attention.prefill(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                             kv_mask, causal=causal)
