"""LLaMA decoder (LLaMA-1/2, Vicuna), the PyTorch counterpart of
``valley_tpu/models/llama.py``.

Weights keep the JAX package's stacked layout: every per-layer tensor has a
leading layer axis, projections are stored (L, out, in) and ``lm_head``
(in, out), so converting a JAX tree is a dtype and device copy.  The KV
cache is the same stacked (L, B, Smax, Hkv, D) buffer; this port writes it
in place.  RMSNorm, rotary and softmax run in fp32 exactly where the JAX
package runs them.

Ported: the cacheless forward (training, with full per-layer
rematerialisation as an option), bucketed prefill at ``cache_index`` 0 and
single-token decode over the stacked cache, for one stream (B = 1).  Not
ported yet, and refused with NotImplementedError: the ``"dots"`` remat
policy, the ``cross_valid`` extend branch, batched (B > 1) cached
inference, per-row cache slots, quantized or fused projections and LoRA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from valley_tpu_torch.config import TextConfig
from valley_tpu_torch.models import Weights
from valley_tpu_torch.ops.attention import KERNELS, Attention, \
    prefill_attention
from valley_tpu_torch.ops.rope import apply_rope, rope_cos_sin


class LlamaLayers(Weights):
    NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
             "w_up", "w_down")


class LlamaWeights(Weights):
    NAMES = ("embed", "layers", "final_norm", "lm_head")


@dataclass
class KVCache:
    """Stacked KV cache, updated in place by `forward_hidden`."""
    k: torch.Tensor   # (L, B, Smax, Hkv, D)
    v: torch.Tensor   # (L, B, Smax, Hkv, D)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: TextConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_heads,
             cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


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


def _qkv(lp: LlamaLayers, li: int, x: torch.Tensor, cfg: TextConfig, cos,
         sin):
    b, s, _ = x.shape
    q = F.linear(x, lp["wq"][li]).reshape(b, s, cfg.num_attention_heads,
                                          cfg.head_dim)
    k = F.linear(x, lp["wk"][li]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = F.linear(x, lp["wv"][li]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(lp: LlamaLayers, li: int, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(F.linear(x, lp["w_gate"][li]).to(torch.float32))
    up = F.linear(x, lp["w_up"][li]).to(torch.float32)
    return F.linear((gate * up).to(x.dtype), lp["w_down"][li])


def _attn(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention):
    """Cacheless causal self-attention over the block."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin)
    mask = None if attn_mask is None else attn_mask > 0
    out = prefill_attention(q, k, v, mask, causal=True, attention=attention)
    return F.linear(out.reshape(b, s, h), lp["wo"][li])


def _layer(lp, li, x, cfg, cos, sin, attn_mask, attention: Attention):
    """One cacheless decoder layer (llama.py:526-535)."""
    eps = cfg.rms_norm_eps
    x = x + _attn(lp, li, rms_norm(x, lp["attn_norm"][li], eps), cfg, cos,
                  sin, attn_mask, attention)
    return x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps))


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


def _attn_cached(lp, li, x, cfg, cos, sin, cache: KVCache, cache_index: int,
                 kv_valid, attention: Attention):
    """Write this chunk's K/V into layer ``li`` of the cache at slot
    ``cache_index``, then attend: one token against the whole cache, or a
    prefill chunk causally within itself (the cache beyond the chunk is
    empty: the engine prefills at slot 0)."""
    b, s, h = x.shape
    q, k, v = _qkv(lp, li, x, cfg, cos, sin)
    if cache_index + s > cache.max_len:
        raise ValueError(f"writing {s} slots at {cache_index} overruns a "
                         f"cache of {cache.max_len}")
    cache.k[li, :, cache_index:cache_index + s] = k
    cache.v[li, :, cache_index:cache_index + s] = v
    if s == 1:
        if kv_valid is None:
            raise ValueError("decode needs the (B, Smax) kv_valid mask")
        out = attention.decode(q, cache.k, cache.v, li, kv_valid)
    else:
        chunk_valid = kv_valid[:, :s] if kv_valid is not None else None
        out = prefill_attention(q, k, v, chunk_valid, causal=True,
                                attention=attention)
    return F.linear(out.reshape(b, s, h), lp["wo"][li])


def forward_hidden(params: LlamaWeights, cfg: TextConfig,
                   inputs_embeds: torch.Tensor,
                   attn_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[KVCache] = None,
                   cache_index: int = 0,
                   kv_valid: Optional[torch.Tensor] = None,
                   cross_valid: Optional[torch.Tensor] = None,
                   attention: Attention = KERNELS, remat=False):
    """Run the decoder stack.  Returns (hidden, cache_or_None).

    inputs_embeds: (B, S, H).  attn_mask: (B, S) padding mask of the
    cacheless path.  positions: (B, S) rotary positions (default arange,
    plus ``cache_index`` with a cache).  With a cache, the chunk is written
    at slot ``cache_index`` and ``kv_valid`` (B, Smax) marks attendable
    slots.  ``attention`` picks the kernels (default) or their plain
    versions.  ``remat`` (cacheless path only): True/"full" wraps each
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
        if b != 1:
            raise NotImplementedError(
                "batched (B > 1) cached inference is not ported yet: the "
                "port serves one stream")
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            raise NotImplementedError("per-row cache slots are not ported")
        cache_index = int(cache_index)
    if positions is None:
        base = torch.arange(s, device=inputs_embeds.device)
        if cache is not None:
            base = base + cache_index
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
        x = x + _mlp(lp, li, rms_norm(x, lp["mlp_norm"][li], eps))
    return rms_norm(x, params["final_norm"], eps), cache


def logits_from_hidden(params: LlamaWeights, hidden: torch.Tensor
                       ) -> torch.Tensor:
    """fp32 logits (llama.py:787): the product in the weights' dtype, then
    cast."""
    return (hidden @ params["lm_head"]).to(torch.float32)


def forward(params: LlamaWeights, cfg: TextConfig,
            inputs_embeds: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            attention: Attention = KERNELS, remat=False) -> torch.Tensor:
    """Cacheless forward: (B, S, H) -> fp32 logits (B, S, V)."""
    hidden, _ = forward_hidden(params, cfg, inputs_embeds, attn_mask,
                               attention=attention, remat=remat)
    return logits_from_hidden(params, hidden)
