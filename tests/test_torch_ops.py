"""Attention and rotary ops of the PyTorch port against the JAX package, on
the CPU.  The same numpy inputs go through both; the JAX Pallas kernels run
in interpret mode, as the JAX package's own tests run them.

Tolerances: fp32 on both sides differs only in summation order (~1e-6 on
O(1) values), so fp32 parity is held to 1e-5.  Against the Pallas decode
kernel with a bf16 cache the bar is that kernel's own test tolerance, 2e-2:
the kernel rounds unnormalised probabilities to bf16 per block, the plain
version rounds normalised ones.  Attention gradients are held to the JAX
package's own bar for its flash backward against the Pallas kernel
(max|diff| < 2e-2 * max|ref|, tests/test_flash_attention.py), and to 1e-4
of max|ref| against ``jax.grad`` of the XLA oracle (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valley_tpu.ops import attention as jattn
from valley_tpu.ops import rope as jrope
from valley_tpu.ops.decode_pallas import decode_attention_stacked as jdecode
from valley_tpu.ops.flash_attention import _xla_attention, flash_attention
from valley_tpu_torch.ops import attention, rope
from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.flash_attention import (FlashAttention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain,
                                                  flash_attention as
                                                  flash_wrapper)

# TF32 off, so fp32 matmuls stay fp32 wherever these run on a card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _qkv(rng, b, s, h, d, sk=None):
    sk = sk or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5,
            rng.standard_normal((b, sk, h, d)).astype(np.float32) * 0.5,
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block_q,block_k", [
    (128, 256, 512),     # one block, padded-tail mask
    (200, 64, 128),      # ragged S streamed over several K blocks
])
def test_flash_plain_matches_jax_kernel(causal, s, block_q, block_k):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, s, 2, 64)
    mask = np.ones((2, s), bool)
    mask[0, s - 23:] = False
    with pltpu.force_tpu_interpret_mode():
        want = flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_mask=jnp.asarray(mask),
                               causal=causal, block_q=block_q,
                               block_k=block_k)
    oracle = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), causal)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(mask),
                                causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), atol=1e-5)


def test_flash_plain_lse_matches_jax_kernel():
    from valley_tpu.ops.flash_attention import _flash_fwd_impl

    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 96, 2, 64)
    mask = np.ones((1, 96), bool)
    mask[0, 80:] = False
    with pltpu.force_tpu_interpret_mode():
        _, want = _flash_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask, jnp.int32).reshape(1, 1, 96), True, 256, 512)
    _, got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(mask), causal=True,
                                   return_lse=True)
    np.testing.assert_allclose(_np(got), np.asarray(want)[:, 0], atol=1e-5)


def test_flash_fully_masked_row_outputs_zero():
    """A row with no key to attend outputs 0 (the kernel's 1e-30 clamp);
    every other row still matches the oracle."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 2, 32)
    mask = np.ones((2, 64), bool)
    mask[1] = False
    got = _np(flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(mask)))
    assert np.all(got[1] == 0.0)
    oracle = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), False)
    np.testing.assert_allclose(got[0], np.asarray(oracle)[0], atol=1e-5)


def test_flash_wrapper_on_cpu_is_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 40, 2, 16))
    before = flash_wrapper.launches
    got = flash_wrapper(q, k, v, None, causal=True)
    want = flash_attention_plain(q, k, v, None, causal=True)
    assert torch.equal(got, want)
    assert flash_wrapper.launches == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_wrapper(q, q, q, None)
    cache = torch.zeros((1, 1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        decode_attention_stacked(q[:, :1], cache, cache, 0,
                                 torch.ones((1, 8), dtype=torch.bool))


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _port_grads(fn, arrays, g):
    """Gradients of sum(fn(q, k, v) * g) through the port's autograd."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)


def _jax_grads(fn, arrays, g):
    return jax.grad(lambda *x: jnp.sum(fn(*x) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("causal,s,block_q,block_k", [
    (True, 128, 256, 512),    # one block, masked tail
    (False, 128, 256, 512),
    (True, 200, 64, 128),     # ragged S over several Q and K blocks
])
def test_flash_autograd_grads_match_jax(causal, s, block_q, block_k):
    """`FlashAttention` (on the CPU: plain forward with its lse, then the
    backward's formulas) against jax.grad of the JAX flash attention, its
    Pallas backward in interpret mode, and of the XLA oracle."""
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, 2, s, 2, 64)
    g = rng.standard_normal(q.shape).astype(np.float32)
    mask = np.ones((2, s), bool)
    mask[0, s - 29:] = False
    jmask = jnp.asarray(mask)
    got = _port_grads(lambda q_, k_, v_: FlashAttention.apply(
        q_, k_, v_, torch.from_numpy(mask), causal), (q, k, v), g)
    with pltpu.force_tpu_interpret_mode():
        kern = _jax_grads(lambda q_, k_, v_: flash_attention(
            q_, k_, v_, kv_mask=jmask, causal=causal, block_q=block_q,
            block_k=block_k), (q, k, v), g)
    oracle = _jax_grads(lambda q_, k_, v_: _xla_attention(
        q_, k_, v_, jmask, causal), (q, k, v), g)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, kern, oracle):
        assert _rel_err(a, b) < 2e-2, (name, _rel_err(a, b))
        assert _rel_err(a, c) < 1e-4, (name, _rel_err(a, c))


def test_gqa_prefill_grads_match_jax():
    """GQA through `prefill_attention`: the kv heads are repeated before
    `FlashAttention`, and their gradients summed back over each group."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 48, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    mask = np.ones((2, 48), bool)
    mask[1, 40:] = False
    got = _port_grads(lambda q_, k_, v_: attention.prefill_attention(
        q_, k_, v_, torch.from_numpy(mask), causal=True), (q, k, v), g)
    bias = jnp.where(jnp.asarray(mask)[:, None, None, :], 0.0, -1e9)
    want = _jax_grads(lambda q_, k_, v_: jattn.mha_attention(
        q_, k_, v_, bias, causal=True, use_flash=False), (q, k, v), g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) < 1e-4, (name, _rel_err(a, b))


def test_flash_bwd_fully_masked_rows_are_zero():
    """Rows with no key to attend have an lse near -1e9; the mask is a
    predicate, so their gradients are 0, not inf * 0."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 64, 2, 32))
    mask = torch.ones((2, 64), dtype=torch.bool)
    mask[1] = False
    mask[0, 50:] = False
    out, lse = flash_attention_plain(q, k, v, mask, return_lse=True)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, g)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all())
        assert bool((t[1] == 0).all())
    assert bool((dk[0, 50:] == 0).all()) and bool((dv[0, 50:] == 0).all())
    assert float(dq[0].abs().max()) > 0


def test_flash_bwd_wrapper_on_cpu_is_plain_and_counts_nothing():
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 40, 2, 16))
    out, lse = flash_attention_plain(q, k, v, None, causal=True,
                                     return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, None, out, lse, out, causal=True)
    want = flash_attention_bwd_plain(q, k, v, None, out, lse, out,
                                     causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == before
    meta = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention_bwd(meta, meta, meta, None, meta,
                            torch.zeros((2, 8), device="meta"), meta)


def _decode_inputs(rng, b, s, h, hkv, d, n_layers=3):
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((n_layers, b, s, hkv, d)).astype(np.float32) * .5
    v = rng.standard_normal((n_layers, b, s, hkv, d)).astype(np.float32) * .5
    # a prompt of 3/4 of the first half, a hole up to the half (the bucket
    # padding), then decoded slots: the cache state of a decode step
    valid = np.zeros((b, s), bool)
    valid[:, :3 * s // 8] = True
    valid[:, s // 2:s // 2 + s // 4] = True
    return q, k, v, valid


# the geometries of tests/test_decode_kernel.py, all with a bf16 cache
@pytest.mark.parametrize("geo", [
    (1, 96, 4, 4, 32), (1, 96, 4, 2, 32), (2, 640, 8, 8, 128),
    (1, 3000, 4, 4, 128)])
def test_decode_plain_matches_jax_kernel_bf16(geo):
    b, s, h, hkv, d = geo
    rng = np.random.default_rng(4)
    q, k, v, valid = _decode_inputs(rng, b, s, h, hkv, d)
    li = 1
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = jdecode(qb, kb, vb, li, jnp.asarray(valid))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = decode_attention_plain(tq, tk, tv, li, torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16 and got.shape == (b, 1, h, d)
    err = np.abs(_np(got) - np.asarray(want, np.float32)).max()
    assert err < 2e-2, err
    # against the XLA oracle the algorithm is the same: one bf16 rounding
    oracle = jattn.decode_attention(qb, kb[li], vb[li], jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), np.asarray(oracle, np.float32),
                               atol=2 ** -7)


@pytest.mark.parametrize("geo", [(1, 96, 4, 2, 32), (2, 130, 8, 8, 16)])
def test_decode_plain_matches_jax_oracle_fp32(geo):
    b, s, h, hkv, d = geo
    rng = np.random.default_rng(5)
    q, k, v, valid = _decode_inputs(rng, b, s, h, hkv, d)
    li = 2
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k[li]),
                                  jnp.asarray(v[li]), jnp.asarray(valid))
    got = decode_attention_stacked(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), li,
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    per_layer = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[li]), torch.from_numpy(v[li]),
        torch.from_numpy(valid))
    assert torch.equal(per_layer, got)


@pytest.mark.parametrize("causal,with_bias,hkv", [
    (True, True, 4), (False, False, 2), (True, False, 1)])
def test_mha_attention_matches_jax(causal, with_bias, hkv):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, hkv, 16)).astype(np.float32)
    bias = None
    if with_bias:
        m = np.ones((2, 12), bool)
        m[1, 9:] = False
        bias = np.where(m[:, None, None, :], 0.0, -1e9).astype(np.float32)
    want = jattn.mha_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal=causal,
        use_flash=False)
    got = attention.mha_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_prefill_attention_repeats_gqa_heads():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 10, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 10, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 10, 2, 16)).astype(
        np.float32))
    got = attention.prefill_attention(q, k, v, None, causal=True)
    want = attention.mha_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scaling", [1.0, 2.0])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 64, (2, 7))
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, scaling)
    tc, ts = rope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, scaling)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=1e-5)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = rope.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_rope_keeps_bf16_dtype():
    x = torch.randn((1, 4, 2, 8), generator=torch.Generator().manual_seed(0))
    c, s = rope.rope_cos_sin(torch.arange(4)[None], 8)
    assert rope.apply_rope(x.bfloat16(), c, s).dtype == torch.bfloat16


def test_rms_norm_matches_jax():
    from valley_tpu.models import llama as jllama
    from valley_tpu_torch.models import llama

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal((32,)).astype(np.float32)
    want = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    # bf16: the normed value is rounded to bf16 before the weight multiplies
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jllama.rms_norm(xb, jnp.asarray(w, jnp.bfloat16), 1e-6)
    got = llama.rms_norm(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
