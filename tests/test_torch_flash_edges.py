"""The flash attention's plain versions (``flash_attention_plain`` and
``flash_attention_bwd_plain``, what ``chip_smoke.py`` and the card tests
hold K1 and K2 to) against the JAX package at the shapes the kernels' tiles
meet at their edges, on the CPU in fp32.

K1 walks keys in tiles of 64 for blocks of 128 queries; K2 walks 64-row
tiles for blocks of 128 keys (dK, dV) and of 128 queries (dQ).  So the
shapes here are every head dim at S 63, 65, 127 and 129, a sequence of
2047 and 2049, a whole 64-key tile masked mid-sequence, and rows with no
key to attend.  Up to S 129 (and the masked tile at S 200) the JAX side is
the Pallas kernel in interpret mode with 64-row query blocks and 128-key
blocks, as ``tests/test_torch_ops.py`` runs it; at S 2047 and 2049 it is
``_xla_attention`` and its gradient, so that interpret mode does not take
the suite's time.

Tolerances, as ``tests/test_torch_ops.py``'s: fp32 on both sides differs in
summation order only, so outputs and lse are held to 1e-5 and gradients to
1e-4 of max|ref| against the XLA oracle's; against the Pallas backward the
JAX package's own bar for it, 2e-2 of max|ref|.  A row with no key to
attend outputs 0 and gets gradient 0 in the port (the JAX kernel attends
every key of such a row uniformly), so those rows are held to 0 and the
others to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valley_tpu.ops.flash_attention import (_flash_fwd_impl, _xla_attention,
                                            flash_attention)
from valley_tpu_torch.ops.flash_attention import (HEAD_DIMS,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain)

BLOCK_Q, BLOCK_K = 64, 128
EDGE_S = (63, 65, 127, 129)
# every head dim at every edge: each head dim and each edge once against
# the Pallas kernels (a few seconds each in interpret mode) and the XLA
# gradient, the rest against XLA
PALLAS_EDGES = list(zip(HEAD_DIMS, EDGE_S))
XLA_EDGES = [(d, s) for d in HEAD_DIMS for s in EDGE_S
             if (d, s) not in PALLAS_EDGES]


def _inputs(seed, b, s, h, d, lengths, hole=None):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
            for _ in range(2))
    v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    mask = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    if hole is not None:
        mask[:, hole[0]:hole[1]] = False
    return q, k, v, g, mask


def _port(q, k, v, g, mask, causal):
    """The plain forward (out, lse) and the plain backward fed with them,
    as `FlashAttention` runs them on the CPU."""
    tq, tk, tv, tg, tm = (torch.from_numpy(a) for a in (q, k, v, g, mask))
    out, lse = flash_attention_plain(tq, tk, tv, tm, causal=causal,
                                     return_lse=True)
    grads = flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tg,
                                      causal=causal)
    return out.numpy(), lse.numpy(), [x.numpy() for x in grads]


def _jax_grads(fn, q, k, v, g):
    return jax.grad(lambda *x: jnp.sum(fn(*x) * g), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _pallas(q, k, v, g, mask, causal):
    """The Pallas forward's out and lse, and jax.grad through its Pallas
    backward, in interpret mode."""
    jm = jnp.asarray(mask)
    b, s = mask.shape
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask, jnp.int32).reshape(b, 1, s), causal, BLOCK_Q,
            BLOCK_K)
        grads = _jax_grads(lambda q_, k_, v_: flash_attention(
            q_, k_, v_, kv_mask=jm, causal=causal, block_q=BLOCK_Q,
            block_k=BLOCK_K), q, k, v, g)
    return np.asarray(out), np.asarray(lse)[:, 0], [np.asarray(x)
                                                   for x in grads]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _xla_check(q, k, v, g, mask, causal, out, grads):
    """out within 1e-5 and the gradients within 1e-4 of max|ref| of the
    XLA oracle's."""
    jm = jnp.asarray(mask)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                          causal)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
    want_grads = _jax_grads(lambda q_, k_, v_: _xla_attention(
        q_, k_, v_, jm, causal), q, k, v, g)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert _rel(a, np.asarray(w)) < 1e-4, (name, _rel(a, np.asarray(w)))


@pytest.mark.parametrize("d,s", PALLAS_EDGES)
def test_plain_versions_at_tile_edges_match_the_pallas_kernels(d, s):
    """Head dims at S just under and over the kernels' 64- and 128-row
    tiles, causal at S 63 and 127, two rows of different lengths."""
    causal = s in (63, 127)
    q, k, v, g, mask = _inputs(d + s, 2, s, 2, d, (s, s - 5))
    out, lse, grads = _port(q, k, v, g, mask, causal)
    want_out, want_lse, want_grads = _pallas(q, k, v, g, mask, causal)
    np.testing.assert_allclose(out, want_out, atol=1e-5)
    np.testing.assert_allclose(lse, want_lse, atol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert _rel(a, w) < 2e-2, (name, _rel(a, w))
    _xla_check(q, k, v, g, mask, causal, out, grads)


@pytest.mark.parametrize("d,s", XLA_EDGES)
def test_plain_versions_at_tile_edges_match_xla(d, s):
    """The other head dims and edges, against the XLA oracle and its
    gradient."""
    causal = s in (63, 127)
    q, k, v, g, mask = _inputs(d + s, 2, s, 2, d, (s, s - 5))
    out, _, grads = _port(q, k, v, g, mask, causal)
    _xla_check(q, k, v, g, mask, causal, out, grads)


@pytest.mark.parametrize("s,d,lengths", [(2047, 128, (2047,)),
                                         (2049, 64, (2049,)),
                                         (2048, 128, (1990,))])
def test_plain_versions_at_long_sequences_match_xla(s, d, lengths):
    """S 2047 and 2049 (the training's 2048 one key either side), and 2048
    with stage 2's masked tail, causal, against the XLA oracle and its
    gradient."""
    q, k, v, g, mask = _inputs(s, 1, s, 2, d, lengths)
    out, _, grads = _port(q, k, v, g, mask, True)
    _xla_check(q, k, v, g, mask, True, out, grads)


def test_a_masked_key_tile_mid_sequence_matches_the_pallas_kernels():
    """Keys 64-191 masked in every row, causal: whole tiles the kernels
    skip, and the rows 64-191 of the first that attend keys 0-63 only."""
    q, k, v, g, mask = _inputs(7, 2, 200, 2, 64, (200, 170), (64, 192))
    out, lse, grads = _port(q, k, v, g, mask, True)
    want_out, want_lse, want_grads = _pallas(q, k, v, g, mask, True)
    np.testing.assert_allclose(out, want_out, atol=1e-5)
    np.testing.assert_allclose(lse, want_lse, atol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert _rel(a, w) < 2e-2, (name, _rel(a, w))
    # the masked keys get no gradient
    assert np.all(grads[1][:, 64:192] == 0) and np.all(grads[2][:, 64:192]
                                                      == 0)


def test_rows_with_no_key_are_zero_and_the_others_match_the_pallas_kernels():
    """Batch rows 0 and 2 attend no key; row 1 all of its 129."""
    q, k, v, g, mask = _inputs(8, 3, 129, 2, 64, (0, 129, 0))
    out, _, grads = _port(q, k, v, g, mask, True)
    for x in [out] + grads:
        assert np.all(x[0] == 0) and np.all(x[2] == 0)
    q1, k1, v1, g1, m1 = (a[1:2] for a in (q, k, v, g, mask))
    want_out, _, want_grads = _pallas(q1, k1, v1, g1, m1, True)
    np.testing.assert_allclose(out[1:2], want_out, atol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert _rel(a[1:2], w) < 2e-2, (name, _rel(a[1:2], w))
