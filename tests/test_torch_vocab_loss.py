"""The cross entropy over the vocabulary shares of the PyTorch port
(`TensorParallel.cross_entropy`, `valley.shifted_cross_entropy` with
``tp``) against the gathered log-softmax loss: world 1's
`valley.shifted_cross_entropy` over the whole logits, and the JAX
package's ``shifted_cross_entropy`` (valley.py:148-160) and its gradient.

The ranks are gloo processes of tests/torch_mp_worker.py over a file store
in the test's tmp directory, one CPU thread each, worlds (1, 1, 2) and
(1, 1, 4) spawned at once; each takes its vocabulary columns of the same
(B, S, V) fp32 logits (numpy, from a seed), computes the loss over the
shares and its backward, and every rank's gradient of its columns reaches
rank 0.  The cases: labels with ignored positions (``IGNORE_INDEX``: a
whole row's tail and scattered ones), labels that fall in every rank's
share of the vocabulary at every world, and every label ignored.

Bars: the loss within 1e-6 (relative) and every logit's gradient within
2e-6 of the largest |gradient| of world 1's and of JAX's (read: the loss
at most 1.4e-7 apart, the gradients 4.5e-7 of the largest; fp32
rounding: the max, the sum of exps and the target's logit are reduced
over the ranks, in another order than one device's log-softmax).  The whole-row gradient,
joined from the ranks' columns, has the shape of the logits; no rank's
gradient is wider than its share.  The file takes about 10 s on its
worker alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel_train import _spawn, _wait
from valley_tpu.models import valley as jvalley
from valley_tpu_torch.constants import IGNORE_INDEX
from valley_tpu_torch.models import valley

MESHES = [(1, 1, 2), (1, 1, 4)]
B, S, V = 3, 17, 512
CASES = ["ignored", "every_share", "all_ignored"]
LOSS_RTOL = 1e-6
GRAD_BAR = 2e-6


def _case(name: str):
    rng = np.random.default_rng(41)
    logits = (rng.standard_normal((B, S, V)) * 4.0).astype(np.float32)
    if name == "ignored":
        labels = rng.integers(0, V, (B, S))
        labels[0, 10:] = IGNORE_INDEX
        labels[rng.random((B, S)) < 0.2] = IGNORE_INDEX
    elif name == "every_share":
        # each quarter of the vocabulary (each rank's share at four ranks,
        # two at two) holds targets of every row
        labels = (np.arange(B * S).reshape(B, S) * (V // 4 + 7)) % V
    else:
        labels = np.full((B, S), IGNORE_INDEX)
    return logits, labels.astype(np.int64)


def _world_1(logits, labels):
    """The gathered loss: `valley.shifted_cross_entropy` over the whole
    logits, and its gradient."""
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = valley.shifted_cross_entropy(x, torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


def _jax(logits, labels):
    loss, grad = jax.value_and_grad(jvalley.shifted_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    return float(loss), np.asarray(grad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results, world 1's and JAX's beside them."""
    tmp = tmp_path_factory.mktemp("vocabce")
    cases = {c: _case(c) for c in CASES}
    scenarios = [{"name": c, "kind": "vocab_ce", "logits": lg,
                  "labels": lb} for c, (lg, lb) in cases.items()]
    spawned = [_spawn(tmp, mesh, {"base": None}, {"main": [{}]}, scenarios)
               for mesh in MESHES]
    refs = {c: {"local": _world_1(*cases[c]), "jax": _jax(*cases[c])}
            for c in CASES}
    got = [_wait(*s) for s in spawned]
    return {"refs": refs, **dict(zip(MESHES, got))}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_loss_and_gradients_equal_gathered(runs, mesh, case):
    """The loss over the shares and the ranks' logit gradients, joined in
    rank order, equal world 1's gathered log-softmax loss and JAX's to
    fp32 rounding; each rank's gradient is its V/N columns."""
    got = runs[mesh][case]
    grads = got["grads"]
    assert len(grads) == mesh[2]
    assert all(g.shape == (B, S, V // mesh[2]) for g in grads)
    grad = torch.cat(grads, dim=-1).numpy()
    for ref in ("local", "jax"):
        loss, want = runs["refs"][case][ref]
        assert got["loss"] == pytest.approx(loss, rel=LOSS_RTOL, abs=1e-12), \
            ref
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(grad - want).max()) <= GRAD_BAR * scale, ref


def test_ignored_positions_take_no_gradient(runs):
    """Where the next label is ignored, and at every row's last position,
    the logits' gradient is zero on every rank, and a batch with every
    label ignored has loss 0."""
    logits, labels = _case("ignored")
    for mesh in MESHES:
        grad = torch.cat(runs[mesh]["ignored"]["grads"], dim=-1).numpy()
        dead = np.concatenate([labels[:, 1:] == IGNORE_INDEX,
                               np.ones((B, 1), bool)], axis=1)
        assert np.all(grad[dead] == 0) and np.any(grad[~dead] != 0)
        assert runs[mesh]["all_ignored"]["loss"] == 0.0
