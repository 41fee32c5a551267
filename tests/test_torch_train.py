"""Training on the PyTorch port against the JAX package, on the CPU, on
``valley_tiny`` with fp32 weights made once by the JAX ``init_params``.

Tolerances, with their reasons:
- loss 1e-5 and gradients 1e-4 of max|ref|: fp32 on both sides, differing
  in summation order only (the port's attention is the flash pair's plain
  versions, the JAX loss its XLA attention);
- the Trainer's logged loss and grad_norm to 1e-5 relative (the same), its
  learning rate to 1e-6 relative (optax computes the schedule in fp32, the
  port in Python floats);
- parameters after three updates: each trainable leaf's movement from
  its start to 2e-3 of the JAX movement's largest element.  Both sides run
  Adam with eps 1e-2, above every gradient element, so an update is close
  to lr * m / eps, linear in the clipped gradient: Adam's own scale
  invariance cannot hide a missing or wrong clip, and fp32 summation noise
  moves an element by the same small fraction it changes its gradient
  (readings: at most 2.3e-4 of the movement, in the decoder's wv).  The
  same run with the port's clipping turned off is the planted control: it
  must miss that bar on every trainable leaf (readings: 3 to 26 times the
  movement).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.data.dataset import DataCollatorForSupervisedDataset as JColl
from valley_tpu.data.dataset import DataLoader as JLoader
from valley_tpu.models import valley as jvalley
from valley_tpu.train.trainer import TrainConfig as JTrainConfig
from valley_tpu.train.trainer import Trainer as JTrainer
from valley_tpu.train.trainer import label_params as jlabel_params
from valley_tpu_torch.data.dataset import \
    DataCollatorForSupervisedDataset as TColl
from valley_tpu_torch.data.dataset import DataLoader as TLoader
from valley_tpu_torch.models import valley
from valley_tpu_torch.train.trainer import TrainConfig, Trainer, label_params
from valley_tpu_torch.weights import from_jax_params, set_trainable, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STAGE1 = dict(freeze_backbone=True, tune_mm_mlp_adapter=True)
TRAINABLE_STAGE1 = ("projector.w", "projector.b", "llama.embed")


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    return jvalley.init_params(cfg, jax.random.key(0), jnp.float32)


class FakeDataset:
    """Synthetic supervised rows of ragged length: even rows are videos of
    ``frames`` frames, odd rows single images; prompts are masked."""

    def __init__(self, cfg, n=12, seq=40, frames=2):
        rng = np.random.default_rng(0)
        tok = cfg.tokens
        span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
            [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
            [tok.vi_end]
        size = cfg.vision.image_size
        self.items = []
        for i in range(n):
            length = int(rng.integers(seq // 2, seq))
            ids = rng.integers(5, 400, size=length)
            ids[1:1 + len(span)] = span
            t = frames if i % 2 == 0 else 1
            labels = ids.copy()
            labels[:length // 2] = -100
            self.items.append(dict(
                input_ids=ids, labels=labels,
                image=rng.standard_normal((t, 3, size, size)).astype(
                    np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _batch(cfg):
    coll = TColl(pad_token_id=0, pad_to_multiple=16)
    return coll([FakeDataset(cfg)[i] for i in range(4)])


def _leaves(tree, prefix=""):
    """{dotted name: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(cfg, jparams, remat):
    """The port's loss_fn (vision tower under no_grad, the flash pair's
    plain versions) and its projector and embedding gradients against
    jax.value_and_grad of valley.loss_fn with XLA attention."""
    batch = _batch(cfg)

    def jloss(proj_w, proj_b, embed):
        p = dict(jparams, projector={"w": proj_w, "b": proj_b},
                 llama=dict(jparams["llama"], embed=embed))
        return jvalley.loss_fn(p, cfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                               remat=remat, use_flash=False)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jparams["projector"]["w"], jparams["projector"]["b"],
        jparams["llama"]["embed"])

    tparams = from_jax_params(jax.device_get(jparams), "cpu", torch.float32)
    # a tower weight that asks for a gradient must still get none
    set_trainable(tparams, TRAINABLE_STAGE1 + ("vision.patch_embedding",))
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = valley.loss_fn(tparams, cfg, tbatch, remat=remat)
    named = dict(tparams.named_parameters())
    *grads, tower = torch.autograd.grad(
        loss, [named[n] for n in TRAINABLE_STAGE1]
        + [named["vision.patch_embedding"]], allow_unused=True)

    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    for name, g, want in zip(TRAINABLE_STAGE1, grads, jg):
        want = np.asarray(want)
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)
    assert tower is None    # the tower runs under no_grad


@pytest.mark.parametrize("flags", [
    STAGE1, {},
    dict(freeze_backbone=True, tune_mm_mlp_adapter=True,
         freeze_mm_mlp_adapter=True),
], ids=["stage1", "stage2_full", "freeze_mm_mlp_adapter"])
def test_label_params_match_jax(cfg, jparams, flags):
    want = _leaves(jlabel_params(jparams, JTrainConfig(**flags)))
    tparams = from_jax_params(jax.device_get(jparams), "cpu", torch.float32)
    assert label_params(tparams, TrainConfig(**flags)) == want


@pytest.mark.parametrize("flags,remat", [(STAGE1, True), ({}, False)],
                         ids=["stage1_remat", "full_finetune"])
def test_trainer_matches_jax_trainer(cfg, jparams, tmp_path, flags, remat):
    """Three updates of two accumulated micro-batches each, with a clip
    bar far under the gradient norm so clipping fires every update, and a
    one-update warmup: logged metrics at every step and every parameter
    afterwards; then the planted control without the port's clipping.
    Every ported label set has one trainable group ('base'; LoRA is
    refused), so a per-group clip equals a global one here."""
    common = dict(learning_rate=1e-3, max_grad_norm=0.05, adam_eps=1e-2,
                  gradient_accumulation_steps=2, num_train_epochs=1,
                  per_device_train_batch_size=2, save_steps=0,
                  warmup_ratio=0.34, gradient_checkpointing=remat, **flags)
    jt = JTrainer(cfg, JTrainConfig(output_dir=str(tmp_path / "jax"),
                                    mesh_data=1, mesh_fsdp=1, mesh_model=1,
                                    **common),
                  jax.tree.map(jnp.copy, jparams),
                  JLoader(FakeDataset(cfg), 2,
                          JColl(pad_token_id=0, pad_to_multiple=16), seed=0))
    assert jt.train(resume=False) == 3

    def port(out, **over):
        tt = Trainer(cfg, TrainConfig(output_dir=str(tmp_path / out),
                                      **dict(common, **over)),
                     from_jax_params(jax.device_get(jparams), "cpu",
                                     torch.float32),
                     TLoader(FakeDataset(cfg), 2,
                             TColl(pad_token_id=0, pad_to_multiple=16),
                             seed=0))
        assert tt.train(resume=False) == 3
        return tt

    tt = port("port")

    def lines(path):
        with open(path / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    jl, tl = lines(tmp_path / "jax"), lines(tmp_path / "port")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [1, 2, 3]
    for a, b in zip(jl, tl):
        assert b["grad_norm"] > common["max_grad_norm"]   # clipping fires
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(b["learning_rate"], a["learning_rate"],
                                   rtol=1e-6, atol=1e-12)

    start = _leaves(jax.device_get(jparams))
    want = {n: np.asarray(w) - np.asarray(start[n])
            for n, w in _leaves(jax.device_get(jt.state.params)).items()}
    labels = label_params(tt.params, tt.tc)

    def misses(params):
        """The trainable leaves whose movement misses the JAX movement by
        more than 2e-3 of its largest element."""
        got = _leaves(to_numpy(params))
        assert set(got) == set(want)
        out = []
        for name, w in want.items():
            moved = got[name] - np.asarray(start[name])
            if labels[name] == "frozen":
                assert not moved.any() and not w.any(), name
                continue
            assert np.abs(w).max() > 0, name
            if np.abs(moved - w).max() > 2e-3 * np.abs(w).max():
                out.append(name)
        return out

    assert misses(tt.params) == []
    trainable = [n for n in want if labels[n] != "frozen"]
    assert misses(port("no_clip", max_grad_norm=1e9).params) == trainable
