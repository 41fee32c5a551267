"""Tensor parallelism (the mesh's ``model`` axis) in the PyTorch port's
trainer against the JAX package (tests/test_parallel_equivalence.py:71-79,
test_train.py:219): losses, gradients and parameters.

The ranks are gloo processes of tests/torch_mp_worker.py over a file store
in the test's tmp directory, one CPU thread each; each mesh's world is
spawned once and runs all of its scenarios, every world at once, while this
process runs JAX's trainers.  World 1 (the port with no process group) runs
in a process of its own, world 0.  The meshes are (1, 1, 2), (1, 2, 2) and
(1, 1, 4): JAX's own tests train at (2, 2, 2) and (1, 2, 4), which take 8
devices, and the port's CPU tests keep to four ranks; JAX's (1, 4, 2) run
stands for its meshes here.  Every tree is fp32 and fed from one JAX init
(tests/test_torch_parallel.py's trees and batches: 8 rows of 32 tokens, two
frames a row).

Bars, with their readings (this file's run on the CPU):
- losses of three updates: rtol 2e-4 of JAX's single-device trainer and of
  its (1, 4, 2) mesh run, for stage 1 (projector and embeddings) and full
  stage 2 (LoRA stage 2 at dropout 0, JAX drawing its masks from its own
  generators: test_torch_tensor_parallel_train_options.py); LoRA at
  dropout 0.05 against world 1 at (1, 1, 2), whose masks are world 1's.
  Readings: within 1.5e-7 (relative) of world 1, and within 5e-7 of
  JAX's, as world 1 is;
- every trainable leaf's first-step gradient, gathered over both axes:
  within 1e-5 (absolute) of world 1's (reads at most 1.2e-7); a leaf whose
  sum over ``model`` were missed or doubled would be off by its own size;
- the gradient the projector's column gather receives (the spliced
  features'), of which each rank takes its own columns: bit-equal on the
  ranks of one ``model`` group;
- the loss reads the logits in the ranks' vocabulary shares only: every
  cross entropy of a step sees V/N columns, and no gather joins them;
- parameters after the updates: within 2e-3 of world 1's movement, the bar
  of tests/test_torch_parallel.py (reads at most 5.4e-5).
The file takes about 50 s on its worker alone, 88-103 s in the whole suite
(as the machine's load decides).  Remat, offload, the LoRA
masks and checkpoints across meshes:
test_torch_tensor_parallel_train_options.py; the entry point under
torchrun: test_torch_tensor_parallel_train_cli.py.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (LOSS_RTOL, MOVE_BAR,  # noqa: F401
                                       _losses, _worst_move, batches, cfg,
                                       jparams, weights)
from tests.torch_mp_worker import COMMON
from valley_tpu.train import lora as jlora
from valley_tpu.train.trainer import TrainConfig as JTrainConfig
from valley_tpu.train.trainer import Trainer as JTrainer

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mp_worker.py"
MESHES = [(1, 1, 2), (1, 2, 2), (1, 1, 4)]
GRAD_BAR = 1e-5

STAGE1 = dict(freeze_backbone=True)
LORA = dict(lora=True, freeze_backbone=True, lora_dropout=0.0)
LORA_DROP = dict(LORA, lora_dropout=0.05)
# the recipes held to JAX's trainer: (weights, trainer settings); stage 1
# and full stage 2 here, LoRA in test_torch_tensor_parallel_train_options.py
RECIPES = {"stage1": ("base", STAGE1), "full": ("base", {}),
           "lora": ("lora", LORA)}
JAX_MESHES = ((1, 1, 1), (1, 4, 2))


def _scenarios(mesh):
    """The scenarios of a world: each recipe's first-step gradients, then
    its updates; at (1, 1, 2) and world 1 also LoRA with dropout (its
    masks at (1, 1, 4) too: test_torch_tensor_parallel_train_options.py)."""
    out = []
    recipes = dict(RECIPES)
    if mesh in (None, (1, 1, 2)):
        recipes["lora_drop"] = ("lora", LORA_DROP)
    for name, (w, over) in recipes.items():
        out.append({"name": name, "kind": "train", "weights": w,
                    "over": over, "grads": True})
    return out


def _spawn(tmp: Path, mesh, weights, batches, scenarios):
    """A world's ranks (mesh None: world 0, one process, no group), each
    logging beside its job's results."""
    world = 0 if mesh is None else int(np.prod(mesh))
    out = tmp / ("w0" if mesh is None else "w" + "x".join(map(str, mesh)))
    out.mkdir()
    job = {"out": str(out), "weights": weights, "batches": batches,
           "scenarios": scenarios}
    if mesh is not None:
        job["train_mesh"] = mesh
    with open(out / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(max(world, 1)):
        log = open(out / f"world{world}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), "1",
             str(out / "store"), str(out / "job.pkl")], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    return out, world, procs


def _wait(out: Path, world: int, procs) -> dict:
    for r, (p, log) in enumerate(procs):
        rc = p.wait(timeout=300)
        log.close()
        text = (out / f"world{world}_rank{r}.log").read_text()
        assert rc == 0, f"{out.name} rank {r}:\n{text[-3000:]}"
    with open(out / f"results_world{world}.pkl", "rb") as f:
        return pickle.load(f)


def _jax_lora_tree(jparams):
    """The JAX tree of tests/test_torch_parallel.py's LoRA weights."""
    lo = jax.device_get(jlora.add_lora(jparams, jax.random.key(1), r=4,
                                       alpha=8, dtype=jnp.float32))
    rng = np.random.default_rng(3)
    for k, v in lo["llama"]["layers"].items():
        if k.endswith("_lora_b"):
            lo["llama"]["layers"][k] = rng.normal(
                0, 0.05, np.shape(v)).astype(np.float32)
    return lo


def _jax_losses(cfg, jparams, batches, tmp: Path, names) -> dict:
    """{(recipe, mesh): losses of three updates} of JAX's trainer for each
    recipe of ``names``, on one device and on its (1, 4, 2) mesh, with the
    port's settings (without
    remat, which leaves the losses as they are and compiles faster): its
    jitted step over the batches, as `Trainer.train` runs it, without the
    checkpoint that ends a run."""
    trees = {"base": jparams}
    if any(RECIPES[n][0] == "lora" for n in names):
        trees["lora"] = _jax_lora_tree(jparams)
    out = {}
    for name in names:
        w, over = RECIPES[name]
        for shape in JAX_MESHES:
            jt = JTrainer(cfg, JTrainConfig(
                output_dir=str(tmp / f"jax_{name}_{shape[1]}{shape[2]}"),
                mesh_data=shape[0], mesh_fsdp=shape[1], mesh_model=shape[2],
                **dict(COMMON, **over, gradient_checkpointing=False)),
                jax.tree.map(jnp.asarray, trees[w]), batches)
            losses = []
            with jt.mesh:
                for batch in batches:
                    jt.state, m = jt._train_step(jt.state,
                                                 jt._device_batch(batch))
                    losses.append(float(m["loss"]))
            out[name, shape] = losses
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cfg, jparams, weights, batches):
    """Every world's results, world 1's (world 0: no process group) and
    JAX's losses beside them."""
    tmp = tmp_path_factory.mktemp("tptrain")
    spawned = [_spawn(tmp, mesh, weights, batches, _scenarios(mesh))
               for mesh in [None] + MESHES]
    jax_losses = _jax_losses(cfg, jparams, batches["main"], tmp,
                             ("stage1", "full"))
    got = [_wait(*s) for s in spawned]
    return {"local": got[0], "jax": jax_losses, **dict(zip(MESHES, got[1:]))}


@pytest.mark.parametrize("mesh", MESHES)
def test_losses_equal_jax(runs, mesh):
    """Stage 1 and full stage 2: three updates' losses within rtol 2e-4 of
    JAX's single-device trainer and of its (1, 4, 2) mesh (LoRA:
    test_torch_tensor_parallel_train_options.py); LoRA with dropout at
    (1, 1, 2) within the same bar of world 1, whose masks it draws."""
    for name in ("stage1", "full"):
        got = _losses(runs[mesh][name]["records"])
        for shape in JAX_MESHES:
            np.testing.assert_allclose(got, runs["jax"][name, shape],
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{name} vs JAX {shape}")
    if mesh == (1, 1, 2):
        np.testing.assert_allclose(
            _losses(runs[mesh]["lora_drop"]["records"]),
            _losses(runs["local"]["lora_drop"]["records"]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_first_step_gradients_equal_world_1(runs, mesh):
    """Every trainable leaf's first-step gradient, gathered over both axes,
    within 1e-5 of world 1's: stage 1 (projector, embeddings), full stage 2
    (every leaf of the decoder and the projector), LoRA (every adapter,
    column- and row-parallel, and the projector); at (1, 1, 2) also LoRA
    at dropout 0.05.  The loss and the global norm as world 1's."""
    names = list(RECIPES) + (["lora_drop"] if mesh == (1, 1, 2) else [])
    for name in names:
        got, want = runs[mesh][name], runs["local"][name]
        assert set(got["grads"]) == set(want["grads"]), name
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * want["loss"], name
        assert got["norm"] == pytest.approx(want["norm"], rel=1e-5), name
        for leaf, g in want["grads"].items():
            assert got["grads"][leaf].shape == g.shape, (name, leaf)
            err = float((got["grads"][leaf] - g).abs().max())
            assert err <= GRAD_BAR, (name, leaf, err)
    lora = runs["local"]["lora"]["grads"]
    assert {"llama.layers.wq_lora_a", "llama.layers.wo_lora_a",
            "llama.layers.w_down_lora_b", "projector.w"} <= set(lora)


@pytest.mark.parametrize("mesh", MESHES)
def test_projector_gradient_bit_equal_across_model_group(runs, mesh):
    """The projector, cut by its outputs, takes its columns of the
    gradient its gather receives, which is the same on every rank of a
    ``model`` group, bit for bit: the spliced features' gradient is the
    first layer's input gradient, summed over the group.  The gather is
    the step's only one (the loss joins no logits)."""
    for name in RECIPES:
        blocks = {}
        for block, own in runs[mesh][name]["own"]:
            blocks.setdefault(block, []).append(own)
        assert len(blocks) == mesh[0] * mesh[1]
        for ranks in blocks.values():
            assert len(ranks) == mesh[2]
            assert list(ranks[0]) == ["gather 0"], name
            for own in ranks[1:]:
                for leaf, g in own.items():
                    assert torch.equal(g, ranks[0][leaf]), (name, leaf)


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_reads_only_vocabulary_shares(runs, cfg, mesh):
    """Every cross entropy of the first step reads this rank's vocab/N
    columns, and the step's only column gather is the projector's
    (hidden wide): no rank holds (B, S, V) logits in the loss; world 1
    gathers nothing."""
    for name in RECIPES:
        got = runs[mesh][name]
        assert got["ce_widths"] == [cfg.text.vocab_size // mesh[2]], name
        assert got["gathered"] == [cfg.text.hidden_size], name
        assert runs["local"][name]["gathered"] == [], name


@pytest.mark.parametrize("mesh", MESHES)
def test_parameters_within_bar_of_world_1(runs, weights, mesh):
    """The parameters after three updates, gathered, within 2e-3 of world
    1's movement: each recipe, LoRA with dropout at (1, 1, 2)."""
    names = list(RECIPES) + (["lora_drop"] if mesh == (1, 1, 2) else [])
    for name in names:
        start = weights[RECIPES.get(name, ("lora",))[0]]
        worst, at = _worst_move(runs[mesh][name]["tree"],
                                runs["local"][name]["tree"], start)
        assert worst <= MOVE_BAR, (name, at, worst)
