"""Checkpoint exchange between the PyTorch port and the JAX package's
orbax format (`valley_tpu_torch.utils.orbax_io`) on the CPU.

The JAX trainer (``valley_tiny``, fp32, stage 1, tests/
test_torch_train.py's synthetic rows) writes ``checkpoint-N`` through
``valley_tpu.utils.checkpoint``, and ``final`` as ``valley_tpu.train.train``
writes it (``save_pytree`` of the parameters); LoRA's ``checkpoint-N``,
``adapter-N`` and adapter-only ``final`` go through the same functions
from optax's state of the LoRA labels with moments drawn from a seed (the
trees its trainer writes, without compiling a second trainer).  Bars: bit
for bit, every leaf in its dtype.

- JAX to the port: every parameter, AdamW moment and step of the
  converted trees equals the JAX tree's leaf; converted back, orbax
  restores the same tree, leaf for leaf (``restore_pytree``).
- The port to JAX: the port's trainer writes ``checkpoint-N`` and
  ``adapter-N`` (and ``final``, as its entry point does); converted,
  ``restore_latest`` with a JAX trainer's state as the template and
  ``restore_pytree`` give the port's tensors bit for bit, also as the
  ``MultiSteps`` state of a JAX run with accumulation.
- A JAX-trained state resumes in the port's trainer: JAX's checkpoint-2
  of a three-update stage-1 run, converted, resumed by the port for the
  third update, lands within 2e-3 of the third update's movement of
  JAX's own parameters (tests/test_torch_train.py's trainer bar; read:
  at most 1.6e-4, in ``llama.embed``); the same resume with the moments
  zeroed, a planted fault, misses it on every trainable leaf (read: 0.92
  to 1.04 of the movement).
- ``tensorstore`` is imported without JAX, and its absence is refused
  with the reason.
The file takes about 35 s on its worker alone (the JAX trainer compiles).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import STAGE1, FakeDataset
from valley_tpu import config as C
from valley_tpu.data.dataset import DataCollatorForSupervisedDataset as JColl
from valley_tpu.data.dataset import DataLoader as JLoader
from valley_tpu.models import valley as jvalley
from valley_tpu.train import lora as jlora
from valley_tpu.train.trainer import TrainConfig as JTrainConfig
from valley_tpu.train.trainer import Trainer as JTrainer
from valley_tpu.train.trainer import TrainState as JTrainState
from valley_tpu.train.trainer import make_optimizer as jmake_optimizer
from valley_tpu.utils import checkpoint as jck
from valley_tpu_torch.data.dataset import \
    DataCollatorForSupervisedDataset as TColl
from valley_tpu_torch.data.dataset import DataLoader as TLoader
from valley_tpu_torch.train import lora as tlora
from valley_tpu_torch.train.trainer import TrainConfig, Trainer
from valley_tpu_torch.utils import checkpoint as pck
from valley_tpu_torch.utils import orbax_io
from valley_tpu_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
COMMON = dict(learning_rate=1e-3, adam_eps=1e-2, num_train_epochs=1,
              per_device_train_batch_size=2, warmup_ratio=0.0,
              save_total_limit=0, gradient_checkpointing=False)
RECIPES = {"stage1": dict(STAGE1, save_steps=2),
           "lora": dict(lora=True, freeze_backbone=True, save_steps=1,
                        lora_save_strategy="steps")}
MOVE_BAR = 2e-3


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def trees(cfg):
    base = jax.device_get(jvalley.init_params(cfg, jax.random.key(61),
                                              jnp.float32))
    lora = jax.device_get(jlora.add_lora(jax.tree.map(jnp.asarray, base),
                                         jax.random.key(62), r=4, alpha=8,
                                         dtype=jnp.float32))
    rng = np.random.default_rng(63)
    for k, v in lora["llama"]["layers"].items():
        if k.endswith("_lora_b"):
            lora["llama"]["layers"][k] = rng.normal(
                0, 0.05, np.shape(v)).astype(np.float32)
    return {"stage1": base, "lora": lora}


def _jax_loader(cfg, n=6):
    return JLoader(FakeDataset(cfg, n=n), 2,
                   JColl(pad_token_id=0, pad_to_multiple=16), seed=0)


def _port_loader(cfg, n=6):
    return TLoader(FakeDataset(cfg, n=n), 2,
                   TColl(pad_token_id=0, pad_to_multiple=16), seed=0)


def _jax_trainer(cfg, tree, out, recipe, **over):
    return JTrainer(cfg, JTrainConfig(output_dir=str(out), mesh_data=1,
                                      mesh_fsdp=1, mesh_model=1,
                                      **{**COMMON, **RECIPES[recipe],
                                         **over}),
                    jax.tree.map(jnp.asarray, tree), _jax_loader(cfg))


def _port_trainer(cfg, tree, out, recipe, **over):
    from valley_tpu_torch import valley_tiny

    return Trainer(valley_tiny(), TrainConfig(
        output_dir=str(out), **{**COMMON, **RECIPES[recipe], **over}),
        from_jax_params(tree, "cpu", torch.float32), _port_loader(cfg))


def _jax_state(tree, recipe, accumulation=1, step=0):
    """The JAX trainer's ``TrainState`` of ``tree`` for ``recipe``: optax's
    state as `make_optimizer` initializes it (no jit: the structure its
    trainer saves and restores)."""
    tc = JTrainConfig(output_dir="unused", gradient_accumulation_steps=
                      accumulation, **{**COMMON, **RECIPES[recipe]})
    params = jax.tree.map(jnp.asarray, tree)
    tx = jmake_optimizer(params, tc, 8)[0]
    return JTrainState(params, tx.init(params), jnp.asarray(step, jnp.int32))


@pytest.fixture(scope="module")
def jax_runs(cfg, trees, tmp_path_factory):
    """{recipe: the JAX run's output directory, with ``final`` and
    ``valley_meta.json`` as ``train.train`` writes them}.  Stage 1: the
    JAX trainer's three updates, checkpoint-2 and checkpoint-3.  LoRA: the
    JAX package's ``save_checkpoint`` and ``save_pytree`` of three states
    (optax's, every moment drawn at random from a seed, every count the
    step's, as optax counts them) with their adapters, as its trainer
    writes them at every step."""
    out = {}
    path = tmp_path_factory.mktemp("jax_stage1")
    jt = _jax_trainer(cfg, trees["stage1"], path, "stage1")
    assert jt.train(resume=False) == 3
    jck.save_pytree(str(path / "final"), jt.state.params)
    out["stage1"] = path
    path = tmp_path_factory.mktemp("jax_lora")
    rng = np.random.default_rng(64)
    for step in (1, 2, 3):
        state = _jax_state(trees["lora"], "lora", step=step)
        state = state._replace(opt_state=jax.tree.map(
            lambda a: jnp.asarray(step, a.dtype)
            if a.ndim == 0 else jnp.asarray(rng.normal(
                0, 1e-3, a.shape), a.dtype), state.opt_state))
        jck.save_checkpoint(str(path), state, step, keep=None)
        jck.save_pytree(str(path / f"adapter-{step}"),
                        jlora.split_lora(state.params))
    jck.save_pytree(str(path / "final"), jlora.split_lora(state.params))
    out["lora"] = path
    for recipe, p in out.items():
        (p / "valley_meta.json").write_text(json.dumps(
            {"lora": recipe == "lora", "final": "final"}))
    return out


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    for k, v in (tree or {}).items():
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _equal(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    return t.dtype == torch.from_numpy(np.zeros(0, a.dtype)).dtype and \
        np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_jax_trees_read_by_the_port_bit_for_bit(jax_runs, tmp_path, recipe):
    """Every checkpoint-N, final and adapter-N of the JAX run, converted:
    parameters, AdamW moments (by label) and steps equal JAX's leaves;
    the files beside them copied."""
    src = jax_runs[recipe]
    dst = tmp_path / "port"
    done = orbax_io.convert(str(src), str(dst), to_port=True)
    names = sorted(p.name for p in src.iterdir() if p.is_dir())
    assert sorted(Path(p).name for p in done) == names
    assert (dst / "valley_meta.json").read_text() == \
        (src / "valley_meta.json").read_text()
    for name in names:
        want = jck.restore_pytree(str(src / name))
        got = pck.restore_pytree(str(dst / name))
        if name.startswith("adapter") or (name == "final"
                                          and recipe == "lora"):
            assert set(got) == set(want)
            assert all(_equal(got[k], v) for k, v in want.items())
            continue
        params = want["params"] if "params" in want else want
        flat = _flat(params)
        state = got["params"] if "params" in got else got
        assert set(state) == set(flat)
        assert all(_equal(state[k], flat[k]) for k in flat), name
        if name == "final":
            continue
        assert got["step"] == int(want["step"]) == int(name.split("-")[1])
        opt = want["opt_state"]["inner_states"]
        groups = got["optimizer"]["param_groups"]
        label = "lora" if recipe == "lora" else "base"
        assert [g["label"] for g in groups] == [label]
        adam = opt[label]["inner_state"][1][0]
        mu, nu = _flat(adam["mu"]), _flat(adam["nu"])
        assert groups[0]["names"] == [n for n in state if n in mu]
        for i, n in zip(groups[0]["params"], groups[0]["names"]):
            st = got["optimizer"]["state"][i]
            assert _equal(st["exp_avg"], mu[n]) and \
                _equal(st["exp_avg_sq"], nu[n]), n
            assert int(st["step"]) == int(adam["count"])


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_round_trip_restores_the_same_orbax_trees(jax_runs, tmp_path,
                                                  recipe):
    """JAX's trees converted to the port's and back: orbax restores each
    one equal to JAX's own, leaf for leaf (structure, dtype, bits)."""
    src = jax_runs[recipe]
    orbax_io.convert(str(src), str(tmp_path / "port"), to_port=True)
    orbax_io.convert(str(tmp_path / "port"), str(tmp_path / "back"),
                     to_port=False)
    for p in sorted(src.iterdir()):
        if p.is_dir():
            _assert_trees_equal(jck.restore_pytree(str(tmp_path / "back"
                                                       / p.name)),
                                jck.restore_pytree(str(p)))


@pytest.mark.parametrize("accumulation", [1, 2])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_port_trees_restored_by_jax_bit_for_bit(cfg, trees, tmp_path,
                                                recipe, accumulation):
    """The port's trainer writes checkpoint-N (and adapter-N for LoRA);
    converted, JAX's ``restore_latest`` with a JAX trainer's state as the
    template gives the port's parameters, moments and step bit for bit,
    for a JAX run without and with accumulation (``MultiSteps``), and
    ``restore_pytree`` the port's ``final`` and adapters."""
    tt = _port_trainer(cfg, trees[recipe], tmp_path / "port", recipe)
    assert tt.train(resume=False) == 3
    pck.save_pytree(str(tmp_path / "port" / "final"), tt.params.state_dict())
    orbax_io.convert(str(tmp_path / "port"), str(tmp_path / "jax"),
                     to_port=False, accumulation=accumulation)
    template = _jax_state(trees[recipe], recipe, accumulation)
    state, step = jck.restore_latest(str(tmp_path / "jax"), template)
    assert step == 3 and int(state.step) == 3 * accumulation
    params = tt.params.state_dict()
    flat = _flat(jax.device_get(state.params))
    assert set(flat) == set(params)
    assert all(_equal(params[k], flat[k]) for k in flat)
    opt = state.opt_state
    if accumulation > 1:
        assert int(opt.gradient_step) == 3 and int(opt.mini_step) == 0
        opt = opt.inner_opt_state
    label = "lora" if recipe == "lora" else "base"
    adam = opt.inner_states[label].inner_state[1][0]
    assert int(adam.count) == 3
    mu, nu = _flat(jax.device_get(adam.mu)), _flat(jax.device_get(adam.nu))
    for p, n in zip(tt._trainable, tt.names):
        st = tt.optimizer.state[p]
        assert _equal(st["exp_avg"], mu[n]) and _equal(st["exp_avg_sq"],
                                                       nu[n]), n
    final = _flat(jck.restore_pytree(str(tmp_path / "jax" / "final")))
    assert all(_equal(params[k], final[k]) for k in final)
    if recipe == "lora":
        adapter = jck.restore_pytree(str(tmp_path / "jax" / "adapter-3"))
        want = tlora.split_lora(tt.params)
        assert set(adapter) == set(want)
        assert all(_equal(want[k], adapter[k]) for k in adapter)


def _move_error(cfg, trees, jax_runs, tmp_path, zero_moments=False):
    """The port resuming JAX's converted checkpoint-2 for the third
    update: {leaf: max |port - JAX| / max |JAX's third-update
    movement|}."""
    src = jax_runs["stage1"]
    dst = tmp_path / ("zero" if zero_moments else "port")
    dst.mkdir()
    orbax_io.convert(str(src / "checkpoint-2"), str(dst / "checkpoint-2"),
                     to_port=True)
    if zero_moments:
        st = pck.restore_pytree(str(dst / "checkpoint-2"))
        for s in st["optimizer"]["state"].values():
            s["exp_avg"].zero_()
            s["exp_avg_sq"].zero_()
        pck.save_pytree(str(dst / "checkpoint-2"), st)
    tt = _port_trainer(cfg, trees["stage1"], dst, "stage1")
    assert tt.train(resume=True) == 3
    before = _flat(jck.restore_pytree(str(src / "checkpoint-2"))["params"])
    after = _flat(jck.restore_pytree(str(src / "checkpoint-3"))["params"])
    got = tt.params.state_dict()
    out = {}
    for n in tt.names:
        move = np.abs(after[n] - before[n]).max()
        out[n] = float(np.abs(got[n].numpy() - after[n]).max() / move)
    return out


def test_jax_state_resumes_in_the_port_trainer(cfg, trees, jax_runs,
                                               tmp_path):
    """JAX's checkpoint-2, converted, resumes in the port's trainer: its
    third update lands within 2e-3 of JAX's third-update movement on every
    trainable leaf; with the converted moments zeroed (a planted fault) it
    misses that bar on every one."""
    good = _move_error(cfg, trees, jax_runs, tmp_path)
    assert max(good.values()) <= MOVE_BAR, good
    bad = _move_error(cfg, trees, jax_runs, tmp_path, zero_moments=True)
    assert min(bad.values()) > MOVE_BAR, bad


def test_resume_refuses_other_trainable_parameters(cfg, trees, jax_runs,
                                                   tmp_path):
    """A converted stage-1 state resumed by a full fine-tuning run (other
    trainable parameters) is refused with the reason."""
    orbax_io.convert(str(jax_runs["stage1"] / "checkpoint-2"),
                     str(tmp_path / "checkpoint-2"), to_port=True)
    tt = _port_trainer(cfg, trees["stage1"], tmp_path, "stage1",
                       freeze_backbone=False)
    with pytest.raises(ValueError, match="trained other parameters"):
        tt.maybe_resume()


def test_cli_converts_without_jax(jax_runs, tmp_path):
    """``python -m valley_tpu_torch.utils.orbax_io to-port SRC DST`` in a
    fresh interpreter converts the run and never loads jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['orbax_io', 'to-port', sys.argv[1], sys.argv[2]]\n"
            "try:\n"
            "    runpy.run_module('valley_tpu_torch.utils.orbax_io', "
            "run_name='__main__')\n"
            "finally:\n"
            "    print('JAX LOADED' if 'jax' in sys.modules else 'NO JAX')\n")
    got = subprocess.run([sys.executable, "-c", code,
                          str(jax_runs["stage1"]), str(tmp_path / "out")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ,
                                           "PYTHONPATH": str(ROOT)})
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.count("converted ") == 3 and "NO JAX" in got.stdout
    assert (tmp_path / "out" / "checkpoint-3" / pck._FILE).is_file()


def test_missing_tensorstore_is_refused(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        orbax_io.read_tree(str(tmp_path))
