"""The trainer's options of the PyTorch port against the JAX package on the
CPU, on ``valley_tiny`` with fp32 weights: `profiling.StepTimer` and the
trainer's timing keys, ``profile_steps``, the ``"dots"`` remat policy,
``async_checkpointing`` and ``offload_optimizer``.

Tolerances, with their reasons:
- `StepTimer` on the same durations: equal (the same arithmetic);
- remat policies against no remat on the port: loss 1e-6 relative and
  gradients 2e-5 relative plus 2e-6 (the bars of JAX's
  ``test_remat_policies_match_no_remat_grads``; the port reads them equal);
- the port's ``"dots"`` gradients against JAX's ``"dots"`` gradients: 1e-4
  of the largest element of each, the stage-1 gradient bar on the CPU
  (fp32 on both sides, differing in summation order only);
- offloaded training against the port's on-device run: equal, bit for
  bit (the same elementwise arithmetic on chunks of the same tensors);
  against JAX's offloaded trainer: losses 1e-5 relative and each leaf's
  movement within 2e-3 of the JAX movement's largest element, the bars of
  ``tests/test_torch_train.py`` (Adam eps 1e-2, clipping firing);
- async saves and resumes against blocking ones: equal.

On the CPU the AdamW moments of an offloaded run are ordinary host tensors:
"pinned" is a no-op here, and the card test holds the pinned memory.
"""

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_train import FakeDataset, _batch, _leaves
from tests.test_torch_train_cli import (CrashingLoader, _conf,  # noqa: F401
                                        corpus)
from valley_tpu import config as C
from valley_tpu.data.dataset import DataCollatorForSupervisedDataset as JColl
from valley_tpu.data.dataset import DataLoader as JLoader
from valley_tpu.models import valley as jvalley
from valley_tpu.train.trainer import TrainConfig as JTrainConfig
from valley_tpu.train.trainer import Trainer as JTrainer
from valley_tpu.utils import profiling as jprofiling
from valley_tpu_torch.data.dataset import \
    DataCollatorForSupervisedDataset as TColl
from valley_tpu_torch.data.dataset import DataLoader as TLoader
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops.attention import KERNELS
from valley_tpu_torch.train import trainer as trainer_mod
from valley_tpu_torch.train.trainer import TrainConfig, Trainer
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.utils import profiling
from valley_tpu_torch.weights import from_jax_params, to_numpy

ROOT = Path(__file__).resolve().parent.parent
STAGE1 = dict(freeze_backbone=True, tune_mm_mlp_adapter=True)
TIMER_KEYS = ("step_time_mean_s", "step_time_p50_s", "step_time_p90_s",
              "steps_per_s")


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    return jvalley.init_params(cfg, jax.random.key(0), jnp.float32)


def _port_params(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu", torch.float32)


def _loader(cfg, rows=12, batch=4):
    return TLoader(FakeDataset(cfg, n=rows), batch,
                   TColl(pad_token_id=0, pad_to_multiple=16), seed=0)


def _metrics(out):
    with open(Path(out) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _train(cfg, jparams, out, loader=None, **kw):
    tc = TrainConfig(output_dir=str(out), **dict(dict(
        learning_rate=1e-3, num_train_epochs=1,
        per_device_train_batch_size=4, save_steps=0,
        gradient_checkpointing=False, **STAGE1), **kw))
    t = Trainer(cfg, tc, _port_params(jparams), loader or _loader(cfg))
    return t


# -- StepTimer and the trainer's timing keys ----------------------------

def test_step_timer_matches_jax(monkeypatch):
    """The same durations (a scripted clock) through both packages'
    `StepTimer`: equal summaries, the window of the last 3 steps, the
    median at n // 2 and the 90th percentile at int(0.9 n) of the sorted
    durations; an empty timer summarises to {}."""
    durations = [0.5, 0.125, 0.25, 2.0, 0.0625, 1.0, 0.75]
    for window in (100, 3):
        got = []
        for mod in (profiling, jprofiling):
            clock = iter(np.cumsum([1.0] + [x for d in durations
                                            for x in (d, 1.0)]).tolist())
            monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
            timer = mod.StepTimer(window=window)
            assert timer.summary() == {}
            seen = []
            for d in durations:
                timer.start()
                seen.append(timer.stop())
            assert seen == durations
            got.append(timer.summary())
        assert got[0] == got[1]
        kept = sorted(durations[-window:])
        assert got[0] == {
            "step_time_mean_s": sum(kept) / len(kept),
            "step_time_p50_s": kept[len(kept) // 2],
            "step_time_p90_s": kept[min(int(len(kept) * 0.9),
                                        len(kept) - 1)],
            "steps_per_s": len(kept) / sum(kept)}


def test_trainer_logs_the_step_timer_keys(cfg, jparams, tmp_path):
    """Every log line carries JAX's four timing keys over the micro-batches
    (two a update here), beside the record's other keys, as JAX's trainer
    logs them; the timing covers each micro-batch to its synchronise."""
    t = _train(cfg, jparams, tmp_path, gradient_accumulation_steps=2,
               per_device_train_batch_size=2, loader=_loader(cfg, batch=2))
    assert t.train(resume=False) == 3
    lines = _metrics(tmp_path)
    assert [r["step"] for r in lines] == [1, 2, 3]
    for r in lines:
        assert set(r) == {"step", "epoch", "loss", "grad_norm",
                          "learning_rate", "seconds", "step_seconds",
                          *TIMER_KEYS}
        assert 0 < r["step_time_p50_s"] <= r["step_time_p90_s"]
        assert r["steps_per_s"] == pytest.approx(
            1 / r["step_time_mean_s"], rel=0.05)


# -- profile_steps, trace, annotate --------------------------------------

def _mm_events(out):
    return sum(1 for ev in profiling.read_trace(os.path.join(out, "trace"))
               if ev.get("name") == "aten::mm")


def test_profile_steps_traces_the_asked_updates(cfg, jparams, tmp_path):
    """``profile_steps`` "a:b" traces the micro-batches of updates a + 1 to
    b (counting from 1) into ``<output_dir>/trace``, as JAX does: a trace
    of "0:2" holds twice the products of "1:2" and of "0:1", which hold
    the same (one update each of the same shapes)."""
    counts = {}
    for spec in ("0:1", "1:2", "0:2"):
        out = tmp_path / spec.replace(":", "_")
        t = _train(cfg, jparams, out, profile_steps=spec)
        assert t.train(resume=False) == 3
        files = os.listdir(out / "trace")
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        counts[spec] = _mm_events(str(out))
    assert counts["0:1"] == counts["1:2"] > 0
    assert counts["0:2"] == 2 * counts["1:2"]
    with pytest.raises(ValueError, match="profile_steps"):
        trainer_mod.check_ported(TrainConfig(profile_steps="3"))


def test_trace_annotate_and_start_server(tmp_path):
    """`trace` writes one trace of the block under the log directory,
    `annotate`'s range in it; `start_server` is refused with the reason."""
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("my_range"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = [ev.get("name") for ev in profiling.read_trace(str(tmp_path))]
    assert "my_range" in names and "aten::mm" in names
    assert profiling.kernel_counts(str(tmp_path)) == {}   # no card here
    with pytest.raises(NotImplementedError, match="on-demand"):
        profiling.start_server(9999)


# -- the "dots" remat policy ---------------------------------------------

def _full_batch(cfg):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            _batch(cfg).items()}


def _grads(params, cfg, batch, remat, attention=KERNELS):
    named = [(n, p) for n, p in params.named_parameters()
             if not n.startswith("vision")]
    for _, p in named:
        p.requires_grad_(True)
    loss = valley.loss_fn(params, cfg, batch, remat=remat,
                          attention=attention)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), dict(zip([n for n, _ in named], grads))


@pytest.mark.parametrize("policy", [True, "dots"])
def test_remat_policies_match_no_remat_grads(cfg, jparams, policy):
    """Both policies keep the numerics of the backward without remat: the
    loss and every decoder, head and projector gradient (JAX's test of the
    same name, its bars)."""
    batch = _full_batch(cfg)
    l0, g0 = _grads(_port_params(jparams), cfg, batch, False)
    l1, g1 = _grads(_port_params(jparams), cfg, batch, policy)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_dots_grads_match_jax_dots(cfg, jparams):
    """The port's "dots" loss and gradients of every decoder, head and
    projector leaf against ``jax.grad`` of JAX's loss with remat "dots"."""
    batch = _batch(cfg)

    def jloss(p):
        return jvalley.loss_fn(p, cfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                               remat="dots", use_flash=False)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    jg = _leaves(jax.device_get(jg))
    loss, grads = _grads(_port_params(jparams), cfg, _full_batch(cfg),
                         "dots")
    assert abs(float(loss) - float(jl)) < 1e-5
    assert set(grads) <= set(jg) and "llama.layers.wq" in grads
    for name, g in grads.items():
        want = np.asarray(jg[name])
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


class _Ops(TorchDispatchMode):
    """Counts each aten op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_products_and_recomputes_the_rest(cfg, jparams):
    """What each policy's backward runs again, counted by op: under "dots"
    no projection (``aten.mm``) runs beyond the backward's own products,
    as without remat, while the norms (``rsqrt``), SwiGLU (``silu``) and
    attention (its batched ``bmm`` and the prefill function, once in the
    forward and once in the recompute, as K1 on the card) run again, as
    under full remat; full remat also recomputes the projections."""
    batch = _full_batch(cfg)
    calls = []

    def prefill(*a, **k):
        calls.append(1)
        return KERNELS.prefill(*a, **k)

    counting = KERNELS._replace(prefill=prefill)
    ops = {}
    layers = cfg.text.num_hidden_layers
    for policy in (False, True, "dots"):
        params = _port_params(jparams)
        named = [p for n, p in params.named_parameters()
                 if not n.startswith("vision")]
        for p in named:
            p.requires_grad_(True)
        calls.clear()
        loss = valley.loss_fn(params, cfg, batch, remat=policy,
                              attention=counting)
        assert len(calls) == layers
        with _Ops() as counter:
            torch.autograd.grad(loss, named)
        ops[policy] = counter.n
        assert len(calls) == layers * (1 if policy is False else 2)
    none, full, dots = ops[False], ops[True], ops["dots"]
    assert dots["aten.mm.default"] == none["aten.mm.default"]
    assert full["aten.mm.default"] > none["aten.mm.default"]
    for op in ("aten.rsqrt.default", "aten.silu.default",
               "aten.bmm.default"):
        assert dots[op] == full[op] > none[op], op


def test_unknown_remat_policy_raises(cfg, jparams):
    ids = torch.from_numpy(np.random.default_rng(0).integers(5, 400, (1, 8)))
    with pytest.raises(ValueError, match="remat policy"):
        valley.loss_fn(_port_params(jparams), cfg,
                       {"input_ids": ids, "labels": ids}, remat="everything")
    assert llama._remat_policy("full") == "full"
    assert llama._remat_policy(None) is None


# -- async_checkpointing ---------------------------------------------------

def test_async_checkpointing_roundtrip(cfg, jparams, tmp_path):
    """Saves on a thread: every checkpoint still commits, none stays
    ``.tmp``, nothing is pending after ``train``, and a resume restores
    the same parameters (JAX's test of the same name)."""
    out = tmp_path / "async"
    t = _train(cfg, jparams, out, save_steps=1, save_total_limit=2,
               async_checkpointing=True, loader=_loader(cfg, rows=8))
    assert t.train(resume=False) == 2
    assert not ckpt_lib._pending
    names = os.listdir(out)
    assert "checkpoint-2" in names and "checkpoint-1" in names
    assert not any(n.endswith(".tmp") for n in names)
    t2 = _train(cfg, jparams, out, save_steps=1, async_checkpointing=True,
                loader=_loader(cfg, rows=8))
    assert t2.maybe_resume() == 2
    for (n, a), (_, b) in zip(t.params.named_parameters(),
                              t2.params.named_parameters()):
        assert torch.equal(a, b), n


def test_async_save_defers_commit_until_finalize(tmp_path):
    """A save with block=False returns before its directory is committed,
    with the state as it was when the save was called (the tensor changed
    afterwards in place); `finalize_pending` commits it."""
    out = tmp_path / "raw"
    os.makedirs(out)
    w = torch.arange(8, dtype=torch.float32)
    ckpt_lib.save_checkpoint(str(out), {"w": w}, 1, keep=None, block=False)
    w.add_(100.0)
    assert "checkpoint-1" not in os.listdir(out)     # not committed yet
    assert len(ckpt_lib._pending) == 1
    ckpt_lib.finalize_pending()
    assert "checkpoint-1" in os.listdir(out)
    state, step = ckpt_lib.restore_latest(str(out))
    assert step == 1
    assert torch.equal(state["w"], torch.arange(8, dtype=torch.float32))


def test_async_save_error_is_raised_again(cfg, jparams, tmp_path,
                                          monkeypatch):
    """A write that fails on its thread is raised at the next save, and at
    the end of ``train``; its directory is never committed."""
    real = ckpt_lib.torch.save

    def failing(obj, path):
        if "checkpoint-1" in str(path):
            raise OSError("disk full")
        real(obj, path)

    monkeypatch.setattr(ckpt_lib.torch, "save", failing)
    out = tmp_path / "raw"
    os.makedirs(out)
    ckpt_lib.save_checkpoint(str(out), {"w": torch.ones(2)}, 1, block=False)
    with pytest.raises(RuntimeError, match="asynchronous save") as e:
        ckpt_lib.save_checkpoint(str(out), {"w": torch.ones(2)}, 2)
    assert isinstance(e.value.__cause__, OSError)
    assert not ckpt_lib._pending
    assert "checkpoint-1" not in os.listdir(out)
    run = tmp_path / "run"
    t = _train(cfg, jparams, run, save_steps=1, async_checkpointing=True,
               loader=_loader(cfg, rows=4))
    with pytest.raises(RuntimeError, match="checkpoint-1"):
        t.train(resume=False)
    assert "checkpoint-1" not in os.listdir(run)


def test_resume_from_async_checkpoint_equals_blocking(cfg, jparams,
                                                      tmp_path):
    """Three updates uninterrupted with blocking saves, against two with
    async saves, a crash, and a resume from the async checkpoint-2 that
    takes the third: the same losses at every step and the same
    parameters, bit for bit."""
    whole = _train(cfg, jparams, tmp_path / "whole", save_steps=1)
    assert whole.train(resume=False) == 3
    crashed = _train(cfg, jparams, tmp_path / "run", save_steps=1,
                     async_checkpointing=True,
                     loader=CrashingLoader(_loader(cfg), 2))
    with pytest.raises(RuntimeError, match="injected crash"):
        crashed.train(resume=False)
    resumed = _train(cfg, jparams, tmp_path / "run", save_steps=1,
                     async_checkpointing=True)
    assert resumed.train(resume=True) == 3
    assert not ckpt_lib._pending
    assert [r["loss"] for r in _metrics(tmp_path / "run")] == \
        [r["loss"] for r in _metrics(tmp_path / "whole")]
    for (n, a), (_, b) in zip(whole.params.named_parameters(),
                              resumed.params.named_parameters()):
        assert torch.equal(a, b), n


# -- offload_optimizer ---------------------------------------------------

@pytest.mark.parametrize("flags", [STAGE1, {}], ids=["stage1", "full"])
def test_offload_matches_on_device(cfg, jparams, tmp_path, flags):
    """Two epochs with the AdamW moments offloaded, in chunks of 4096
    elements (so every stack and the embedding stream in pieces), against
    the same run with the moments beside the parameters: the same losses,
    parameters and moments, bit for bit; the moments are host tensors
    (pinned on the card, a no-op on the CPU)."""
    runs = {}
    for offload in (False, True):
        t = _train(cfg, jparams, tmp_path / f"off{int(offload)}",
                   num_train_epochs=2, weight_decay=0.1,
                   offload_optimizer=offload, **flags)
        t.offload_chunk = 4096
        assert t.train(resume=False) == 6
        runs[offload] = t
    dev, off = runs[False], runs[True]
    assert [r["loss"] for r in _metrics(tmp_path / "off0")] == \
        [r["loss"] for r in _metrics(tmp_path / "off1")]
    for (n, a), (_, b) in zip(dev.params.named_parameters(),
                              off.params.named_parameters()):
        assert torch.equal(a, b), n
    mo, md = off.adam_moments(), dev.adam_moments()
    assert len(mo) == len(md) == 2 * len(off._trainable)
    for a, b in zip(mo, md):
        assert a.device.type == "cpu" and torch.equal(a, b)
    big = max(off._trainable, key=lambda p: p.numel())
    big.grad = torch.zeros_like(big)
    assert sum(1 for p, _, _ in off._chunks() if p is big) > 1
    big.grad = None
    for p in off._trainable:
        assert float(off.optimizer.state[p]["step"]) == 6


def test_offload_matches_jax_offloaded_trainer(cfg, jparams, tmp_path):
    """Three clipped updates of two accumulated micro-batches, offloaded
    on both sides: logged losses and grad norms, and every trainable
    leaf's movement against JAX's trainer with ``offload_optimizer``."""
    common = dict(learning_rate=1e-3, max_grad_norm=0.05, adam_eps=1e-2,
                  gradient_accumulation_steps=2, num_train_epochs=1,
                  per_device_train_batch_size=2, save_steps=0,
                  warmup_ratio=0.34, gradient_checkpointing=False,
                  offload_optimizer=True, **STAGE1)
    jt = JTrainer(cfg, JTrainConfig(output_dir=str(tmp_path / "jax"),
                                    mesh_data=1, mesh_fsdp=1, mesh_model=1,
                                    **common),
                  jax.tree.map(jnp.copy, jparams),
                  JLoader(FakeDataset(cfg), 2,
                          JColl(pad_token_id=0, pad_to_multiple=16), seed=0))
    assert jt.train(resume=False) == 3
    tt = Trainer(cfg, TrainConfig(output_dir=str(tmp_path / "port"),
                                  **common),
                 _port_params(jparams),
                 TLoader(FakeDataset(cfg), 2,
                         TColl(pad_token_id=0, pad_to_multiple=16), seed=0))
    tt.offload_chunk = 4096
    assert tt.train(resume=False) == 3
    jl, tl = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    for a, b in zip(jl, tl):
        assert set(a) <= set(b)           # JAX's keys, timing keys too
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-5)
    start = _leaves(jax.device_get(jparams))
    got = _leaves(to_numpy(tt.params))
    for name, w in _leaves(jax.device_get(jt.state.params)).items():
        want = np.asarray(w) - np.asarray(start[name])
        moved = got[name] - np.asarray(start[name])
        if not want.any():
            assert not moved.any(), name
            continue
        assert np.abs(moved - want).max() <= 2e-3 * np.abs(want).max(), name


def test_offload_resume_roundtrip(cfg, jparams, tmp_path):
    """A checkpoint of an offloaded run holds its moments; a fresh
    offloaded trainer resumes them into host buffers bit for bit and goes
    on as the uninterrupted run (JAX's ``test_offload_resume_roundtrip``,
    and one more update)."""
    out = tmp_path / "ckpt"
    kw = dict(save_steps=2, offload_optimizer=True,
              lr_scheduler_type="constant")
    t = _train(cfg, jparams, out, loader=_loader(cfg, rows=8), **kw)
    assert t.train(resume=False) == 2
    t2 = _train(cfg, jparams, out, loader=_loader(cfg, rows=8), **kw)
    assert t2.maybe_resume() == 2
    for a, b in zip(t.adam_moments(), t2.adam_moments()):
        assert b.device.type == "cpu" and torch.equal(a, b)
    batch = t.device_batch(next(iter(_loader(cfg).epoch(3))))
    t.train_step(batch)
    t2.train_step(batch)
    for (n, a), (_, b) in zip(t.params.named_parameters(),
                              t2.params.named_parameters()):
        assert torch.equal(a, b), n


def test_offload_recipe_runs_through_the_entry_point(corpus,  # noqa: F811
                                                     tmp_path):
    """``valley_tpu/configs/experiment/valley_stage2_offload.yaml`` through
    ``python -m valley_tpu_torch.train.train --device cpu``: the recipe's
    training keys as they stand (full stage 2 with the moments offloaded,
    remat, lr 2e-5, batch 1, cosine), with the model, data and output
    paths replaced by the tiny random model and a corpus of four text and
    four video conversations, fp32, and one epoch of the recipe's three."""
    with open(ROOT / "valley_tpu/configs/experiment/"
              "valley_stage2_offload.yaml") as f:
        recipe = yaml.safe_load(f)
    assert recipe["offload_optimizer"] is True
    keep = {k: v for k, v in recipe.items()
            if k not in ("model_name_or_path", "data_path", "image_folder",
                         "video_data_path", "video_folder", "output_dir",
                         "vision_tower", "bf16", "num_train_epochs")}
    conf = _conf(corpus, "offload_recipe", output_dir=str(tmp_path / "out"),
                 **dict(keep, num_train_epochs=1))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run(
        [sys.executable, "-m", "valley_tpu_torch.train.train", "--conf",
         conf, "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = _metrics(tmp_path / "out")
    assert len(lines) == 8                      # 8 rows at batch 1
    assert all(set(TIMER_KEYS) <= set(r) for r in lines)
    assert (tmp_path / "out" / "final").exists()
    state = ckpt_lib.restore_pytree(tmp_path / "out" / "checkpoint-8")
    moments = [k for st in state["optimizer"]["state"].values() for k in st
               if k != "step"]
    assert moments and set(moments) == {"exp_avg", "exp_avg_sq"}
