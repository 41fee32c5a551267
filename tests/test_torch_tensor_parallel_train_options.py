"""Tensor parallelism (the mesh's ``model`` axis) in the PyTorch port's
trainer: the options around the update (JAX's test_train.py:254,333 and
test_offload.py:49), against world 1 or against the same mesh.

The ranks are gloo processes of tests/torch_mp_worker.py, spawned as
tests/test_torch_tensor_parallel_train.py spawns them (its losses,
gradients and parameters against JAX's), on the same trees and batches,
every world at once; world 1 (no process group) is world 0's process.
The meshes are (1, 1, 2), (1, 2, 2) and (1, 1, 4), with (1, 2, 1) to
resume a save of (1, 1, 2).

Bars, with their readings (this file's run on the CPU):
- LoRA stage 2 at dropout 0: three updates' losses within rtol 2e-4 of
  JAX's single-device trainer and of its (1, 4, 2) mesh run (read within
  1.5e-7 of JAX's single-device losses);
- the LoRA dropout masks at (1, 1, N): world 1's bit for bit, the
  row-parallel adapters' the rank's columns of world 1's;
- ``"dots"`` and full remat against no remat at the same mesh: losses
  within rtol 2e-4, parameters within 2e-3 of the movement
  (tests/test_torch_parallel.py's bars; on the CPU in fp32 they read bit
  for bit equal);
- ``offload_optimizer`` at (1, 2, 2): bit-equal to the on-device run;
- a checkpoint written at (1, 1, 2) (the first save on a thread) resumed
  at (1, 2, 1) and at world 1, and one written at world 1 resumed at
  (1, 2, 2): the uninterrupted run's third loss within rtol 2e-4 and its
  parameters within 2e-3 (read equal, and 2.7e-5).
The file takes about 45 s on its worker alone; the entry point under
torchrun: test_torch_tensor_parallel_train_cli.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (LOSS_RTOL, MOVE_BAR,  # noqa: F401
                                       _losses, _worst_move, batches, cfg,
                                       jparams, weights)
from tests.test_torch_tensor_parallel_train import (JAX_MESHES, LORA, MESHES,
                                                    _jax_losses, _spawn,
                                                    _wait)
from tests.torch_mp_worker import train as port_train

REMAT = [{"name": "full", "kind": "train"},
         {"name": "full_dots", "kind": "train",
          "over": {"gradient_checkpointing": "dots"}},
         {"name": "full_none", "kind": "train",
          "over": {"gradient_checkpointing": False}}]
MASKS = {"name": "masks", "kind": "masks", "weights": "lora"}
LORA_RUN = {"name": "lora", "kind": "train", "weights": "lora",
            "over": LORA}


def _scenarios(mesh, tmp):
    """The scenarios of each world: remat and LoRA (dropout 0, against
    JAX's) at every mesh; the masks at
    (1, 1, N) and world 1; at (1, 1, 2) a save first (resumed at (1, 2, 1)
    and by world 1, as it appears); at (1, 2, 2) the optimizer offloaded
    and a resume of world 1's save."""
    resume_112 = {"name": "resume_112", "kind": "resume",
                  "from": str(tmp / "w1x1x2" / "save_rank0")}
    if mesh is None:
        return [REMAT[0], MASKS, resume_112]
    if mesh == (1, 2, 1):
        return [resume_112]
    out = list(REMAT) + [LORA_RUN]
    if mesh == (1, 1, 2):
        out.insert(0, {"name": "save", "kind": "save", "updates": 2,
                       "over": {"save_steps": 1,
                                "async_checkpointing": True}})
    if mesh[1] == 1:
        out.append(MASKS)
    if mesh == (1, 2, 2):
        out += [{"name": "offload", "kind": "train",
                 "over": {"offload_optimizer": True}},
                {"name": "resume_w1", "kind": "resume",
                 "from": str(tmp / "w1save")}]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cfg, jparams, weights, batches):
    """Every world's results and world 1's, and JAX's LoRA losses; world
    1's save, which (1, 2, 2) resumes, is written here first."""
    tmp = tmp_path_factory.mktemp("tpopts")
    port_train(weights["base"], batches["main"][:2], str(tmp / "w1save"),
               None, total_steps=3, save_steps=1)
    (tmp / "w1save.done").touch()
    meshes = [None] + MESHES + [(1, 2, 1)]
    spawned = [_spawn(tmp, mesh, weights, batches, _scenarios(mesh, tmp))
               for mesh in meshes]
    jax_losses = _jax_losses(cfg, jparams, batches["main"], tmp, ("lora",))
    got = dict(zip(meshes, (_wait(*s) for s in spawned)))
    got["local"] = got.pop(None)
    return {**got, "jax": jax_losses}


@pytest.mark.parametrize("mesh", MESHES)
def test_lora_losses_equal_jax(runs, mesh):
    """LoRA stage 2 at dropout 0 (the adapters, column- and
    row-parallel, and the projector): three updates' losses within rtol
    2e-4 of JAX's single-device trainer and of its (1, 4, 2) mesh."""
    got = _losses(runs[mesh]["lora"]["records"])
    for shape in JAX_MESHES:
        np.testing.assert_allclose(got, runs["jax"]["lora", shape],
                                   rtol=LOSS_RTOL, err_msg=f"vs JAX {shape}")


@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 1, 4)])
def test_lora_dropout_masks_equal_world_1(runs, mesh):
    """At (1, 1, N) every rank applies world 1's masks: the column-parallel
    adapters' whole, the row-parallel ones' (``wo``, ``w_down``) the
    rank's columns of world 1's."""
    want = {}
    for key, mask in runs["local"]["masks"]["calls"][0]:
        want.setdefault(key, mask)
    n = mesh[2]
    for rank, calls in enumerate(runs[mesh]["masks"]["calls"]):
        assert len(calls) == len(runs["local"]["masks"]["calls"][0])
        row = 0
        for key, mask in calls:
            ref = want[key]
            if mask.shape != ref.shape:
                w = mask.shape[-1]
                assert ref.shape[-1] == n * w
                ref = ref.narrow(-1, rank * w, w)
                row += 1
            assert torch.equal(mask, ref), (rank, key)
        assert row > 0




@pytest.mark.parametrize("mesh", MESHES)
def test_remat_equals_no_remat(runs, weights, mesh):
    """Full stage 2 under ``"dots"`` and full remat against no remat at
    the same mesh (the recompute runs the same collectives in the same
    order on every rank): losses within rtol 2e-4, parameters within 2e-3
    of the movement."""
    ref = runs[mesh]["full_none"]
    for name in ("full", "full_dots"):
        got = runs[mesh][name]
        np.testing.assert_allclose(_losses(got["records"]),
                                   _losses(ref["records"]), rtol=LOSS_RTOL)
        worst, at = _worst_move(got["tree"], ref["tree"], weights["base"])
        assert worst <= MOVE_BAR, (name, at, worst)


def test_offload_bit_equal_to_on_device(runs):
    """``offload_optimizer`` at (1, 2, 2) streams the moments of the
    rank's parts: its losses and parameters are the on-device run's bit for
    bit (JAX's test_offload.py:49)."""
    a, b = runs[(1, 2, 2)]["offload"], runs[(1, 2, 2)]["full"]
    assert _losses(a["records"]) == _losses(b["records"])
    for name, t in b["tree"].items():
        assert torch.equal(a["tree"][name], t), name


@pytest.mark.parametrize("case", ["112_to_121", "112_to_1", "1_to_122"])
def test_checkpoint_resumes_at_another_mesh(runs, weights, case):
    """checkpoint-2 written at (1, 1, 2) (the first save asynchronous, as
    on one mesh) resumes at (1, 2, 1) and at world 1, and one written at
    world 1 resumes at (1, 2, 2): the third update's
    loss and the parameters after it are the uninterrupted run's (JAX's
    test_train.py:254,333)."""
    got = {"112_to_121": runs[(1, 2, 1)]["resume_112"],
           "112_to_1": runs["local"]["resume_112"],
           "1_to_122": runs[(1, 2, 2)]["resume_w1"]}[case]
    want = runs["local"]["full"]
    assert [r["step"] for r in got["records"]] == [3]
    np.testing.assert_allclose(got["records"][0]["loss"],
                               want["records"][2]["loss"], rtol=LOSS_RTOL)
    worst, at = _worst_move(got["tree"], want["tree"], weights["base"])
    assert worst <= MOVE_BAR, (at, worst)
