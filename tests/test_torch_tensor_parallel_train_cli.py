"""The training entry point with a ``model`` axis under torchrun, on the
CPU: ``torchrun --nproc_per_node 2 -m valley_tpu_torch.train.train
--device cpu`` with ``mesh_model: 2`` (two gloo ranks, the decoder cut
Megatron-style over them) against one process on the same global batch
(tests/test_torch_train_cli.py's corpus and recipe).

Bar: the losses of ``metrics.jsonl`` within rtol 2e-4 of one process's
(tests/test_torch_parallel.py's loss bar; the two runs pad their batches
to different geometries, the ranks to a fixed one).  The file takes about
25 s on its worker alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from tests.test_torch_parallel import LOSS_RTOL
from tests.test_torch_train_cli import _conf, corpus  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_entry_point_mesh_model_2_equals_world_1(
        corpus, tmp_path):  # noqa: F811
    """``torchrun --nproc_per_node 2 -m valley_tpu_torch.train.train
    --device cpu`` with ``mesh_model: 2`` (the batch world is 1, so the
    global batch is per_device's, as in one process): rank 0 writes
    ``metrics.jsonl`` with one process's losses, and ``final/`` holds the
    full tree, gathered over the model axis.  The world leaves on its
    own: the process group is taken down at the end."""
    from valley_tpu_torch.train.train import train as train_entry
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    confs = {n: _conf(corpus, f"tp_entry{n}",
                      output_dir=str(tmp_path / f"e{n}"),
                      per_device_train_batch_size=4, mesh_model=n)
             for n in (1, 2)}
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    entry = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "valley_tpu_torch.train.train",
         "--conf", confs[2], "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    assert train_entry(confs[1], "cpu") == 2
    out, _ = entry.communicate(timeout=300)
    assert entry.returncode == 0, out[-3000:]
    records = {}
    for n in (1, 2):
        with open(tmp_path / f"e{n}" / "metrics.jsonl") as f:
            records[n] = [json.loads(line) for line in f]
    got, want = records[2], records[1]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=LOSS_RTOL)
    a = ckpt_lib.restore_pytree(tmp_path / "e2" / "final")
    b = ckpt_lib.restore_pytree(tmp_path / "e1" / "final")
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
