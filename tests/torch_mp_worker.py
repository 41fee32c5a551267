"""One rank of a CPU gloo process group training the PyTorch port on a
(data, fsdp) mesh (tests/test_torch_parallel.py).

Run: python torch_mp_worker.py <rank> <world> <data> <store> <job.pkl>
(world 0: one process with no process group)

The job (a pickle the test writes) holds the full weights' state dicts,
the global batches and the scenarios to run; each scenario trains through
`Trainer` on this rank's rows of every global batch and rank 0 writes what
it read (losses, grad norms, the gathered tree, ...) to ``<out>/<name>.pt``.
The same functions run world 1 without a process group in the test's own
process (``mesh=None``).  Only the port is imported here, never jax.
"""

import pickle
import shutil
import sys
import time

import numpy as np
import torch

from valley_tpu_torch import valley_tiny
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.parallel import distributed, sharding
from valley_tpu_torch.parallel.mesh import create_mesh, local_mesh
from valley_tpu_torch.train.trainer import TrainConfig, Trainer, global_norm
from valley_tpu_torch.weights import from_state_dict

# the trainer settings of every scenario: full fine-tuning (every sharded
# and replicated kind trains), Adam eps 1e-2 (tests/test_torch_train.py)
COMMON = dict(learning_rate=1e-3, adam_eps=1e-2, num_train_epochs=1,
              save_steps=0, freeze_backbone=False, tune_mm_mlp_adapter=True,
              gradient_checkpointing=True, warmup_ratio=0.0)


class RankRows:
    """A loader over pre-collated global batches: this rank's rows."""

    def __init__(self, batches, rows: slice):
        self.batches, self.rows = batches, rows

    def __len__(self):
        return len(self.batches)

    def epoch(self, _i):
        for b in self.batches:
            yield {k: v[self.rows] for k, v in b.items()}


def rows_of(mesh, batch: int) -> slice:
    return sharding.process_batch_slice(mesh, batch)


def full_state(params) -> dict:
    """The full tree of a (possibly sharded) `ValleyWeights`, on the host."""
    if sharding.sharding_of(params) is None:
        return {n: p.detach().clone() for n, p in params.state_dict().items()}
    return sharding.gather_state(params, to_host=True)


def weights(state):
    """A fresh `ValleyWeights` of a full state (a copy: training updates
    its tensors in place)."""
    return from_state_dict({n: t.clone() for n, t in state.items()}, "cpu",
                           torch.float32)


def train(state, batches, out_dir, mesh, total_steps=None, resume=False,
          eval_fn=None, **over):
    """A `Trainer` over ``batches`` (this rank's rows); returns (the
    metrics lines of rank 0, the full tree after training, trainer)."""
    params = weights(state)
    tc = TrainConfig(output_dir=out_dir, **dict(COMMON, **over))
    loader = RankRows(batches, rows_of(mesh, len(batches[0]["input_ids"])))
    trainer = Trainer(valley_tiny(), tc, params, loader,
                      total_steps=total_steps, eval_fn=eval_fn, mesh=mesh)
    records = []
    trainer.log = records.append
    trainer.train(resume=resume)
    return records, full_state(params), trainer


def grads_of(state, batch, mesh, names, out_dir):
    """The loss, the grad norm and the full gradients of ``names`` of one
    batch (this rank's rows) through `Trainer.loss_and_grads`."""
    params = weights(state)
    rows = rows_of(mesh, len(batch["input_ids"]))
    trainer = Trainer(valley_tiny(), TrainConfig(output_dir=out_dir,
                                                 **COMMON),
                      params, RankRows([batch], rows), mesh=mesh)
    loss, norm, grads = trainer.loss_and_grads(trainer.device_batch(
        {k: v[rows] for k, v in batch.items()}))
    order = [n for g in trainer.optimizer.param_groups for n in g["names"]]
    out = {}
    for n in names:
        i = order.index(n)
        out[n] = sharding.full_tensor(grads[i], trainer.fsdp_axes[i], mesh) \
            if mesh is not None else grads[i]
    return float(loss), float(norm), out


def norm_of_replicated(mesh):
    """`global_norm` of fixed gradients (one sharded, one replicated and
    large), against the norm of the full tensors on one device."""
    full = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    big = torch.full((3,), 100.0)
    mine = sharding.local_slice(full, 0, mesh).contiguous()
    got = global_norm([mine, big], [True, False], mesh)
    return float(got), float(global_norm([full, big]))


def lora_masks(state, batch, mesh, out_dir):
    """One LoRA step at dropout 0.05 with every mask recorded: [(key,
    mask)] in call order (forward, then the recompute)."""
    calls = []
    draw = llama.dropout_mask

    def recording(key, shape, keep, device):
        m = draw(key, shape, keep, device)
        calls.append((key, m.clone()))
        return m

    llama.dropout_mask = recording
    try:
        train(state, [batch], out_dir, mesh, lora=True, lora_dropout=0.05,
              freeze_backbone=True)
    finally:
        llama.dropout_mask = draw
    return calls


def run(job, rank, mesh):
    out = job["out"]
    results = {}
    for sc in job["scenarios"]:
        t0 = time.perf_counter()
        name, kind = sc["name"], sc["kind"]
        batches = job["batches"][sc.get("batches", "main")]
        state = job["weights"][sc.get("weights", "base")]
        work = f"{out}/{name}_rank{rank}"
        if kind == "train":
            recs, tree, _ = train(state, batches, work, mesh,
                                  **sc.get("over", {}))
            res = {"records": recs, "tree": tree}
        elif kind == "save":
            recs, _, _ = train(state, batches[:sc["updates"]], work, mesh,
                               total_steps=len(batches), **sc.get("over", {}))
            res = {"records": recs}
        elif kind == "resume":
            if rank == 0:
                shutil.copytree(sc["from"], work)
            distributed.barrier()
            recs, tree, _ = train(state, batches, f"{out}/{name}_rank0",
                                  mesh, resume=True, **sc.get("over", {}))
            res = {"records": recs, "tree": tree}
        elif kind == "grads":
            res = dict(zip(("loss", "norm", "grads"),
                           grads_of(state, batches[0], mesh, sc["names"],
                                    work)))
        elif kind == "norm":
            res = {"norm": norm_of_replicated(mesh)}
        elif kind == "eval":
            seen = []

            def eval_fn(params, step):
                seen.append((step, tuple(params["projector"]["w"].shape),
                             sharding.sharding_of(params) is None))
                return {"rank": distributed.process_index()}

            recs, _, _ = train(state, batches, work, mesh, eval_fn=eval_fn,
                               evaluation_strategy="steps", eval_steps=1)
            every = [None] * distributed.process_count()
            torch.distributed.all_gather_object(every, seen)
            res = {"records": recs, "seen": every}
        elif kind == "refuse":
            try:
                create_mesh(1, 1, 2, device_type="cpu")
            except NotImplementedError as e:
                res = {"message": str(e),
                       "local_mesh": tuple(local_mesh(device_type="cpu")
                                           .shape)}
        elif kind == "masks":
            calls = lora_masks(state, batches[0], mesh, work)
            # every rank's masks reach rank 0
            gathered = [None] * distributed.process_count()
            torch.distributed.all_gather_object(gathered, calls)
            res = {"calls": gathered}
        else:
            raise ValueError(kind)
        results[name] = {**res, "seconds": time.perf_counter() - t0}
    return results


def main():
    """World 0 is one process without a process group (mesh None)."""
    rank, world, data = (int(a) for a in sys.argv[1:4])
    store, job_path = sys.argv[4], sys.argv[5]
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = None
    if world:
        distributed.initialize(f"file://{store}", world, rank, device="cpu")
        mesh = create_mesh(data, world // data, 1, device_type="cpu")
    torch.manual_seed(0)
    np.random.seed(0)
    results = run(job, rank, mesh)
    if rank == 0:
        with open(f"{job['out']}/results_world{world}.pkl", "wb") as f:
            pickle.dump(results, f)
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()
