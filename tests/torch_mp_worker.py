"""One rank of a CPU gloo process group training the PyTorch port on a
(data, fsdp) mesh (tests/test_torch_parallel.py) or on a (data, fsdp,
model) mesh (tests/test_torch_tensor_parallel_train.py: a job with
``"train_mesh"``), or serving it on a (data, fsdp, model) mesh
(tests/test_torch_tensor_parallel.py: a job with ``"mesh"``, whose
scenarios `serve_run` runs).

Run: python torch_mp_worker.py <rank> <world> <data> <store> <job.pkl>
(world 0: one process with no process group)

The job (a pickle the test writes) holds the full weights' state dicts,
the global batches and the scenarios to run; each scenario trains through
`Trainer` on this rank's rows of every global batch and rank 0 writes what
it read (losses, grad norms, the gathered tree, ...) to ``<out>/<name>.pt``.
The same functions run world 1 without a process group in the test's own
process (``mesh=None``).  Only the port is imported here, never jax.
"""

import contextlib
import dataclasses
import pickle
import shutil
import sys
import time

import numpy as np
import torch

from valley_tpu_torch import valley_tiny
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.parallel import distributed, sharding, tensor
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
          eval_fn=None, before=None, **over):
    """A `Trainer` over ``batches`` (this rank's rows); returns (the
    metrics lines of rank 0, the full tree after training, trainer).
    ``before(trainer)`` runs before the training does."""
    params = weights(state)
    tc = TrainConfig(output_dir=out_dir, **dict(COMMON, **over))
    loader = RankRows(batches, rows_of(mesh, len(batches[0]["input_ids"])))
    trainer = Trainer(valley_tiny(), tc, params, loader,
                      total_steps=total_steps, eval_fn=eval_fn, mesh=mesh)
    records = []
    trainer.log = records.append
    if before is not None:
        before(trainer)
    trainer.train(resume=resume)
    return records, full_state(params), trainer


def first_grads(trainer, batch, mesh, names=None) -> dict:
    """The loss, the grad norm and the full gradients of ``names`` (None:
    every trainable parameter) of one batch (this rank's rows) through
    `Trainer.loss_and_grads`, and this rank's own gradients of the
    projector (on a mesh: every rank's, with its block of the batch)."""
    rows = rows_of(mesh, len(batch["input_ids"]))
    with recording_columns() as seen:
        loss, norm, grads = trainer.loss_and_grads(trainer.device_batch(
            {k: v[rows] for k, v in batch.items()}))
    full = trainer.gathered(grads)
    own = {f"gather {i}": g for i, g in enumerate(seen["grads"])}
    if mesh is not None:
        own = _every_rank((sharding.batch_rank(mesh), own))
    return {"loss": float(loss), "norm": float(norm),
            "grads": {n: full[n] for n in names or full}, "own": own,
            "ce_widths": seen["ce_widths"], "gathered": seen["gathered"]}


@contextlib.contextmanager
def recording_columns():
    """Record, while inside, the column gathers of the ``model`` axis and
    the cross entropies over the vocabulary shares: {"gathered": [the
    width each gather joined], "grads": [the gradient each gather's
    output received, which every rank of the group must hold alike],
    "ce_widths": [the width of the logits each cross entropy read]}."""
    seen = {"gathered": [], "grads": [], "ce_widths": []}
    gather, ce = tensor.Group.gather_columns, \
        tensor.TensorParallel.cross_entropy

    def gather_rec(self, x):
        out = gather(self, x)
        seen["gathered"].append(out.shape[-1])
        if out.requires_grad:
            out.register_hook(lambda g: seen["grads"].append(g.clone()))
        return out

    def ce_rec(self, logits, targets):
        seen["ce_widths"].append(logits.shape[-1])
        return ce(self, logits, targets)

    tensor.Group.gather_columns = gather_rec
    tensor.TensorParallel.cross_entropy = ce_rec
    try:
        yield seen
    finally:
        tensor.Group.gather_columns = gather
        tensor.TensorParallel.cross_entropy = ce


def grads_of(state, batch, mesh, names, out_dir, **over):
    """`first_grads` of a fresh `Trainer` over ``state``."""
    rows = rows_of(mesh, len(batch["input_ids"]))
    trainer = Trainer(valley_tiny(), TrainConfig(output_dir=out_dir,
                                                 **dict(COMMON, **over)),
                      weights(state), RankRows([batch], rows), mesh=mesh)
    return first_grads(trainer, batch, mesh, names)


def norm_of_replicated(mesh):
    """`global_norm` of fixed gradients (one sharded, one replicated and
    large), against the norm of the full tensors on one device."""
    full = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    big = torch.full((3,), 100.0)
    mine = sharding.local_slice(full, 0, mesh).contiguous()
    got = global_norm([mine, big], [True, False], mesh)
    return float(got), float(global_norm([full, big]))


def lora_masks(state, batch, mesh, out_dir):
    """One LoRA step at dropout 0.05 with every mask an adapter applied
    recorded: [(key, mask)] in call order (forward, then the recompute;
    a row-parallel adapter's mask is the rank's columns)."""
    calls = []
    draw = llama._adapter_mask

    def recording(key, x, keep, row=None):
        m = draw(key, x, keep, row)
        calls.append((key, m.clone()))
        return m

    llama._adapter_mask = recording
    try:
        train(state, [batch], out_dir, mesh, lora=True, lora_dropout=0.05,
              freeze_backbone=True)
    finally:
        llama._adapter_mask = draw
    return calls


def vocab_ce(sc, mesh):
    """`valley.shifted_cross_entropy` over this rank's vocabulary columns
    of the scenario's (B, S, V) fp32 logits (on a mesh; world 1: all of
    them) and its labels, and its backward: the loss and every rank's
    gradient of its columns."""
    logits = torch.from_numpy(sc["logits"])
    tp = None
    if mesh is not None:
        tp = tensor.plan(dataclasses.replace(
            valley_tiny().text, vocab_size=logits.shape[-1]),
            sharding.model_size(mesh), mesh.get_local_rank("model"),
            mesh.get_group("model"))
        logits = logits.narrow(-1, tp.vocab_start, tp.vocab)
    logits = logits.clone().requires_grad_(True)
    loss = valley.shifted_cross_entropy(
        logits, torch.from_numpy(sc["labels"]), tp=tp)
    loss.backward()
    grad = logits.grad
    return {"loss": float(loss),
            "grads": [grad] if mesh is None else _every_rank(grad)}


def wait_for(path: str, timeout: float = 240.0) -> None:
    """Wait until ``path`` exists (a world that another world's save
    feeds)."""
    import os

    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


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
            # with "grads": the first batch's gradients before the updates
            first = {}
            recs, tree, _ = train(
                state, batches, work, mesh, before=sc.get("grads") and (
                    lambda t: first.update(first_grads(t, batches[0], mesh))),
                **sc.get("over", {}))
            res = {"records": recs, "tree": tree, **first}
        elif kind == "save":
            recs, _, _ = train(state, batches[:sc["updates"]], work, mesh,
                               total_steps=len(batches), **sc.get("over", {}))
            res = {"records": recs}
            if rank == 0:
                # the checkpoints are whole: a world may resume from them
                open(f"{work}.done", "w").close()
        elif kind == "resume":
            if rank == 0:
                wait_for(f"{sc['from']}.done")
                shutil.copytree(sc["from"], work)
            distributed.barrier()
            recs, tree, _ = train(state, batches, f"{out}/{name}_rank0",
                                  mesh, resume=True, **sc.get("over", {}))
            res = {"records": recs, "tree": tree}
        elif kind == "grads":
            res = grads_of(state, batches[0], mesh, sc.get("names"), work,
                           **sc.get("over", {}))
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
        elif kind == "model_mesh":
            # the same ranks as a (1, 1, 2) mesh: one update
            tp_mesh = create_mesh(1, 1, 2, device_type="cpu")
            recs, _, _ = train(state, batches[:1], work, tp_mesh)
            res = {"records": recs, "model_mesh": tuple(tp_mesh.shape),
                   "local_mesh": tuple(local_mesh(device_type="cpu").shape)}
        elif kind == "vocab_ce":
            res = vocab_ce(sc, mesh)
        elif kind == "masks":
            calls = lora_masks(state, batches[0], mesh, work)
            # every rank's masks reach rank 0
            res = {"calls": [calls] if mesh is None else _every_rank(calls)}
        else:
            raise ValueError(kind)
        results[name] = {**res, "seconds": time.perf_counter() - t0}
    return results


# -- serving on a (data, fsdp, model) mesh ---------------------------------

def _serving_cfg(name: str):
    from valley_tpu_torch import config as TC

    cfg = valley_tiny()
    if name == "gqa":
        # tests/test_gqa.py's width: 8 query heads over 2 kv heads
        cfg = TC.ValleyConfig(
            text=TC.TextConfig(vocab_size=256, hidden_size=64,
                               intermediate_size=128, num_hidden_layers=2,
                               num_attention_heads=8, num_key_value_heads=2,
                               max_position_embeddings=256),
            vision=TC.VISION_TINY,
            tokens=TC.SpecialTokens(im_patch=250, im_start=251, im_end=252,
                                    vi_frame=253, vi_start=254, vi_end=255))
    return cfg


def _engine(job, sc, mesh):
    """The scenario's engine: its JAX tree carried over (`from_jax_params`,
    the full tree on every rank), cut by ``Engine(mesh=)``."""
    from valley_tpu_torch.inference.engine import Engine
    from valley_tpu_torch.weights import from_jax_params

    params = from_jax_params(job["trees"][sc.get("tree", "fp32")], "cpu",
                             torch.float32)
    if sc.get("fused"):
        params = llama.fuse_llama_params(params)
    return Engine(_serving_cfg(sc.get("cfg", "tiny")), params,
                  buckets=(sc.get("bucket", 64),),
                  max_new_tokens=sc.get("max_new", 8),
                  steps_per_call=sc.get("steps", 4),
                  cache_dtype=torch.int8 if sc.get("int8_cache")
                  else torch.float32, mesh=mesh)


def _gen(sc, **over):
    from valley_tpu_torch.inference.engine import GenerationConfig

    return GenerationConfig(**{**dict(max_new_tokens=sc.get("new", 6),
                                      do_sample=False), **over})


def _every_rank(value):
    out = [None] * distributed.process_count()
    torch.distributed.all_gather_object(out, value)
    return out


def serve_scenario(job, sc, rank, mesh):
    kind = sc["kind"]
    prompts = [(list(p), None if im is None else np.asarray(im))
               for p, im in sc.get("prompts", [])]
    if kind == "engine":
        eng = _engine(job, sc, mesh)
        toks = [[int(t[0]) for t in eng.generate_tokens(
            [p], im, _gen(sc), eos_ids=[-1])] for p, im in prompts]
        pre = eng.prefill([prompts[0][0]], prompts[0][1], _gen(sc))
        return {"tokens": _every_rank(toks),
                "logits": pre.logits[0].numpy().copy(),
                "wq": tuple(eng.params["llama"]["layers"].wq.shape)
                if "wq" in eng.params["llama"]["layers"] else None,
                "cache_heads": eng.kv_heads}
    if kind == "sampled":
        eng = _engine(job, sc, mesh)
        gen = _gen(sc, do_sample=True, temperature=0.9, seed=5)
        return {"tokens": _every_rank([int(t[0]) for t in eng.generate_tokens(
            [prompts[0][0]], prompts[0][1], gen, eos_ids=[-1])])}
    if kind == "spec":
        from valley_tpu_torch.inference.speculative import (SpecConfig,
                                                            SpecDecoder)

        eng = _engine(job, sc, mesh)
        dec = SpecDecoder(eng, SpecConfig(draft_len=4,
                                          rounds_per_call=sc["rounds"]))
        return {"tokens": _every_rank([
            list(dec.generate_tokens(p, im, _gen(sc), eos_ids=[-1]))
            for p, im in prompts])}
    if kind == "session":
        from valley_tpu_torch.inference.engine import ChatSession

        eng = _engine(job, sc, mesh)
        sess = ChatSession(eng, _gen(sc), extra_slots=64)
        replies = [sess.chat(list(turn), images=None if i else
                             prompts[0][1], eos_ids=[-1])
                   for i, turn in enumerate(sc["turns"])]
        return {"tokens": _every_rank(replies),
                "cache_heads": sess._state[0].k.shape[3]}
    if kind == "pool":
        from valley_tpu_torch.inference.continuous import (ContinuousEngine,
                                                           _drain)
        from valley_tpu_torch.inference.speculative import SpecConfig
        from valley_tpu_torch.parallel import lockstep

        eng = _engine(job, sc, mesh)
        if sc.get("fault_rank") == rank:
            # this rank's first decode chunk fails: the world must stop
            def fault(self, n_steps):
                raise RuntimeError(f"injected chunk fault on rank {rank}")

            ContinuousEngine._decode_chunk = fault

        def body(ls):
            pool = lockstep.make(
                ContinuousEngine, eng, rows=2, bucket=sc.get("bucket", 64),
                extra_slots=64, steps_per_call=2,
                speculative=sc.get("speculative", False),
                spec=SpecConfig(draft_len=4), proxy=False)
            queues = [pool.submit(p, images=im, max_new_tokens=sc["new"],
                                  eos_id=-1) for p, im in prompts]
            out = [list(_drain(q, timeout=120)) for q in queues]
            rounds = pool.rounds_run
            pool.close()
            return {"tokens": out, "rounds": rounds,
                    "cache_heads": pool._state.cache.k.shape[3]}

        return _lead_calls(eng, body)
    if kind == "encode":
        return encode(job, sc, mesh)
    if kind == "load_engine":
        from valley_tpu_torch.serve import model_worker as worker_mod

        eng, tk = worker_mod.load_engine(worker_args(sc))
        ids = tk.encode("### Human: hi\n### Assistant:")
        return {"mesh": tuple(eng.mesh.shape), "tokens": _every_rank(
            [int(t[0]) for t in eng.generate_tokens(
                [ids], None, _gen(sc), eos_ids=[-1])])}
    if kind == "http":
        return http_scenario(sc)
    if kind == "batch":
        from valley_tpu_torch.inference import batch_infer

        batch_infer.run_batch(batch_infer.build_parser().parse_args(
            sc["argv"]))
        return {}
    raise ValueError(kind)


def encode(job, sc, mesh):
    """`valley.encode_images` of the scenario's frames over its JAX tree
    carried over (in ``dtype``, "bf16" or fp32) and cut by
    `sharding.shard_params` on the mesh: the pooled and per-frame
    features, every rank's (which must be equal) and this rank's share
    of the tower's and projector's weights."""
    from valley_tpu_torch.weights import from_jax_params

    cfg = valley_tiny()
    dtype = torch.bfloat16 if sc.get("dtype") == "bf16" else torch.float32
    params = from_jax_params(job["trees"][sc["tree"]], "cpu", dtype)
    if mesh is not None:
        sharding.shard_params(mesh, params, cfg, serving=True)
    feats = valley.encode_images(params, cfg, torch.from_numpy(sc["images"]))
    out = (feats.pooled.float().numpy().copy(),
           feats.frame_cls.float().numpy().copy())
    lay = params["vision"]["layers"]
    return {"features": out,
            "every": [out] if mesh is None else _every_rank(out),
            "shapes": {n: tuple(lay[n].shape) for n in ("wq", "fc1", "wo",
                                                        "bq", "fc1_bias")}
            | {"projector.w": tuple(params["projector"]["w"].shape)}}


def _lead_calls(engine, body):
    """``body(lockstep)`` on the lead under a fresh `Lockstep` (``engine``
    registered first on every rank), whose calls the other ranks follow;
    its result on the lead, None elsewhere."""
    from valley_tpu_torch.parallel import lockstep

    ls = lockstep.Lockstep()
    ls.register(engine)
    if not ls.lead:
        ls.follow()
        return None
    try:
        return body(ls)
    finally:
        ls.stop()


def worker_args(sc):
    """The worker's flags of a scenario (tests/test_torch_serve.py's)."""
    import argparse

    return argparse.Namespace(**{
        **dict(model_path="random:tiny", vision_tower=None, lora_path=None,
               quantize=None, quantize_vision=None, kv_cache="bf16",
               fused=False, buckets="128", max_new_tokens=8,
               steps_per_call=4, decode_ramp="off", frame_buckets="off",
               num_frames=2, tensor_parallel=2, raw_pixels=True,
               device="cpu"), **sc.get("args", {})})


def http_scenario(sc):
    """A two-rank worker: rank 0 serves over localhost HTTP and streams
    the scenario's request to itself; the other rank follows."""
    from valley_tpu_torch.serve import model_worker as worker_mod
    from valley_tpu_torch.serve.httpd import iter_delimited, open_json

    argv = ["--model-path", "random:tiny", "--device", "cpu",
            "--tensor-parallel", "2", "--no-register", "--buckets", "128",
            "--max-new-tokens", "16", *sc.get("argv", [])]
    args = worker_mod.build_parser().parse_args(argv)
    engine, tk = worker_mod.load_engine(args)
    engine = worker_mod.lockstep_engine(engine, tk)
    if engine is None:
        return {}
    from valley_tpu_torch.parallel import lockstep

    worker = worker_mod.make_worker(args, engine, tk)
    app = worker_mod.build_app(worker)
    port = app.start()
    try:
        chunks = []
        for req in sc["requests"]:
            with open_json(f"http://localhost:{port}/worker_generate_stream",
                           req, timeout=120) as r:
                chunks.append([c + b"\0" for c in iter_delimited(r)])
    finally:
        app.shutdown()
        if worker.continuous is not None:
            worker.continuous.close()
        lockstep.current().stop()
    return {"chunks": chunks}


def _random_tiny_from_jax(tree) -> None:
    """Make ``random:tiny``'s weights the JAX worker's (JAX's key 0, as
    tests/test_torch_batch.py feeds them), so that load_engine, the
    worker and batch_infer can be held to the JAX package's."""
    from valley_tpu_torch.inference import run_valley
    from valley_tpu_torch.weights import from_jax_params

    run_valley.valley.init_params = lambda *a, **k: from_jax_params(
        tree, "cpu", torch.float32)


def serve_run(job, rank, mesh):
    if "random_tiny" in job["trees"]:
        _random_tiny_from_jax(job["trees"]["random_tiny"])
    results = {}
    for sc in job["scenarios"]:
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = serve_scenario(job, sc, rank, mesh)
        results[sc["name"]] = {**(res or {}),
                               "seconds": time.perf_counter() - t0}
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
        mesh = create_mesh(*job.get("mesh", job.get(
            "train_mesh", (data, world // data, 1))), device_type="cpu")
    torch.manual_seed(0)
    np.random.seed(0)
    results = (serve_run if "mesh" in job else run)(job, rank, mesh)
    if rank == 0:
        with open(f"{job['out']}/results_world{world}.pkl", "wb") as f:
            pickle.dump(results, f)
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()
