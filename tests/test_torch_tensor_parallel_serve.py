"""Tensor parallelism of the PyTorch port's serving stack: the rule table
of the ``model`` axis against JAX's ``param_specs``, and the pool, the
speculative pool, ``load_engine``, the model worker over HTTP and
``batch_infer`` on (1, 1, 2) and (1, 2, 2) meshes of gloo ranks
(tests/torch_mp_worker.py over a file store, one CPU thread each; the
engine itself: test_torch_tensor_parallel.py).

The pool over a mesh runs its ranks in lockstep (`parallel.lockstep`):
the lead submits and decides each iteration, the other ranks follow.  The
pools' greedy tokens equal JAX's one-device engine's (test_continuous.py
:126, and :376 for the speculative pool over int8 weights at (1, 2, 2)).
``load_engine --tensor-parallel 2`` (test_serve.py:402), two requests
streamed through rank 0 of a two-rank worker (stateless by `SpecDecoder`,
and by the pool) and ``batch_infer --tensor-parallel 2`` run on
``random:tiny`` made the JAX worker's weights (JAX's key 0, as
test_torch_batch.py feeds them), and equal JAX's one-device engine, the
JAX worker's chunks byte for byte, and JAX's batch_infer's answers.  A
decode chunk that fails on one rank only (the lead, or its follower) stops
the world: both ranks end, the failing one with its traceback.  The file
takes about 40 s on its worker alone.
"""

from __future__ import annotations

import json
import subprocess
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_parallel import _jax_trees
from tests.test_torch_tensor_parallel import (_jax_tokens, _spawn, _trees,
                                              _video, _wait)
from tests.torch_mp_worker import worker_args
from valley_tpu import config as C
from valley_tpu.inference import batch_infer as jbatch
from valley_tpu.inference.engine import Engine as JEngine
from valley_tpu.models import valley as jvalley
from valley_tpu.parallel import sharding as jsharding
from valley_tpu.serve.model_worker import ModelWorker as JWorker
from valley_tpu.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch import config as TC
from valley_tpu_torch.parallel import tensor
from valley_tpu_torch.parallel.sharding import model_axis, partial_over_model
from valley_tpu_torch.serve import model_worker as worker_mod
from valley_tpu_torch.weights import from_jax_params

POOL = [list(range(10, 40)), [1, 7, 8, 9, 7, 8, 9, 7, 8]]
REQUESTS = [{"prompt": "### Human: hi there\n### Assistant:",
             "temperature": 0.0, "max_new_tokens": 8, "stop": "###"},
            {"prompt": "### Human: and again\n### Assistant:",
             "temperature": 0.0, "max_new_tokens": 8, "stop": "###"}]
POOL_FLAGS = ["--batch-window-ms", "-1", "--max-batch", "2"]
# the JAX worker of each streamed scenario: the port worker's settings by
# its command line's defaults (a pool decodes plain unless --speculative)
JAX_WORKERS = {"http": dict(speculative=True),
               "http_pool": dict(batch_window_ms=-1.0, max_batch=2)}
FAULT_TIMEOUT_S = 120


def _batch_argv(tmp, out):
    """Both batch_infers' flags (JAX's takes no --device or
    --tensor-parallel); one request an admission, so that the rows'
    prefills do not depend on arrival times."""
    return ["--model-path", "random:tiny", "--input", str(tmp / "in.jsonl"),
            "--output", str(out), "--rows", "2", "--admit-batch", "1",
            "--buckets", "128", "--max-new-tokens", "8",
            "--steps-per-call", "4", "--kv-cache", "bf16",
            "--system-prompt", "sys"]


def _answers(path):
    """The output's records without their timings."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return sorted(({k: v for k, v in r.items() if k not in
                    ("ttft_s", "wall_s")} for r in recs),
                  key=lambda r: str(r["id"]))


def _wait_stopped(out, world: int, procs) -> list:
    """Each rank's (exit code, log) of a world that must stop by itself."""
    deadline = time.monotonic() + FAULT_TIMEOUT_S
    ended = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:   # a rank left waiting: a hang
            p.kill()
            rc = None
        log.close()
        ended.append((rc, (out / f"world{world}_rank{r}.log").read_text()))
    return ended


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tps")
    with open(tmp / "in.jsonl", "w") as f:
        for i, q in enumerate(("What is here?", "Say more.",
                               "And the end?")):
            f.write(json.dumps({"id": f"q{i}", "query": q}) + "\n")
    cfg = C.valley_tiny()
    trees = _trees()
    video = _video(cfg)
    tk = ByteFallbackTokenizer()
    # random:tiny as the JAX worker makes it
    wcfg = cfg.replace(tokens=tk.special_tokens())
    wtree = jax.device_get(jvalley.init_params(wcfg, jax.random.key(0),
                                               jnp.float32))
    pool_prompts = [[POOL[0], None], [video[0], video[1]]]
    jobs = {
        (1, 1, 2): [
            dict(name="pool", kind="pool", prompts=pool_prompts, new=8),
            dict(name="load_engine", kind="load_engine"),
            dict(name="http", kind="http", requests=REQUESTS),
            dict(name="http_pool", kind="http", requests=REQUESTS,
                 argv=POOL_FLAGS),
            dict(name="batch", kind="batch", argv=_batch_argv(
                tmp, tmp / "tp.jsonl") + ["--device", "cpu",
                                          "--tensor-parallel", "2"]),
        ],
        (1, 2, 2): [
            dict(name="spec_pool", kind="pool", tree="int8",
                 speculative=True, prompts=[[p, None] for p in POOL],
                 new=8),
        ],
    }
    spawned = {mesh: _spawn(tmp, mesh, {**trees, "random_tiny": wtree},
                            scen) for mesh, scen in jobs.items()}
    faults = {r: _spawn(tmp, (1, 1, 2), trees, [dict(
        name="fault", kind="pool", prompts=[[POOL[0], None]], new=8,
        fault_rank=r)], tag=f"fault{r}") for r in (0, 1)}
    ref = {
        "pool": _jax_tokens(cfg, trees["fp32"],
                            [(POOL[0], None), tuple(video)], 8),
        "spec_pool": _jax_tokens(cfg, trees["int8"],
                                 [(p, None) for p in POOL], 8),
    }
    # JAX's one-device engine (load_engine's settings: a bf16 cache), its
    # worker's streams and its batch_infer, on the same weights
    ref["load_engine"] = _jax_tokens(
        wcfg, wtree, [(tk.encode("### Human: hi\n### Assistant:"), None)],
        6, bucket=128, cache_dtype=jnp.bfloat16)[0]
    jeng = JEngine(wcfg, jax.tree.map(jnp.asarray, wtree), buckets=(128,),
                   max_new_tokens=16, cache_dtype=jnp.bfloat16,
                   use_flash=False)
    for name, kw in JAX_WORKERS.items():
        jw = JWorker("u", "u", "valley-tiny", jeng, tk, no_register=True,
                     **kw)
        ref[name] = [list(jw.generate_stream_gate(dict(req)))
                     for req in REQUESTS]
    jbatch.run_batch(jbatch.build_parser().parse_args(
        _batch_argv(tmp, tmp / "jax.jsonl")))
    ref["batch"] = _answers(tmp / "jax.jsonl")
    worlds = {mesh: _wait(*s) for mesh, s in spawned.items()}
    worlds[(1, 1, 2)]["batch"]["answers"] = _answers(tmp / "tp.jsonl")
    worlds["faults"] = {r: _wait_stopped(*s) for r, s in faults.items()}
    return worlds, ref


def test_pool_equals_jax_single_device(runs):
    """The pool over a (1, 1, 2) engine, a text and a video request: JAX's
    one-device greedy tokens; its cache holds the rank's kv heads."""
    worlds, ref = runs
    res = worlds[(1, 1, 2)]["pool"]
    assert res["tokens"] == ref["pool"], (res["tokens"], ref["pool"])
    assert res["cache_heads"] == 2


def test_speculative_pool_equals_jax_single_device(runs):
    """The speculative pool over int8 weights at (1, 2, 2): JAX's
    one-device plain greedy tokens, through verify rounds."""
    worlds, ref = runs
    res = worlds[(1, 2, 2)]["spec_pool"]
    assert res["tokens"] == ref["spec_pool"], (res["tokens"],
                                               ref["spec_pool"])
    assert res["rounds"] > 0


def test_load_engine_tensor_parallel_2(runs):
    """``--tensor-parallel 2``: a (1, 1, 2) mesh and JAX's one-device
    greedy tokens on every rank."""
    worlds, ref = runs
    res = worlds[(1, 1, 2)]["load_engine"]
    assert res["mesh"] == (1, 1, 2)
    assert res["tokens"] == [ref["load_engine"]] * 2


@pytest.mark.parametrize("name", ["http", "http_pool"])
def test_worker_streams_through_rank_0(runs, name):
    """Two requests streamed through rank 0 of a two-rank worker (the
    stateless `SpecDecoder` path, and the pool): the JAX worker's chunks,
    byte for byte."""
    worlds, ref = runs
    got = worlds[(1, 1, 2)][name]["chunks"]
    assert got == ref[name], (got, ref[name])
    assert all(json.loads(c[-1][:-1])["error_code"] == 0 for c in got)


def test_batch_infer_tensor_parallel_2(runs):
    """``batch_infer --tensor-parallel 2``: rank 0 writes JAX's
    batch_infer's answers (timings aside)."""
    worlds, ref = runs
    got = worlds[(1, 1, 2)]["batch"]["answers"]
    assert got == ref["batch"] and len(got) == 3
    assert all("response" in r for r in got)


@pytest.mark.parametrize("rank", [0, 1])
def test_one_rank_failing_stops_the_world(runs, rank):
    """The pool's first decode chunk fails on one rank only (the lead, or
    its follower), the other rank being in the chunk's collectives: both
    ranks end with an error, neither is left waiting, and the failing one
    writes its traceback."""
    worlds, _ = runs
    ended = worlds["faults"][rank]
    for r, (rc, log) in enumerate(ended):
        assert rc not in (0, None), (r, rc, log[-3000:])
        assert "so the world stops" in log, (r, log[-3000:])
    log = ended[rank][1]
    assert "Traceback" in log and \
        f"injected chunk fault on rank {rank}" in log, log[-3000:]


def test_tensor_parallel_outside_torchrun_refused():
    """``--tensor-parallel 2`` in a process that is not one of a torchrun
    world of 2 is refused with the command line that runs it."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        worker_mod.load_engine(worker_args({}))
def _model_position(spec):
    for i, axis in enumerate(spec):
        if axis == "model" or (isinstance(axis, tuple) and "model" in axis):
            return i
    return None


# the port's deliberate differences from JAX's table (model_axis)
ROW_SCALES = ("wo_scale", "w_down_scale", "wo_scale_a8", "w_down_scale_a8")
ROW_LORA = {"wo_lora_a": 1, "w_down_lora_a": 1, "wo_lora_b": None,
            "w_down_lora_b": None}


def test_model_rule_table_matches_jax_param_specs():
    """For every leaf of every kind of tree, the port splits over ``model``
    the axis JAX's param_specs puts there, in the port's layout (the
    quantized lm_head transposed), the tower's, the projector's and the
    temporal module's leaves included, except where the decoder's
    arithmetic differs: a row-parallel projection's per-channel scales
    stay whole and its grouped ones split with the in axis; a row-parallel
    adapter's A splits on its in axis and its B stays whole, where JAX
    keeps A whole and splits B's out axis (ROADMAP.md §3).  The LoRA
    factors that stay whole are the ones whose ranks' gradients are parts
    of a sum (`partial_over_model`)."""
    jparams = jvalley.init_params(C.valley_tiny(), jax.random.key(0),
                                  jnp.float32)
    for kind, tree in _jax_trees(jparams).items():
        specs = {".".join(k.key for k in path): spec
                 for path, spec in jax.tree_util.tree_leaves_with_path(
                     jsharding.param_specs(tree), is_leaf=lambda x:
                     isinstance(x, jax.sharding.PartitionSpec))}
        port = dict(from_jax_params(tree, "cpu").named_parameters())
        assert set(port) == set(specs), kind
        split = 0
        for name, p in port.items():
            want = _model_position(specs[name])
            leaf = name.split(".")[-1]
            decoder = name.startswith("llama.")
            if decoder and leaf in ROW_SCALES:
                assert want == 1, (kind, name)
                want = 2 if p.dim() == 3 else None
            elif decoder and leaf in ROW_LORA:
                assert want == (None if leaf.endswith("_a") else 2), \
                    (kind, name)
                want = ROW_LORA[leaf]
            elif want is not None and name == "llama.lm_head" \
                    and p.dtype in (torch.int8, torch.uint8):
                want = 1 - want      # JAX (in, out), the port (out, in)
            assert model_axis(name, p) == want, (kind, name, specs[name])
            assert partial_over_model(name) == (
                name.endswith(("_lora_a", "_lora_b")) and want is None), name
            split += want is not None
        assert split >= 6, kind


def test_uneven_vocab_refused_as_jax_refuses():
    """A vocabulary the model axis does not divide (an extended
    tokenizer's 32006 over 4): JAX's device_put refuses such a tree on
    its mesh, and so does the port's plan, with the reason."""
    with pytest.raises(ValueError, match="vocab_size 32006"):
        tensor.plan(TC.TextConfig(vocab_size=32006), 4, 0, None)
    plan = tensor.plan(TC.LLAMA_13B, 4, 3, None)
    assert (plan.heads, plan.kv_heads, plan.ffn, plan.head_start) == \
        (10, 10, 3456, 30)


def test_uneven_kv_heads_cached_by_their_group():
    """kv heads the model axis does not divide: each rank computes and
    caches the one kv head its query heads read (8 over 2 kv heads on 4
    ranks: ranks 0 and 1 kv head 0, ranks 2 and 3 kv head 1); query heads
    of a rank that would read two groups (12 over 3 kv heads on 2 ranks)
    are refused, with the reason."""
    gqa = TC.TextConfig(vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_attention_heads=8,
                        num_key_value_heads=2)
    got = [tensor.plan(gqa, 4, r, None) for r in range(4)]
    assert [(p.head_start, p.heads, p.kv_start, p.kv_heads)
            for p in got] == [(0, 2, 0, 1), (2, 2, 0, 1), (4, 2, 1, 1),
                              (6, 2, 1, 1)]
    straddle = TC.TextConfig(vocab_size=256, hidden_size=96,
                             intermediate_size=128, num_attention_heads=12,
                             num_key_value_heads=3)
    with pytest.raises(ValueError, match="parts of two groups of 4"):
        tensor.plan(straddle, 2, 0, None)
