"""Tensor parallelism (the mesh's ``model`` axis) of the PyTorch port's
serving engine against the JAX package (tests/test_sharded_inference.py,
test_quant.py:73,92, test_fused.py:85, test_speculative.py:439).

The ranks are gloo processes of tests/torch_mp_worker.py over a file store
in the test's tmp directory, one CPU thread each; each mesh's world is
spawned once and runs all of its scenarios, every world at once, while this
process computes JAX's single-device references.  Every rank carries the
JAX tree over with `from_jax_params` (the full tree) and `Engine(mesh=)`
cuts it.  The meshes are JAX's: (1, 1, 2), (1, 2, 2) and (1, 1, 4); the
multimodal case runs at (1, 2, 2), where JAX's runs at (1, 2, 4), to keep
to four ranks.

Readings (fp32 trees): the prefill logits of the text prompt lie within
1.17e-6 (1, 1, 2), 1.17e-6 (1, 2, 2) and 1.20e-6 (1, 1, 4) of JAX's
largest |logit| (bar 1e-5); greedy tokens
equal JAX's single-device engine's at every mesh and mode (the fused
layout's against JAX's unfused engine, whose products it concatenates);
every rank's sampled stream is the same.  The file takes about 50 s on
its worker alone (the three worlds beside the JAX engines' compiles).
The pool, the worker and batch_infer: test_torch_tensor_parallel_serve.py.
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

from valley_tpu import config as C
from valley_tpu.inference.engine import Engine as JEngine
from valley_tpu.inference.engine import GenerationConfig as JGen
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import quant as jquant
from valley_tpu_torch import config as TC
from valley_tpu_torch.inference.engine import ChatSession, Engine, \
    GenerationConfig
from valley_tpu_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mp_worker.py"
LOGIT_BAR = 1e-5

# the JAX tests' prompts
TEXT = list(range(10, 40))
SPEC = [7, 8, 9, 7, 8, 9, 7, 8] + list(range(10, 30))
QUANT = list(range(10, 25))
TURNS = [list(range(10, 30)), [5, 6, 7]]


def _video(cfg, frames=2):
    tok = cfg.tokens
    span = ([tok.im_start] + [tok.im_patch] * cfg.num_patches
            + [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames
            + [tok.vi_end])
    images = np.random.default_rng(0).standard_normal(
        (1, frames, 3, cfg.vision.image_size, cfg.vision.image_size)
    ).astype(np.float32)
    return [1] + span + list(range(10, 20)), images


def _gqa_cfg():
    return C.ValleyConfig(
        text=C.TextConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=8, num_key_value_heads=2,
                          max_position_embeddings=256),
        vision=C.VISION_TINY,
        tokens=C.SpecialTokens(im_patch=250, im_start=251, im_end=252,
                               vi_frame=253, vi_start=254, vi_end=255))


def _trees():
    cfg = C.valley_tiny()
    base = jvalley.init_params(cfg, jax.random.key(11), jnp.float32)

    def copy():     # the quantizers consume their trees
        return jax.tree.map(jnp.copy, base)

    return {
        "fp32": copy(),
        "int8": jquant.quantize_llama_params(copy()),
        # test_quant.py:92: groups of hidden/2, packed; the 128 bucket
        # takes the W4A8 product, its row-parallel K split on groups
        "int4gpa8": jquant.pack_int4_params(jquant.quantize_llama_params(
            copy(), bits=4, group_size=cfg.text.hidden_size // 2,
            act8=True)),
        "fused": jllama.fuse_llama_params(copy()),
        "gqa": jvalley.init_params(_gqa_cfg(), jax.random.key(3),
                                   jnp.float32),
    }


def _jobs(trees, video):
    vid = [video[0], video[1]]
    text = [[TEXT, None]]
    return {
        (1, 1, 2): [
            dict(name="fp32", kind="engine", prompts=text + [vid]),
            dict(name="sampled", kind="sampled", prompts=text),
            dict(name="int8", kind="engine", tree="int8",
                 prompts=[[QUANT, None]], new=4),
            dict(name="int4gpa8", kind="engine", tree="int4gpa8",
                 bucket=128, prompts=[[QUANT, None]], new=4),
            dict(name="fused", kind="engine", tree="fused",
                 prompts=text + [vid]),
            dict(name="fused_int8_cache", kind="engine", tree="fused",
                 int8_cache=True, prompts=text),
            dict(name="spec", kind="spec", prompts=[[SPEC, None]], new=8,
                 rounds=2),
            dict(name="session", kind="session", turns=TURNS,
                 prompts=text),
        ],
        (1, 2, 2): [
            dict(name="fp32", kind="engine", prompts=text + [vid]),
            dict(name="int8", kind="engine", tree="int8",
                 prompts=[[QUANT, None]], new=4),
            dict(name="spec_int8", kind="spec", tree="int8", bucket=128,
                 max_new=24, new=24, rounds=3,
                 prompts=[[SPEC, None], [TEXT, None]]),
        ],
        (1, 1, 4): [
            dict(name="fp32", kind="engine", prompts=text),
            dict(name="gqa", kind="engine", cfg="gqa", tree="gqa",
                 prompts=[[list(range(10, 28)), None]]),
        ],
    }


def _spawn(tmp: Path, mesh, trees, scenarios, tag: str = ""):
    world = int(np.prod(mesh))
    out = tmp / ("w" + "x".join(map(str, mesh)) + tag)
    out.mkdir()
    job = {"out": str(out), "mesh": mesh, "scenarios": scenarios,
           "trees": {k: jax.device_get(v) for k, v in trees.items()}}
    with open(out / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
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


def _jax_tokens(cfg, tree, prompts, new, bucket=64, max_new=8,
                cache_dtype=jnp.float32, **kw):
    """JAX's one-device greedy tokens of each (prompt, images), ``new`` of
    them (a number, or one for each prompt)."""
    eng = JEngine(cfg, jax.tree.map(jnp.asarray, tree), buckets=(bucket,),
                  max_new_tokens=max_new, cache_dtype=cache_dtype,
                  use_flash=False, **kw)
    news = new if isinstance(new, list) else [new] * len(prompts)
    return [[int(t[0]) for t in eng.generate_tokens(
        [p], None if im is None else jnp.asarray(im),
        JGen(max_new_tokens=n, do_sample=False), eos_ids=[-1])]
        for (p, im), n in zip(prompts, news)]


def _jax_logits(cfg, tree, ids, images):
    """JAX's fp32 logits of the prompt's last token (one device)."""
    logits = jvalley.forward(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray([ids]),
        None if images is None else jnp.asarray(images))
    return np.asarray(logits[0, len(ids) - 1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results, and JAX's references beside them."""
    tmp = tmp_path_factory.mktemp("tp")
    cfg = C.valley_tiny()
    trees = _trees()
    video = _video(cfg)
    spawned = {mesh: _spawn(tmp, mesh, trees, scen)
               for mesh, scen in _jobs(trees, video).items()}
    vid = (video[0], video[1])
    fp32 = _jax_tokens(cfg, trees["fp32"], [(TEXT, None), vid,
                                            (TURNS[0], None), (SPEC, None)],
                       [6, 6, 6, 8])
    ref = {
        "fp32": fp32[:2], "session_first": fp32[2], "spec": fp32[3:],
        "int8": _jax_tokens(cfg, trees["int8"], [(QUANT, None)], 4),
        "int4gpa8": _jax_tokens(cfg, trees["int4gpa8"], [(QUANT, None)], 4,
                                bucket=128, w4_packed=True),
        # the fused layout's products are the unfused ones', and on these
        # weights an int8 cache keeps JAX's fp32-cache tokens
        "fused": fp32[:2], "fused_int8_cache": fp32[:1],
        "spec_int8": _jax_tokens(cfg, trees["int8"],
                                 [(SPEC, None), (TEXT, None)], 24,
                                 bucket=128, max_new=24),
        "gqa": _jax_tokens(_gqa_cfg(), trees["gqa"],
                           [(list(range(10, 28)), None)], 6),
        "logits": [_jax_logits(cfg, trees["fp32"], *p)
                   for p in ((TEXT, None), vid)],
    }
    # the session's second turn against the one-device port session (itself
    # held to JAX's by tests/test_torch_session.py)
    eng = Engine(TC.valley_tiny(), from_jax_params(jax.device_get(trees["fp32"]),
                                             "cpu", torch.float32),
                 buckets=(64,), max_new_tokens=8, cache_dtype=torch.float32)
    sess = ChatSession(eng, GenerationConfig(max_new_tokens=6,
                                             do_sample=False),
                       extra_slots=64)
    ref["session"] = [sess.chat(t, eos_ids=[-1]) for t in TURNS]
    worlds = {mesh: _wait(*s) for mesh, s in spawned.items()}
    return worlds, ref


def _same_on_every_rank(per_rank):
    assert all(r == per_rank[0] for r in per_rank), per_rank
    return per_rank[0]


@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_engine_tokens_equal_jax_single_device(runs, mesh):
    """The text prompt (and the video prompt at (1, 1, 2) and (1, 2, 2)),
    every rank's greedy tokens equal JAX's one-device engine's; the
    weights hold the rank's share of the heads."""
    worlds, ref = runs
    res = worlds[mesh]["fp32"]
    got = _same_on_every_rank(res["tokens"])
    assert got == ref["fp32"][:len(got)], (mesh, got, ref["fp32"])
    heads = C.valley_tiny().text.num_attention_heads // mesh[2]
    d = C.valley_tiny().text.head_dim
    assert res["wq"] == (2, heads * d, 64 // mesh[1])
    assert res["cache_heads"] == heads


@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_prefill_logits_within_bar_of_jax(runs, mesh):
    """Prefill logits of the last prompt token within 1e-5 of JAX's
    largest |logit| (the readings: about 1.2e-6)."""
    worlds, ref = runs
    want = ref["logits"][0]
    got = worlds[mesh]["fp32"]["logits"]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_BAR * scale


@pytest.mark.parametrize("mesh,name", [
    ((1, 1, 2), "int8"), ((1, 2, 2), "int8"), ((1, 1, 2), "int4gpa8"),
    ((1, 1, 2), "fused"), ((1, 1, 2), "fused_int8_cache"),
    ((1, 1, 4), "gqa")])
def test_modes_equal_jax_single_device(runs, mesh, name):
    """int8 (test_quant.py:73), int4gpa8 packed in the W4A8 bucket
    (test_quant.py:92; the row-parallel products quantize by the absmax
    over the group), the fused layout re-fused by heads (test_fused.py:85),
    an int8 cache, and 2 kv heads over 4 ranks (each rank caches the one
    its two query heads read)."""
    worlds, ref = runs
    got = _same_on_every_rank(worlds[mesh][name]["tokens"])
    assert got == ref[name], (got, ref[name])
    if name == "gqa":
        assert worlds[mesh][name]["cache_heads"] == 1


def test_sampled_stream_identical_on_every_rank(runs):
    """Every rank samples the same token from the same generator seed."""
    worlds, _ = runs
    per_rank = worlds[(1, 1, 2)]["sampled"]["tokens"]
    assert len(per_rank) == 2 and per_rank[0] == per_rank[1]


@pytest.mark.parametrize("mesh,name", [((1, 1, 2), "spec"),
                                       ((1, 2, 2), "spec_int8")])
def test_spec_decoder_equals_jax_engine(runs, mesh, name):
    """SpecDecoder over a TP engine (test_speculative.py:439, int8 at
    (1, 2, 2)): JAX's one-device greedy tokens."""
    worlds, ref = runs
    got = _same_on_every_rank(worlds[mesh][name]["tokens"])
    assert got == ref[name], (got, ref[name])


def test_two_turn_session(runs):
    """A two-turn `ChatSession` on the TP engine: its cache holds the
    rank's kv heads; the first turn equals JAX's engine, both turns the
    one-device session's."""
    worlds, ref = runs
    res = worlds[(1, 1, 2)]["session"]
    got = _same_on_every_rank(res["tokens"])
    assert got == ref["session"], (got, ref["session"])
    assert got[0] == ref["session_first"]
    assert res["cache_heads"] == 2
