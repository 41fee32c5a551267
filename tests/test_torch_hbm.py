"""The port's device-memory budget (`valley_tpu_torch/serve/hbm.py`) against
the JAX package's ``serve/hbm.py`` on the CPU, as ``tests/test_hbm.py``
tests the JAX one: the byte formulas of a cache slot, a session and a
prefix fragment against JAX's (and the caches the port allocates), the
ledger's bookkeeping, and the port's worker degrading within a budget.

The port's plain path registers ``decode_states`` (each bucket's static
decode state, which the card's graphs keep) where the JAX worker registers
``inflight`` (every concurrency slot's transient cache): the port decodes
stateless requests one at a time under its engine lock.
"""

import base64
import json
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import Engine as JEngine
from valley_tpu.models import valley as jvalley
from valley_tpu.serve import hbm as jhbm
from valley_tpu_torch import config as TC
from valley_tpu_torch.inference.engine import ChatSession, Engine, PrefixCache
from valley_tpu_torch.models import llama
from valley_tpu_torch.serve import hbm
from valley_tpu_torch.serve.model_worker import ModelWorker
from valley_tpu_torch.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch.weights import from_jax_params

GiB = hbm.GiB
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.int8, torch.int8)]


def test_fixed_over_budget_raises():
    b = hbm.HbmBudget(10_000)
    b.register_fixed("weights", 6_000)
    with pytest.raises(hbm.BudgetExceeded):
        b.register_fixed("pool", 5_000)


def test_reserve_release_update():
    b = hbm.HbmBudget(10_000)
    b.register_fixed("weights", 4_000)
    assert b.reserve("s:1", "sessions", 3_000)
    assert not b.reserve("s:2", "sessions", 4_000)   # 3k free only
    b.update("s:1", 1_000)   # estimate -> exact
    assert b.reserve("s:2", "sessions", 4_000)
    assert b.release("s:1") == 1_000
    assert b.free() == 2_000
    snap = b.snapshot()
    assert snap["used_bytes"] == 8_000
    assert snap["by"] == {"sessions": 4_000, "weights": 4_000}
    assert b.drop_fixed("weights") == 4_000 and b.used() == 4_000


def test_reserve_rereserve_same_key_replaces():
    b = hbm.HbmBudget(1_000)
    assert b.reserve("k", "x", 800)
    assert b.reserve("k", "x", 900)   # replace, not additive
    assert b.used() == 900


def test_reserve_calls_make_room_for_deficit():
    b = hbm.HbmBudget(1_000)
    b.reserve("old", "x", 900)
    asked = []

    def make_room(deficit):
        asked.append(deficit)
        return b.release("old")

    assert b.reserve("new", "x", 500, make_room)
    assert asked == [400]
    assert b.used() == 500


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16", "int8"])
def test_kv_slot_bytes_match_jax_and_init_cache(jdt, tdt):
    for jcfg, tcfg in ((C.valley_tiny(), TC.valley_tiny()),
                       (C.valley_7b(), TC.valley_7b()),
                       (C.valley_13b(), TC.valley_13b())):
        assert hbm.kv_slot_bytes(tcfg.text, tdt) == \
            jhbm.kv_slot_bytes(jcfg.text, jdt)
    cfg = TC.valley_tiny()
    cache = llama.init_cache(cfg.text, 1, 7, tdt, "cpu")
    assert hbm.tree_bytes(cache) == 7 * hbm.kv_slot_bytes(cfg.text, tdt)


@pytest.fixture(scope="module")
def engines():
    """The JAX and port engines of one tiny init, and the byte
    tokenizer."""
    tk = ByteFallbackTokenizer()
    jcfg = C.valley_tiny().replace(tokens=C.SpecialTokens(
        **tk.special_tokens().__dict__))
    params = jvalley.init_params(jcfg, jax.random.key(0), jnp.float32)
    cfg = TC.valley_tiny().replace(tokens=tk.special_tokens())
    tparams = from_jax_params(jax.device_get(params), "cpu", torch.float32)
    return {"jax": params, "tk": tk, "jcfg": jcfg, "cfg": cfg,
            "tparams": tparams}


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16", "int8"])
def test_session_and_prefix_bytes_match_jax(engines, jdt, tdt):
    """Session and fragment sizes equal JAX's formulas and the bytes the
    port's `ChatSession` and `PrefixCache` allocate; the weights' bytes
    equal JAX's tree."""
    e = engines
    jeng = JEngine(e["jcfg"], e["jax"], buckets=(64, 256),
                   max_new_tokens=16, cache_dtype=jdt, use_flash=False)
    teng = Engine(e["cfg"], e["tparams"], buckets=(64, 256),
                  max_new_tokens=16, cache_dtype=tdt)
    for extra in (None, 512):
        for bucket in (None, 64):
            assert hbm.session_cache_bytes(teng, extra, 4, bucket) == \
                jhbm.session_cache_bytes(jeng, extra, 4, bucket)
    for n in (10, 64, 65, 200):
        assert hbm.prefix_fragment_bytes(teng, n) == \
            jhbm.prefix_fragment_bytes(jeng, n)
    assert hbm.tree_bytes(teng.params) == jhbm.tree_bytes(e["jax"])
    sess = ChatSession(teng, extra_slots=512)
    sess.chat([5, 6, 7], eos_ids=[-1])
    assert hbm.tree_bytes(sess._state[0]) == hbm.session_cache_bytes(
        teng, 512, sess._decode_slack, bucket=64)
    pc = PrefixCache(teng, list(range(3, 80)), extra_slots=64)
    assert hbm.tree_bytes(pc._frag) == hbm.prefix_fragment_bytes(teng, 77)


def test_int4_dequant_bytes():
    """The int4 prefill's transient: the largest packed matrix's values
    through fp32 and bf16; nothing for unpacked trees."""
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.quant import quantize_llama_params

    cfg = TC.valley_tiny()
    params = valley.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    assert hbm.int4_dequant_bytes(params) == 0
    params = quantize_llama_params(llama.fuse_llama_params(params), bits=4,
                                   group_size=32)
    t = cfg.text
    biggest = max(2 * t.intermediate_size * t.hidden_size,
                  t.vocab_size * t.hidden_size)
    assert hbm.int4_dequant_bytes(params) == \
        biggest * hbm.INT4_DEQUANT_BYTES


# -- the worker within a budget ----------------------------------------


@pytest.fixture(scope="module")
def engine_and_tokenizer(engines):
    eng = Engine(engines["cfg"], engines["tparams"], buckets=(256,),
                 max_new_tokens=16, cache_dtype=torch.float32)
    return eng, engines["tk"]


def _png_b64(color: int) -> str:
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(np.full((32, 32, 3), color, np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _media_request(color: int, question: str, max_new: int = 4) -> dict:
    return {"prompt": "You are Valley.###Human: <image> "
                      f"{question}###Assistent:",
            "images": [_png_b64(color)], "temperature": 0.0,
            "max_new_tokens": max_new, "stop": "###"}


def _session_request(session_id: str, max_new: int = 4) -> dict:
    return {"prompt": f"Human: hello {session_id}###Assistent:",
            "temperature": 0.0, "max_new_tokens": max_new,
            "stop": "###", "session_id": session_id}


def _final(worker, params: dict):
    return [json.loads(c[:-1]) for c in
            worker.generate_stream_gate(dict(params))]


def _budget_for(eng, extra_bytes: int) -> float:
    """GiB budget = weights + the plain path's decode states + slack."""
    slot = hbm.kv_slot_bytes(eng.cfg.text, eng.cache_dtype)
    states = sum(b + eng.max_new_tokens + eng.steps_per_call
                 for b in eng.buckets) * slot
    return (hbm.tree_bytes(eng.params) + states + extra_bytes) / GiB


def test_worker_fixed_over_budget_rejected_at_startup(engine_and_tokenizer):
    eng, tk = engine_and_tokenizer
    tiny = hbm.tree_bytes(eng.params) / GiB / 2   # below the weights
    with pytest.raises(hbm.BudgetExceeded):
        ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                    hbm_budget_gb=tiny)


def test_prefix_cache_degrades_within_budget(engine_and_tokenizer):
    """Room for about one prefix fragment: distinct media evict each other
    and requests still answer; the status reports the ledger."""
    eng, tk = engine_and_tokenizer
    frag = hbm.prefix_fragment_bytes(eng, 200)
    worker = ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                         prefix_cache=8,
                         hbm_budget_gb=_budget_for(eng, int(1.5 * frag)))
    for color in (10, 20, 30):
        chunks = _final(worker, _media_request(color, "hi"))
        assert all(c["error_code"] == 0 for c in chunks), chunks
    assert len(worker._prefix_caches) == 1
    assert worker.hbm.used() <= worker.hbm.total
    stats = worker.get_status()["stats"]
    assert stats["hbm"]["used_bytes"] > 0
    assert stats["hbm"]["by"]["prefix"] == frag
    assert stats["hbm"]["by"]["decode_states"] > 0


def test_prefix_cache_skipped_when_no_room(engine_and_tokenizer):
    eng, tk = engine_and_tokenizer
    plain = ModelWorker("u", "u", "tiny", eng, tk, no_register=True)
    worker = ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                         prefix_cache=8,
                         hbm_budget_gb=_budget_for(eng, 64))
    req = _media_request(11, "what is this?")
    assert _final(worker, req)[-1]["text"] == _final(plain, req)[-1]["text"]
    assert len(worker._prefix_caches) == 0
    assert worker.prefix_budget_skips >= 1


def test_sessions_evict_across_caches_and_refuse(engine_and_tokenizer):
    eng, tk = engine_and_tokenizer
    sess_bytes = hbm.session_cache_bytes(eng, 512, eng.steps_per_call)
    worker = ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                         max_sessions=8,
                         hbm_budget_gb=_budget_for(eng,
                                                   int(1.5 * sess_bytes)))
    assert all(c["error_code"] == 0
               for c in _final(worker, _session_request("a")))
    assert all(c["error_code"] == 0
               for c in _final(worker, _session_request("b")))
    assert list(worker._sessions) == ["b"]   # "a" evicted by the ledger
    assert worker.hbm.used() <= worker.hbm.total
    worker.hbm.total = worker.hbm.used() - hbm.tree_bytes(
        worker._sessions["b"][0]._state[0]) + 64
    worker._hbm_make_room(1 << 60)
    chunks = _final(worker, _session_request("c"))
    assert chunks[-1]["error_code"] != 0
    assert "HBM budget" in chunks[-1]["text"]
    assert worker.session_refusals == 1


def test_graph_memory_replaces_the_estimate(engine_and_tokenizer):
    """After warm-up the estimate of the decode states gives way to the
    graphs' measured bytes (none on the CPU, where decode runs eagerly)."""
    eng, tk = engine_and_tokenizer
    worker = ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                         hbm_budget_gb=1.0)
    assert "decode_states" in worker.hbm.snapshot()["by"]
    assert worker.register_graph_memory() == 0
    by = worker.hbm.snapshot()["by"]
    assert "decode_states" not in by and by["graphs"] == 0
    assert ModelWorker("u", "u", "tiny", eng, tk,
                       no_register=True).register_graph_memory() is None
