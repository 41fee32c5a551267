"""Batched and continuous-batching serving on the PyTorch port against the
JAX package on the CPU (``valley_tiny``): per-row cache slots in
`llama.forward_hidden`, `Engine.generate_tokens` over B ragged prompts,
the `ContinuousEngine` pool (mirroring tests/test_continuous.py) and the
`batch_infer` JSONL runner (mirroring tests/test_batch_infer.py).

Weights come from the JAX ``init_params`` through `from_jax_params`, and
every input is made with numpy from a seed.  With fp32 trees both sides
compute the same fp32 logits up to summation order (~1e-6), far under the
gaps between top logits, so greedy tokens must be identical.  Every pool
read waits at most `TIMEOUT` seconds per token, so a hang fails the test
instead of stalling the run.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import continuous as jcontinuous
from valley_tpu.inference import engine as jengine
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu_torch.inference import batch_infer, engine
from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
from valley_tpu_torch.models import llama
from valley_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

TIMEOUT = 60.0
NEW = 12


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    return jvalley.init_params(cfg, jax.random.key(0), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu", torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _media_prompt(cfg, frames, n_text, seed):
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
        [tok.vi_end]
    return [1] + span + np.random.default_rng(seed).integers(
        5, 400, n_text).tolist()


def _frames(cfg, b, t, seed):
    size = cfg.vision.image_size
    return np.random.default_rng(seed).integers(
        0, 256, (b, t, 3, size, size)).astype(np.uint8)


# -- per-row cache slots ----------------------------------------------------


def test_per_row_slots_match_jax_and_clamp_at_the_edge(cfg, jparams,
                                                       tparams):
    """One decode step of B = 3 rows at slots (5, 17, smax + 2): the third
    row is past the end, and JAX's dynamic_update_slice clamps its write
    into the last slot; the port's explicit clamp gives the same logits
    and cache, and writes nothing else."""
    tc = cfg.text
    smax = 24
    rng = np.random.default_rng(3)
    kv = [rng.standard_normal((tc.num_hidden_layers, 3, smax, tc.kv_heads,
                               tc.head_dim)).astype(np.float32)
          for _ in range(2)]
    valid = rng.random((3, smax)) < 0.6
    slots = np.array([5, 17, smax + 2])
    valid[np.arange(3), np.minimum(slots, smax - 1)] = True
    tok = rng.integers(5, 400, (3, 1))
    pos = np.array([[30], [41], [52]])
    jl, tl = jparams["llama"], tparams["llama"]
    jcache = jllama.KVCache(jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    jh, jcache = jllama.forward_hidden(
        jl, tc, jllama.embed(jl, jnp.asarray(tok)),
        positions=jnp.asarray(pos), cache=jcache,
        cache_index=jnp.asarray(slots, jnp.int32),
        kv_valid=jnp.asarray(valid), use_flash=False)
    tcache = llama.KVCache(torch.from_numpy(kv[0].copy()),
                           torch.from_numpy(kv[1].copy()))
    th, tcache = llama.forward_hidden(
        tl, tc, llama.embed(tl, torch.from_numpy(tok)),
        positions=torch.from_numpy(pos), cache=tcache,
        cache_index=torch.from_numpy(slots), kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(_np(llama.logits_from_hidden(tl, th)),
                               _np(jllama.logits_from_hidden(jl, jh)),
                               atol=1e-4)
    for t, j, init in ((tcache.k, jcache.k, kv[0]), (tcache.v, jcache.v,
                                                     kv[1])):
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-5)
        changed = np.abs(_np(t) - init).max(axis=(0, 3, 4)) > 0  # (B, S)
        want = np.zeros((3, smax), bool)
        want[0, 5] = want[1, 17] = want[2, smax - 1] = True
        np.testing.assert_array_equal(changed, want)


def test_per_row_slots_quantize_into_an_int8_cache(cfg, tparams):
    """An int8 cache takes each row's values and scales at its own slot;
    the clamped row's land in the last slot."""
    tc = cfg.text
    cache = llama.init_cache(tc, 2, 10, torch.int8)
    valid = torch.ones((2, 10), dtype=torch.bool)
    x = llama.embed(tparams["llama"], torch.tensor([[7], [9]]))
    llama.forward_hidden(tparams["llama"], tc, x, cache=cache,
                         cache_index=torch.tensor([3, 12]), kv_valid=valid)
    written = (cache.k_scale[0] != 0).any(-1)                # (B, S)
    assert written[0].nonzero().flatten().tolist() == [3]
    assert written[1].nonzero().flatten().tolist() == [9]


# -- Engine at B > 1 ---------------------------------------------------------

CACHES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def engines(cfg, jparams, tparams):
    out = {}
    for name, (jdt, tdt) in CACHES.items():
        out[name] = (
            jengine.Engine(cfg, jparams, buckets=(64, 128),
                           max_new_tokens=NEW, cache_dtype=jdt,
                           use_flash=False, steps_per_call=4),
            engine.Engine(cfg, tparams, buckets=(64, 128),
                          max_new_tokens=NEW, cache_dtype=tdt,
                          steps_per_call=4))
    return out


def _batch(cfg, case):
    """Three ragged prompts (and their frames): lengths differ by tens of
    tokens, so decode runs with a different hole in each row's mask."""
    rng = np.random.default_rng(21)
    if case == "text":
        return [rng.integers(5, 400, n).tolist() for n in (9, 40, 23)], None
    prompts = [_media_prompt(cfg, 2, n, seed) for n, seed in
               ((4, 1), (30, 2), (15, 3))]
    return prompts, _frames(cfg, 3, 2, 4)


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("case", ["text", "video"])
def test_generate_tokens_at_b3_identical_to_jax(cfg, engines, cache, case):
    jeng, teng = engines[cache]
    prompts, frames = _batch(cfg, case)
    want = np.stack(list(jeng.generate_tokens(
        prompts, frames, jengine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])))
    got = np.stack(list(teng.generate_tokens(
        prompts, frames, engine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])))
    assert got.shape == (NEW, 3)
    np.testing.assert_array_equal(got, want)
    # each row as it would run alone
    for r, p in enumerate(prompts):
        alone = [int(t[0]) for t in teng.generate_tokens(
            [p], None if frames is None else frames[r:r + 1],
            engine.GenerationConfig(max_new_tokens=NEW), eos_ids=[-1])]
        assert alone == got[:, r].tolist()


def test_batched_eos_keeps_decoding_until_every_row_stops(cfg, engines):
    _, teng = engines["fp32"]
    prompts, _ = _batch(cfg, "text")
    gen = engine.GenerationConfig(max_new_tokens=NEW)
    toks = np.stack(list(teng.generate_tokens(prompts, None, gen,
                                              eos_ids=[-1])))
    eos = int(toks[1, 0])
    got = np.stack(list(teng.generate_tokens(prompts, None, gen,
                                             eos_ids=[eos])))
    alive = np.ones(3, bool)
    for i in range(len(got)):
        assert alive.any()
        alive &= got[i] != eos
    assert not alive.any() or len(got) == NEW
    np.testing.assert_array_equal(got, toks[:len(got)])


def test_bf16_batched_prefill_logits_near_jax(cfg):
    """bf16 leaves, as the card serves, at B = 3 with video: the port's
    prefill runs the library's bf16 products and the lm_head GEMV's plain
    version (fp32 products of the bf16 weights, where JAX multiplies in
    bf16); both round activations to bf16 between ops.  Bar: within 4e-2
    of the largest |logit|, about twice the largest reading.  Readings, by
    row: 1.56e-2, 1.58e-2, 2.11e-2 (the B = 1 bf16 readings of
    tests/test_torch_int4.py reach 1.49e-2)."""
    tree = jax.device_get(jvalley.init_params(cfg, jax.random.key(11),
                                              jnp.bfloat16))
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree),
                          buckets=(64,), max_new_tokens=NEW,
                          cache_dtype=jnp.bfloat16, use_flash=False)
    teng = engine.Engine(cfg, from_jax_params(tree, "cpu", torch.bfloat16),
                         buckets=(64,), max_new_tokens=NEW)
    prompts, frames = _batch(cfg, "video")
    lens = np.array([len(p) for p in prompts], np.int32)
    ids = np.zeros((3, 64), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    imgs, frame_mask, has = jeng._prepare_images(frames, 3)
    _, want, _, _ = jeng._prefill(
        jeng.params, jnp.asarray(ids), imgs, jnp.asarray(lens),
        jax.random.key(0), 1.0, 1.0, frame_mask, bucket=64,
        cache_len=64 + NEW + jeng.steps_per_call, do_sample=False,
        has_images=has)
    want = _np(want)
    got = teng.prefill(prompts, frames).logits.numpy()
    diff = np.abs(got - want).max() / np.abs(want).max()
    assert diff <= 4e-2, diff


def test_prefill_takes_per_row_sampling_and_cache_len(cfg, engines):
    """`_prefill` with (B,) temperatures (a greedy row beside a sampled
    one) and a cache length of the caller's."""
    _, teng = engines["fp32"]
    prompts, _ = _batch(cfg, "text")
    ids = torch.zeros((3, 64), dtype=torch.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    temps = torch.tensor([0.0, 5.0, 0.0])
    tok, logits, cache, valid = teng._prefill(
        ids, None, lens, torch.Generator().manual_seed(0), temps,
        torch.ones(3), True, 200)
    assert cache.max_len == 200 and valid.shape == (3, 200)
    greedy = logits.argmax(-1)
    assert tok[0] == greedy[0] and tok[2] == greedy[2]


# -- ContinuousEngine -----------------------------------------------------


@pytest.fixture(scope="module")
def jeng(cfg, jparams):
    return jengine.Engine(cfg, jparams, buckets=(64,), max_new_tokens=32,
                          cache_dtype=jnp.float32, use_flash=False,
                          steps_per_call=2)


@pytest.fixture(scope="module")
def teng(cfg, tparams):
    return engine.Engine(cfg, tparams, buckets=(64,), max_new_tokens=32,
                         cache_dtype=torch.float32, steps_per_call=2)


@pytest.fixture(scope="module")
def cont(teng):
    pool = ContinuousEngine(teng, rows=3, bucket=64, extra_slots=64,
                            steps_per_call=2)
    yield pool
    pool.close()


_SOLO: dict = {}


def _solo(eng, prompt, n, images=None):
    """The JAX engine's greedy tokens for one prompt alone (memoised)."""
    key = (id(eng), tuple(prompt), n, None if images is None
           else images.tobytes())
    if key not in _SOLO:
        gen = jengine.GenerationConfig(max_new_tokens=n, do_sample=False)
        _SOLO[key] = [int(t[0]) for t in eng.generate_tokens(
            [prompt], images, gen=gen, eos_ids=[-1])]
    return _SOLO[key]


def _collect(outq):
    return list(_drain(outq, timeout=TIMEOUT))


def test_single_request_matches_engine(jeng, cont):
    prompt = list(range(10, 40))
    expect = _solo(jeng, prompt, 6)
    assert _collect(cont.submit(prompt, max_new_tokens=6,
                                eos_id=-1)) == expect


def test_mid_flight_join_does_not_perturb(jeng, cont):
    """A request joining mid-decode does not change another row's
    tokens."""
    a = list(range(10, 40))
    b = list(range(45, 60))
    expect_a = _solo(jeng, a, 20)
    expect_b = _solo(jeng, b, 6)
    qa = cont.submit(a, max_new_tokens=20, eos_id=-1)
    got_a = [qa.get(timeout=TIMEOUT)]
    time.sleep(0.2)
    qb = cont.submit(b, max_new_tokens=6, eos_id=-1)
    got_b = _collect(qb)
    got_a += _collect(qa)
    assert got_a == expect_a
    assert got_b == expect_b


def test_row_reuse_after_finish(jeng, cont):
    p1 = list(range(20, 35))
    p2 = list(range(36, 50))
    assert _collect(cont.submit(p1, max_new_tokens=4,
                                eos_id=-1)) == _solo(jeng, p1, 4)
    assert _collect(cont.submit(p2, max_new_tokens=5,
                                eos_id=-1)) == _solo(jeng, p2, 5)


def test_more_requests_than_rows(jeng, cont):
    prompts = [list(range(10 + i, 30 + i)) for i in range(5)]
    expects = [_solo(jeng, p, 4) for p in prompts]
    queues = [cont.submit(p, max_new_tokens=4, eos_id=-1) for p in prompts]
    assert [_collect(q) for q in queues] == expects


def test_media_and_text_requests_share_the_pool(cfg, jeng, cont):
    v = _media_prompt(cfg, 2, 12, 5)
    frames = _frames(cfg, 1, 2, 6)
    t = list(range(60, 90))
    expect_v = _solo(jeng, v, 8, frames)
    expect_t = _solo(jeng, t, 8)
    qv = cont.submit(v, images=frames, max_new_tokens=8, eos_id=-1)
    qt = cont.submit(t, max_new_tokens=8, eos_id=-1)
    assert _collect(qv) == expect_v
    assert _collect(qt) == expect_t


def test_pool_tokens_equal_the_jax_pool(jeng, teng):
    """The two pools, each fed the same join, stream the same tokens."""
    a, b = list(range(11, 41)), list(range(50, 62))
    jpool = jcontinuous.ContinuousEngine(jeng, rows=2, bucket=64,
                                         extra_slots=64, steps_per_call=2)
    tpool = ContinuousEngine(teng, rows=2, bucket=64, extra_slots=64,
                             steps_per_call=2)
    try:
        got = []
        for pool, drain in ((jpool, jcontinuous._drain), (tpool, _collect)):
            qa = pool.submit(a, max_new_tokens=10, eos_id=-1)
            first = qa.get(timeout=TIMEOUT)
            qb = pool.submit(b, max_new_tokens=5, eos_id=-1)
            got.append(([first] + list(drain(qa)), list(drain(qb))))
        assert got[0] == got[1]
    finally:
        tpool.close()


def test_mixed_bucket_admission_token_identical(cfg, jparams, tparams):
    """A short prompt admitted through a small prefill bucket mid-decode
    gives the tokens of a solo run without perturbing the long row."""
    multi_j = jengine.Engine(cfg, jparams, buckets=(16, 64),
                             max_new_tokens=32, cache_dtype=jnp.float32,
                             use_flash=False, steps_per_call=2)
    multi = engine.Engine(cfg, tparams, buckets=(16, 64), max_new_tokens=32,
                          cache_dtype=torch.float32, steps_per_call=2)
    c = ContinuousEngine(multi, rows=2, bucket=64, extra_slots=64,
                         steps_per_call=2)
    try:
        assert c._admission_buckets == (16, 64)
        long_p = list(range(10, 50))        # bucket 64
        short_p = list(range(50, 62))       # 12 tokens: bucket 16
        expect_long = _solo(multi_j, long_p, 16)
        expect_short = _solo(multi_j, short_p, 5)
        qa = c.submit(long_p, max_new_tokens=16, eos_id=-1)
        got_long = [qa.get(timeout=TIMEOUT)]
        time.sleep(0.2)
        qb = c.submit(short_p, max_new_tokens=5, eos_id=-1)
        got_short = _collect(qb)
        got_long += _collect(qa)
        assert got_long == expect_long
        assert got_short == expect_short
    finally:
        c.close()


def test_batched_admission_token_identical(jeng, teng):
    """A burst of compatible requests admits through batched prefills of
    power-of-two sizes, and every stream equals its solo run."""
    c = ContinuousEngine(teng, rows=6, bucket=64, extra_slots=64,
                         steps_per_call=2, admit_batch=4)
    try:
        prompts = [list(range(10 + i, 30 + i)) for i in range(6)]
        expects = [_solo(jeng, p, 5) for p in prompts]
        queues = [c.submit(p, max_new_tokens=5, eos_id=-1)
                  for p in prompts]
        assert [_collect(q) for q in queues] == expects
        calls = c.prefill_sizes
        assert max(calls) > 1, calls
        assert sum(calls) == 6
        assert all(n in (1, 2, 4) for n in calls), calls
    finally:
        c.close()


def test_batched_admission_respects_incompatible_groups(jeng, teng):
    """Sampled and greedy requests never share a prefill, and both
    finish."""
    c = ContinuousEngine(teng, rows=4, bucket=64, extra_slots=64,
                         steps_per_call=2, admit_batch=4)
    try:
        greedy = [list(range(10 + i, 30 + i)) for i in range(2)]
        sampled = [list(range(40 + i, 60 + i)) for i in range(2)]
        expects = [_solo(jeng, p, 4) for p in greedy]
        qs = [c.submit(p, max_new_tokens=4, eos_id=-1) for p in greedy]
        qs += [c.submit(p, max_new_tokens=4, eos_id=-1, temperature=0.8)
               for p in sampled]
        results = [_collect(q) for q in qs]
        assert results[:2] == expects
        assert all(len(r) == 4 for r in results)
        assert len(c.prefill_sizes) >= 2
    finally:
        c.close()


def test_prompt_pad_compaction_extends_budget(jeng, teng):
    """Decode slots start at len(prompt): a row takes smax - len tokens."""
    c = ContinuousEngine(teng, rows=1, bucket=64, extra_slots=8,
                         steps_per_call=2)   # smax = 72
    try:
        p = list(range(10, 20))
        got = _collect(c.submit(p, max_new_tokens=40, eos_id=-1))
        assert len(got) == 40
        assert got[:20] == _solo(jeng, p, 20)
    finally:
        c.close()


def test_pooled_decode_ramp_token_identical_and_schedule(jeng, teng):
    """A ramped pool gives the unramped tokens and decodes ramp-size chunks
    while a row is young, then ``steps``, and re-enters the ramp when a
    request joins."""
    c = ContinuousEngine(teng, rows=2, bucket=64, extra_slots=64,
                         steps_per_call=4, decode_ramp=(1, 2))
    sizes = []
    orig = c._decode_chunk

    def spy(n_steps):
        sizes.append(n_steps)
        return orig(n_steps)

    c._decode_chunk = spy
    try:
        a = list(range(10, 40))
        assert _collect(c.submit(a, max_new_tokens=16,
                                 eos_id=-1)) == _solo(jeng, a, 16)
        assert sizes[0] == 1 and sizes[1] == 2
        assert set(sizes) <= {1, 2, 4} and sizes[-1] == 4
        sizes.clear()
        b = list(range(45, 60))
        qa = c.submit(a, max_new_tokens=24, eos_id=-1)
        got_a = [qa.get(timeout=TIMEOUT)]
        deadline = time.time() + TIMEOUT
        while not sizes or sizes[-1] != 4:
            assert time.time() < deadline
            time.sleep(0.01)
        qb = c.submit(b, max_new_tokens=6, eos_id=-1)
        got_b = _collect(qb)
        got_a += _collect(qa)
        assert got_a == _solo(jeng, a, 24)
        assert got_b == _solo(jeng, b, 6)
        assert 1 in sizes[sizes.index(4):], "join did not re-enter the ramp"
    finally:
        c.close()


def test_bad_request_fails_without_killing_scheduler(jeng, cont):
    outq = cont.submit(list(range(5, 205)), max_new_tokens=4, eos_id=-1)
    with pytest.raises(ValueError, match="bucket"):
        _collect(outq)
    p = list(range(12, 44))
    assert _collect(cont.submit(p, max_new_tokens=4,
                                eos_id=-1)) == _solo(jeng, p, 4)


def test_eos_ends_row_early(jeng, cont):
    prompt = list(range(10, 40))
    probe = _solo(jeng, prompt, 8)
    got = _collect(cont.submit(prompt, max_new_tokens=8, eos_id=probe[2]))
    assert got == probe[:probe.index(probe[2]) + 1]


def test_idle_row_parks_at_the_last_slot(jeng, teng):
    """With one request in a two-row pool, the idle row advances past
    ``smax - 1`` every step, its writes clamp into the last slot, and the
    active row's tokens are those of a solo run."""
    c = ContinuousEngine(teng, rows=2, bucket=64, extra_slots=16,
                         steps_per_call=2)          # smax = 80
    try:
        p = list(range(15, 35))
        assert _collect(c.submit(p, max_new_tokens=12,
                                 eos_id=-1)) == _solo(jeng, p, 12)
        idle = 1 if c._slot[0] < c.smax - 1 else 0
        assert int(c._slot[idle]) >= c.smax - 1 + 10
        written = (c._cache.k[0, idle].abs().sum(dim=(-1, -2)) != 0)
        assert written.nonzero().flatten().tolist() == [c.smax - 1]
    finally:
        c.close()


def test_unported_pool_options_raise(teng):
    with pytest.raises(NotImplementedError, match="speculative"):
        ContinuousEngine(teng, rows=1, speculative=True)
    c = ContinuousEngine(teng, rows=1, bucket=64, extra_slots=8)
    try:
        with pytest.raises(NotImplementedError, match="PrefixCache"):
            c.submit([5, 6], prefix=object())
    finally:
        c.close()


def test_close_stops_both_threads(teng):
    """Closing ends both threads and fails every request not yet served:
    here one left in the queue after the prefill thread has stopped."""
    c = ContinuousEngine(teng, rows=1, bucket=64, extra_slots=8)
    c._queue.put(None)                       # the prefill thread stops first
    c._prefill_thread.join(timeout=10)
    queued = c.submit([5, 6, 7], max_new_tokens=3, eos_id=-1)
    c.close(timeout=10)
    assert not c._thread.is_alive() and not c._prefill_thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        list(_drain(queued, timeout=5))
    with pytest.raises(RuntimeError, match="closed"):
        c.submit([5, 6])


def test_launch_counts_keep_every_update_across_threads():
    """The pool launches kernels from two threads: a wrapper's launch count
    loses no update with 8 threads adding to it under a 1 us switch
    interval."""
    import sys
    import threading

    from valley_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16000


def test_continuous_warmup(teng):
    c = ContinuousEngine(teng, rows=2, bucket=64, extra_slots=32,
                         steps_per_call=2)
    try:
        c.warmup(frames=2)
        got = _collect(c.submit(list(range(10, 20)), max_new_tokens=3,
                                eos_id=-1))
        assert len(got) == 3
        assert 2 in c.prefill_sizes
    finally:
        c.close()


# -- batch_infer ------------------------------------------------------------


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(
        d / "img.png")
    vdir = d / "clip"
    vdir.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 56, 3),
                                     dtype=np.uint8)).save(
            vdir / f"{i:03d}.png")
    return d


def _args(tmp_path, extra=()):
    return batch_infer.build_parser().parse_args([
        "--model-path", "random:tiny", "--device", "cpu",
        "--input", str(tmp_path / "in.jsonl"),
        "--output", str(tmp_path / "out.jsonl"),
        "--rows", "2", "--admit-batch", "1",
        "--buckets", "128", "--kv-cache", "bf16",
        "--max-new-tokens", "8", "--steps-per-call", "4",
        "--num-frames", "2", "--system-prompt", "sys",
        "--inflight", "4", *extra])


def test_batch_infer_end_to_end_and_resume(tmp_path, media_dir):
    reqs = [
        {"id": "t1", "query": "hello there"},
        {"id": "t2", "query": "short", "max_new_tokens": 4,
         "temperature": 1.0},
        {"id": "v1", "video": str(media_dir / "clip"),
         "query": "Describe the video."},
        {"id": "i1", "image": str(media_dir / "img.png"),
         "query": "What is shown?"},
    ]
    _write_jsonl(tmp_path / "in.jsonl", reqs)
    args = _args(tmp_path)
    summary = batch_infer.run_batch(args)
    assert summary["ran"] == 4 and summary["errors"] == 0
    out = {json.loads(line)["id"]: json.loads(line)
           for line in open(tmp_path / "out.jsonl")}
    assert set(out) == {"t1", "t2", "v1", "i1"}
    for rec in out.values():
        assert isinstance(rec["response"], str)
        assert rec["tokens"] >= 1
        assert rec["ttft_s"] is not None
    assert out["t2"]["tokens"] <= 4
    # resume: nothing left to run
    summary2 = batch_infer.run_batch(args)
    assert summary2["ran"] == 0 and summary2["skipped"] == 4
    # a new line runs alone
    _write_jsonl(tmp_path / "in.jsonl", reqs + [
        {"id": "t3", "query": "another"}])
    summary3 = batch_infer.run_batch(args)
    assert summary3["ran"] == 1 and summary3["skipped"] == 4
    assert sum(1 for _ in open(tmp_path / "out.jsonl")) == 5


def test_batch_infer_bad_rows_are_isolated(tmp_path):
    _write_jsonl(tmp_path / "in.jsonl", [
        {"id": "bad", "video": str(tmp_path / "missing.mp4"), "query": "x"},
        {"id": "ok", "query": "fine"},
    ])
    summary = batch_infer.run_batch(_args(tmp_path))
    assert summary["ran"] == 2 and summary["errors"] == 1
    out = {json.loads(line)["id"]: json.loads(line)
           for line in open(tmp_path / "out.jsonl")}
    assert "error" in out["bad"] and "response" in out["ok"]


def test_batch_infer_loaders_and_refusals(tmp_path, monkeypatch):
    (tmp_path / "in.jsonl").write_text('{"noquery": 1}\n')
    with pytest.raises(ValueError, match="missing 'query'"):
        batch_infer._load_requests(str(tmp_path / "in.jsonl"))
    (tmp_path / "out.jsonl").write_text(
        '{"id": "a"}\n{"broken json\n{"noid": 1}\n')
    assert batch_infer._done_ids(str(tmp_path / "out.jsonl")) == {"a"}
    _write_jsonl(tmp_path / "in.jsonl", [{"id": "q", "query": "hi"}])
    with pytest.raises(NotImplementedError, match="speculative"):
        batch_infer.run_batch(_args(tmp_path, ["--speculative"]))
    # without --device cpu it wants the card, and there is none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path)
    args.device = None
    with pytest.raises(RuntimeError, match="--device cpu"):
        batch_infer.run_batch(args)
