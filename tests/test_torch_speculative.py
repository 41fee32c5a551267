"""Self-speculative decoding of the PyTorch port (`SpecDecoder`,
`SpecChatSession`, the speculative pool, `ngram_draft`,
`spec_sample_round`, `resolved_disable_below`, the ``--speculative``
entry points) against the JAX package on the CPU, mirroring
``tests/test_speculative.py``.

One JAX init of the tiny model (fp32) feeds both packages through
``from_jax_params``; the int8 and int4gp trees are that init quantized by
the JAX quantizer.  Greedy tokens must be identical, and so must the tokens
each verify round emits (recorded through each decoder's telemetry hook):
both sides compute the same fp32 logits up to summation order (~1e-6), far
below the gaps between the top logits of these prompts.  The n-gram lookup
is integer work and must be bit-equal.  Sampled rounds draw from a
``torch.Generator`` where JAX draws from threefry keys, so they are held to
the exact chain law by a Monte-Carlo bar, not to JAX's draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from valley_tpu import config as C
from valley_tpu.inference import continuous as jcont
from valley_tpu.inference import engine as jengine
from valley_tpu.inference import speculative as jspec
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import quant as jquant
from valley_tpu_torch.inference import continuous, engine, speculative
from valley_tpu_torch.inference.speculative import (SpecChatSession,
                                                    SpecConfig, SpecDecoder)
from valley_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def trees(cfg):
    """The JAX trees of one init: fp32, int8 (per channel, unfused), fused
    int4gp at group 32 (nibble-packed), and the constant-filled model whose
    greedy output is one token forever."""
    base = jvalley.init_params(cfg, jax.random.key(0), jnp.float32)

    def copy():
        return jax.tree.map(lambda x: x, base)

    const = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), base)
    return {"fp32": jax.device_get(base),
            "int8": jax.device_get(jquant.quantize_llama_params(copy())),
            "int4gp": jax.device_get(jquant.pack_int4_params(
                jquant.quantize_llama_params(
                    jllama.fuse_llama_params(copy()), bits=4,
                    group_size=32))),
            "const": jax.device_get(const)}


CACHES = {"fp32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def _engines(cfg, trees, weights="fp32", cache="fp32", **kw):
    """A JAX engine and the port's on the same weights and cache dtype."""
    kw = {"buckets": (128,), "max_new_tokens": 24, "steps_per_call": 4,
          **kw}
    tree = trees[weights]
    jdt, tdt = CACHES[cache]
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree),
                          cache_dtype=jdt, use_flash=False,
                          w4_packed=weights == "int4gp", **kw)
    teng = engine.Engine(cfg, from_jax_params(tree, "cpu", torch.float32),
                         cache_dtype=tdt, **kw)
    return jeng, teng


def _span(cfg, frames=2):
    tok = cfg.tokens
    return [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
        [tok.vi_end]


def _frames(cfg, frames=2):
    return np.random.default_rng(0).standard_normal(
        (1, frames, 3, cfg.vision.image_size, cfg.vision.image_size)
    ).astype(np.float32)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return {"video": [1] + _span(cfg) + list(range(5, 30)),
            "repetitive": [1] + [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8],
            "random": [1] + rng.integers(5, 400, size=40).tolist()}


def _recording(dec):
    """Record every telemetry update of ``dec`` (one per round: its emitted
    count; one per disable) in a list, as both packages make them."""
    log = []
    count = dec._count

    def rec(rounds=0, emitted=0, disabled=0):
        log.append((rounds, emitted, disabled))
        count(rounds, emitted, disabled)

    dec._count = rec
    return log


def _gens(**kw):
    return (jengine.GenerationConfig(**kw), engine.GenerationConfig(**kw))


def _spec_pair(jeng, teng, **kw):
    return (jspec.SpecDecoder(jeng, jspec.SpecConfig(**kw)),
            SpecDecoder(teng, SpecConfig(**kw)))


def _plain(teng, prompt, images, gen):
    return [int(t[0]) for t in teng.generate_tokens([prompt], images, gen,
                                                    eos_ids=[-1])]


# -- the n-gram lookup and the rejection round --------------------------------


@pytest.mark.parametrize("ngram,draft_len", [(2, 3), (3, 4), (4, 8)])
def test_ngram_draft_bit_equal_to_jax(ngram, draft_len):
    """Seeded random histories over a 6-token alphabet (so matches of every
    length occur), every history length from 0 to Hmax, rows batched in the
    port and one at a time in JAX: the drafts are equal."""
    rng = np.random.default_rng(ngram)
    hmax = 40
    hist = rng.integers(0, 6, size=(48, hmax))
    lens = np.concatenate([np.arange(hmax + 1),
                           rng.integers(0, hmax + 1, size=7)])
    hist = np.concatenate([hist, hist[:1]])[:len(lens)]
    got = speculative.ngram_draft(torch.from_numpy(hist),
                                  torch.from_numpy(lens), draft_len, ngram)
    for row, n, g in zip(hist, lens, got.numpy()):
        want = jspec.ngram_draft(jnp.asarray(row, jnp.int32), jnp.int32(n),
                                 draft_len, ngram)
        np.testing.assert_array_equal(g, np.asarray(want))


def test_ngram_draft_prefers_longest_match():
    """JAX tests/test_speculative.py:160 and :288: the tail (5, 6) at
    length 2, and a later 2-gram match against an earlier full 3-gram."""
    hist = torch.tensor([[5, 6, 7, 8, 0, 5, 6] + [0] * 9])
    assert speculative.ngram_draft(hist, torch.tensor([7]), 3, 2)[0]\
        .tolist() == [7, 8, 0]
    hist = torch.tensor([[5, 6, 7, 42, 43, 0, 6, 7, 99, 98, 5, 6, 7]
                         + [0] * 3])
    n = torch.tensor([13])
    assert speculative.ngram_draft(hist, n, 2, 2)[0].tolist() == [99, 98]
    assert speculative.ngram_draft(hist, n, 2, 3)[0].tolist() == [42, 43]


def test_spec_sample_round_is_distribution_exact():
    """200,000 rounds of one row batched in one call against the exact
    sequential-sampling chain law of JAX tests/test_speculative.py:119:
    P(a) = p0(a) for a != x0, P(x0, b) = p0(x0) p1(b) for b != x1,
    P(x0, x1, c) = p0(x0) p1(x1) p2(c).  Bar: every sequence's frequency
    within 5 binomial standard deviations (plus 1e-4) of its probability,
    and no impossible sequence emitted."""
    v = 5
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(v), size=3).astype(np.float32)
    x0, x1 = 2, 4
    n = 200_000
    emit, m = speculative.spec_sample_round(
        torch.from_numpy(probs)[None].expand(n, 3, v),
        torch.tensor([[x0, x1]]).expand(n, 2),
        torch.Generator().manual_seed(0))
    emit, m = emit.numpy(), m.numpy()
    counts = {}
    for k in range(3):
        rows = emit[m == k, :k + 1]
        seqs, cnt = np.unique(rows, axis=0, return_counts=True)
        for sq, c in zip(seqs, cnt):
            counts[tuple(int(t) for t in sq)] = int(c)
    exact = {(a,): probs[0, a] for a in range(v) if a != x0}
    exact.update({(x0, b): probs[0, x0] * probs[1, b]
                  for b in range(v) if b != x1})
    exact.update({(x0, x1, c): probs[0, x0] * probs[1, x1] * probs[2, c]
                  for c in range(v)})
    assert abs(sum(exact.values()) - 1.0) < 1e-5
    assert set(counts) <= set(exact)
    for sq, p in exact.items():
        got = counts.get(sq, 0) / n
        assert abs(got - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4, \
            (sq, p, got)


def test_spec_sample_round_point_mass_is_greedy():
    """A one-hot target (the pool's greedy rows) accepts exactly the
    drafts equal to its argmax and corrects with the argmax."""
    v, d = 7, 4
    target = torch.tensor([[3, 1, 4, 1, 5], [2, 2, 2, 2, 2]])
    probs = torch.nn.functional.one_hot(target, v).float()
    draft = torch.tensor([[3, 1, 0, 1], [2, 2, 2, 2]])
    emit, m = speculative.spec_sample_round(probs, draft,
                                            torch.Generator().manual_seed(1))
    assert m.tolist() == [2, d]
    assert emit[0, :3].tolist() == [3, 1, 4] and emit[1].tolist() == [2] * 5


# -- SpecDecoder --------------------------------------------------------------


@pytest.mark.parametrize("case", ["video", "repetitive", "random"])
@pytest.mark.parametrize("disable_below", [None, 0.0])
def test_spec_decoder_tokens_and_rounds_equal_jax(cfg, trees, case,
                                                  disable_below):
    """Greedy tokens and every round's emitted count (and the disable) of
    the port's SpecDecoder equal JAX's, and the tokens equal the port's
    plain Engine; with the default threshold the random model's low
    acceptance disables after the probe, with 0 every round runs."""
    jeng, teng = _engines(cfg, trees)
    jdec, tdec = _spec_pair(jeng, teng, draft_len=4, rounds_per_call=3,
                            disable_below=disable_below)
    jlog, tlog = _recording(jdec), _recording(tdec)
    prompt = _prompts(cfg)[case]
    images = _frames(cfg) if case == "video" else None
    jgen, tgen = _gens(max_new_tokens=24, do_sample=False)
    want = list(jdec.generate_tokens(prompt, images, jgen, eos_ids=[-1]))
    got = list(tdec.generate_tokens(prompt, images, tgen, eos_ids=[-1]))
    assert got == want == _plain(teng, prompt, images, tgen)
    assert tlog == jlog and len(tlog) >= 4
    assert tdec.total_rounds == jdec.total_rounds
    assert tdec.total_emitted == jdec.total_emitted


def test_full_acceptance_on_the_degenerate_model(cfg, trees):
    """Constant weights: greedy emits one token forever.  The history holds
    a match of its 2-token tail (token, token) from the fourth round on, and
    from then every round accepts all D drafts and emits D + 1 tokens; the
    tokens and rounds equal JAX's and plain decode's."""
    jeng, teng = _engines(cfg, trees, "const", max_new_tokens=32)
    jdec, tdec = _spec_pair(jeng, teng, draft_len=4, rounds_per_call=2,
                            disable_below=0.0)
    jlog, tlog = _recording(jdec), _recording(tdec)
    prompt = [1] + list(range(5, 20))
    jgen, tgen = _gens(max_new_tokens=32, do_sample=False)
    want = list(jdec.generate_tokens(prompt, None, jgen, eos_ids=[-1]))
    got = list(tdec.generate_tokens(prompt, None, tgen, eos_ids=[-1]))
    assert got == want == _plain(teng, prompt, None, tgen)
    assert len(set(got)) <= 2
    assert tlog == jlog
    counts = [e for r, e, _ in tlog if r]
    assert counts[:3] == [1, 1, 1] and counts[3:] == [5] * (len(counts) - 3)
    assert len(counts) > 4 and tdec.disabled == 0


def test_eos_mid_round_stops(cfg, trees):
    """An eos emitted inside a round ends the reply there."""
    _, teng = _engines(cfg, trees, max_new_tokens=16)
    dec = SpecDecoder(teng, SpecConfig(draft_len=4, rounds_per_call=2,
                                       disable_below=0.0))
    gen = engine.GenerationConfig(max_new_tokens=16, do_sample=False)
    prompt = [1] + list(range(5, 20))
    ref = _plain(teng, prompt, None, gen)
    assert list(dec.generate_tokens(prompt, None, gen,
                                    eos_ids=[ref[5]])) == ref[:6]


def test_temperature_zero_sampling_is_greedy(cfg, trees):
    """do_sample with temperature < 1e-4 follows the worker's argmax rule."""
    _, teng = _engines(cfg, trees, max_new_tokens=16)
    dec = SpecDecoder(teng, SpecConfig(draft_len=4, rounds_per_call=2))
    prompt = [1] + list(range(5, 20))
    greedy = list(dec.generate_tokens(prompt, None, engine.GenerationConfig(
        max_new_tokens=16, do_sample=False), eos_ids=[-1]))
    temp0 = list(dec.generate_tokens(prompt, None, engine.GenerationConfig(
        max_new_tokens=16, do_sample=True, temperature=0.0), eos_ids=[-1]))
    assert temp0 == greedy


@pytest.mark.parametrize("disable_below", [0.0, 10.0])
def test_sampled_draws_repeat_by_seed_and_vary_with_it(cfg, trees,
                                                       disable_below):
    """A sampled reply, by rounds throughout (threshold 0) or switching to
    plain decode after the probe (threshold 10): 16 tokens in the
    vocabulary, the same under one seed, different under another."""
    _, teng = _engines(cfg, trees, max_new_tokens=16)
    dec = SpecDecoder(teng, SpecConfig(draft_len=4, rounds_per_call=3,
                                       probe_rounds=1,
                                       disable_below=disable_below))
    outs = []
    for seed in (0, 0, 1):
        gen = engine.GenerationConfig(max_new_tokens=16, do_sample=True,
                                      temperature=1.3, top_p=0.9, seed=seed)
        toks = list(dec.generate_tokens([1, 7, 8, 9, 7, 8, 9, 7], None, gen,
                                        eos_ids=[-1]))
        assert len(toks) == 16
        assert all(0 <= t < cfg.text.vocab_size for t in toks)
        outs.append(toks)
    assert outs[0] == outs[1] and outs[0] != outs[2]


@pytest.mark.parametrize("weights,cache", [("int8", "int8"),
                                           ("int4gp", "int8")])
def test_quantized_weights_and_int8_cache_equal_jax(cfg, trees, weights,
                                                    cache):
    """int8 weights with an int8 cache, and fused int4gp at group 32 with an
    int8 cache: tokens and rounds equal JAX's (``w4_packed``) and the
    port's plain decode."""
    jeng, teng = _engines(cfg, trees, weights, cache, max_new_tokens=16)
    jdec, tdec = _spec_pair(jeng, teng, draft_len=4, rounds_per_call=2,
                            disable_below=0.0)
    jlog, tlog = _recording(jdec), _recording(tdec)
    prompt = [7, 8, 9, 7, 8, 9, 7, 8] + list(range(10, 24))
    jgen, tgen = _gens(max_new_tokens=16, do_sample=False)
    want = list(jdec.generate_tokens(prompt, None, jgen, eos_ids=[-1]))
    got = list(tdec.generate_tokens(prompt, None, tgen, eos_ids=[-1]))
    assert got == want == _plain(teng, prompt, None, tgen)
    assert tlog == jlog


def test_forced_disable_is_token_identical_and_counted(cfg, trees):
    """A threshold no round meets: every reply switches to plain decode
    after its probe, stays token-identical, and each switch is counted."""
    jeng, teng = _engines(cfg, trees)
    jdec, tdec = _spec_pair(jeng, teng, draft_len=4, rounds_per_call=3,
                            probe_rounds=1, disable_below=10.0)
    jgen, tgen = _gens(max_new_tokens=24, do_sample=False)
    for case, prompt in _prompts(cfg).items():
        images = _frames(cfg) if case == "video" else None
        want = list(jdec.generate_tokens(prompt, images, jgen, eos_ids=[-1]))
        got = list(tdec.generate_tokens(prompt, images, tgen, eos_ids=[-1]))
        assert got == want == _plain(teng, prompt, images, tgen)
    assert tdec.disabled == jdec._shared["disabled"] == 3


def test_threshold_zero_never_disables(cfg, trees):
    _, teng = _engines(cfg, trees, max_new_tokens=16)
    dec = SpecDecoder(teng, SpecConfig(draft_len=4, rounds_per_call=3,
                                       probe_rounds=1, disable_below=0.0))
    got = list(dec.generate_tokens(_prompts(cfg)["random"], None,
                                   engine.GenerationConfig(
                                       max_new_tokens=16, do_sample=False),
                                   eos_ids=[-1]))
    assert len(got) == 16 and dec.disabled == 0


def test_disable_below_resolves_per_weight_mode(cfg, trees):
    """JAX tests/test_speculative.py:508: 0.40 for fp32 and int8 weights,
    1.70 for 4-bit (in the port: nibble-packed uint8) weights, an explicit
    value always wins, read at each check."""
    engines = {w: _engines(cfg, trees, w, "int8", max_new_tokens=8)[1]
               for w in ("fp32", "int8", "int4gp")}
    default = SpecConfig()
    assert default.disable_below is None
    assert speculative.resolved_disable_below(default, engines["fp32"]) == \
        speculative.DISABLE_BELOW_DEFAULT == jspec.DISABLE_BELOW_DEFAULT
    assert speculative.resolved_disable_below(default, engines["int8"]) == \
        speculative.DISABLE_BELOW_DEFAULT
    assert speculative.resolved_disable_below(default, engines["int4gp"]) \
        == speculative.DISABLE_BELOW_W4 == jspec.DISABLE_BELOW_W4
    forced = SpecConfig(disable_below=10.0)
    assert speculative.resolved_disable_below(forced, engines["int4gp"]) \
        == 10.0
    forced.disable_below = None
    assert speculative.resolved_disable_below(forced, engines["int4gp"]) \
        == speculative.DISABLE_BELOW_W4


def test_decoders_share_graphs_and_telemetry(cfg, trees):
    """JAX tests/test_speculative.py:306: decoders of one engine and
    (draft_len, ngram) share their graphs and counters; another config
    gets its own."""
    _, teng = _engines(cfg, trees, buckets=(64,), max_new_tokens=16)
    d1, d2 = SpecDecoder(teng), SpecDecoder(teng)
    assert d1.graph_sets is d2.graph_sets
    d1.total_rounds += 3
    d2.total_emitted += 5
    assert d2.total_rounds == 3 and d1.total_emitted == 5
    d3 = SpecDecoder(teng, SpecConfig(draft_len=4))
    assert d3.graph_sets is not d1.graph_sets and d3.total_rounds == 0


# -- sessions -----------------------------------------------------------------


def _turns(cfg):
    return [[1] + _span(cfg) + [7, 8, 9, 7, 8, 9, 7, 8],
            list(range(30, 42)), [7, 8, 9, 7, 8]]


def _converse(sess, turns, images, eos=(-1,), seen=None):
    return [sess.chat(t, images=images if i == 0 else None,
                      eos_ids=list(eos), on_token=seen)
            for i, t in enumerate(turns)]


@pytest.mark.parametrize("disable_below", [None, 0.0, 10.0])
def test_spec_chat_session_equals_plain_and_jax(cfg, trees, disable_below):
    """Three turns (video, then text): the port's SpecChatSession gives the
    plain ChatSession's and JAX's SpecChatSession's tokens, rounds and
    stream (each token streamed once, across the fallback's splice with
    threshold 10)."""
    jeng, teng = _engines(cfg, trees, max_new_tokens=12)
    spec = dict(draft_len=4, rounds_per_call=3, probe_rounds=1,
                disable_below=disable_below)
    jgen, tgen = _gens(max_new_tokens=12, do_sample=False)
    turns, images = _turns(cfg), _frames(cfg)
    jsess = jspec.SpecChatSession(jeng, jgen, spec=jspec.SpecConfig(**spec))
    tsess = SpecChatSession(teng, tgen, spec=SpecConfig(**spec))
    jlog, tlog = _recording(jsess._decoder), _recording(tsess._decoder)
    jseen, tseen, pseen = [], [], []
    want = _converse(jsess, turns, images, seen=jseen.append)
    got = _converse(tsess, turns, images, seen=tseen.append)
    plain = _converse(engine.ChatSession(teng, tgen), turns, images,
                      seen=pseen.append)
    assert got == want == plain
    assert tlog == jlog and tseen == jseen == pseen
    assert tsess._hist == jsess._hist


def test_spec_chat_session_eos_mid_round(cfg, trees):
    """An eos inside a round ends the turn, and the session goes on."""
    jeng, teng = _engines(cfg, trees, max_new_tokens=16)
    jgen, tgen = _gens(max_new_tokens=16, do_sample=False)
    prompt = [1] + list(range(5, 20))
    ref = engine.ChatSession(teng, tgen).chat(prompt, eos_ids=[-1])
    eos = ref[5]
    outs = []
    for sess in (jspec.SpecChatSession(jeng, jgen),
                 SpecChatSession(teng, tgen),
                 engine.ChatSession(teng, tgen)):
        got = sess.chat(prompt, eos_ids=[eos])
        assert got == ref[:6]
        outs.append(sess.chat(list(range(40, 50)), eos_ids=[-1]))
    assert outs[0] == outs[1] == outs[2]


def test_spec_chat_session_sampled_turns_run(cfg, trees):
    _, teng = _engines(cfg, trees, max_new_tokens=12)
    sess = SpecChatSession(teng, engine.GenerationConfig(
        max_new_tokens=12, do_sample=True, temperature=1.2, top_p=0.9))
    for turn in ([1] + list(range(5, 20)), list(range(30, 40))):
        r = sess.chat(turn, eos_ids=[-1])
        assert 0 < len(r) <= 12
        assert all(0 <= t < cfg.text.vocab_size for t in r)


def test_speculative_spawns_equal_jax(cfg, trees):
    """`PrefixCache.spawn(speculative=True)`: a SpecChatSession whose
    lookup history starts with the prefix, giving JAX's spawn's tokens and
    the plain spawn's over two questions."""
    jeng, teng = _engines(cfg, trees, buckets=(64,), max_new_tokens=8)
    jgen, tgen = _gens(max_new_tokens=8, do_sample=False)
    prefix = [1] + _span(cfg) + list(range(10, 20))
    images = _frames(cfg)
    jpc = jengine.PrefixCache(jeng, prefix, images=images, gen=jgen)
    tpc = engine.PrefixCache(teng, prefix, images=images, gen=tgen)
    for q in ([40, 41, 42, 40, 41], [50, 51]):
        jsess = jpc.spawn(speculative=True)
        tsess = tpc.spawn(speculative=True)
        assert isinstance(tsess, SpecChatSession)
        assert tsess._hist == prefix
        want = [jsess.chat(q, eos_ids=[-1]), jsess.chat([60], eos_ids=[-1])]
        got = [tsess.chat(q, eos_ids=[-1]), tsess.chat([60], eos_ids=[-1])]
        plain = tpc.spawn()
        assert got == want == [plain.chat(q, eos_ids=[-1]),
                               plain.chat([60], eos_ids=[-1])]


# -- the pool -----------------------------------------------------------------


def _pool_tokens(pool, prompts, new):
    queues = [pool.submit(p, max_new_tokens=new, eos_id=-1)
              for p in prompts]
    return [list(continuous._drain(q, timeout=60)) for q in queues]


@pytest.mark.parametrize("weights", ["fp32", "const"])
def test_speculative_pool_equals_jax_and_plain(cfg, trees, weights):
    """Two rows through `ContinuousEngine(speculative=True)` (threshold 0,
    so every chunk is rounds; the constant model accepts every draft):
    each request's greedy tokens equal JAX's speculative pool's and the
    port's plain pool's, and the pools' row rounds and their tokens agree
    with JAX's."""
    jeng, teng = _engines(cfg, trees, weights, buckets=(64,),
                          max_new_tokens=16)
    spec = dict(draft_len=2, rounds_per_call=2, disable_below=0.0)
    prompts = [_prompts(cfg)["repetitive"], [1] + list(range(30, 50))]
    jpool = jcont.ContinuousEngine(jeng, rows=2, speculative=True,
                                   spec=jspec.SpecConfig(**spec),
                                   decode_ramp=())
    tpool = continuous.ContinuousEngine(teng, rows=2, speculative=True,
                                        spec=SpecConfig(**spec),
                                        decode_ramp=())
    plain = continuous.ContinuousEngine(teng, rows=2, decode_ramp=())
    try:
        want = [list(jcont._drain(q)) for q in
                [jpool.submit(p, max_new_tokens=12, eos_id=-1)
                 for p in prompts]]
        got = _pool_tokens(tpool, prompts, 12)
        assert got == want == _pool_tokens(plain, prompts, 12)
        assert (tpool.spec_rounds, tpool.spec_emitted) == \
            (jpool.spec_rounds, jpool.spec_emitted)
        assert tpool.spec_disables == 0 and tpool.rounds_run > 0
        if weights == "const":
            assert tpool.spec_emitted > 2 * tpool.spec_rounds
    finally:
        tpool.close()
        plain.close()


def test_pool_pauses_and_reprobes(cfg, trees):
    """JAX tests/test_speculative.py:410: below the threshold the pool
    pauses speculation, keeps emitting the plain tokens through plain
    chunks, and re-probes after ``reprobe_chunks``; the telemetry equals
    JAX's pool's."""
    jeng, teng = _engines(cfg, trees, buckets=(64,), max_new_tokens=16)
    spec = dict(draft_len=2, rounds_per_call=2, disable_below=10.0,
                reprobe_chunks=2)
    prompts = [_prompts(cfg)["repetitive"][:24],
               _prompts(cfg)["random"][:24]]
    gen = engine.GenerationConfig(max_new_tokens=12, do_sample=False)
    refs = [_plain(teng, p, None, gen) for p in prompts]
    jpool = jcont.ContinuousEngine(jeng, rows=2, speculative=True,
                                   spec=jspec.SpecConfig(**spec),
                                   decode_ramp=())
    tpool = continuous.ContinuousEngine(teng, rows=2, speculative=True,
                                        spec=SpecConfig(**spec),
                                        decode_ramp=())
    try:
        want = [list(jcont._drain(jpool.submit(p, max_new_tokens=12,
                                               eos_id=-1)))
                for p in prompts]
        got = [_pool_tokens(tpool, [p], 12)[0] for p in prompts]
        assert got == want == refs
        assert tpool.spec_disables >= 1 and tpool.spec_rounds > 0
        assert tpool._plain_left <= spec["reprobe_chunks"]
        assert (tpool.spec_rounds, tpool.spec_emitted, tpool.spec_disables) \
            == (jpool.spec_rounds, jpool.spec_emitted, jpool.spec_disables)
    finally:
        tpool.close()


def test_speculative_pool_warmup_visits_every_size(cfg, trees):
    """`warmup` forces one verify chunk of every scheduled size and the
    plain fallback's chunks, then resets the adaptive state and the
    telemetry."""
    _, teng = _engines(cfg, trees, buckets=(64,), max_new_tokens=16)
    pool = continuous.ContinuousEngine(
        teng, rows=2, speculative=True, decode_ramp=(2,), steps_per_call=3,
        spec=SpecConfig(draft_len=2, rounds_per_call=2))
    sizes = []
    spec_chunk, decode_chunk = pool._spec_chunk, pool._decode_chunk
    pool._spec_chunk = lambda n: sizes.append(("spec", n)) or spec_chunk(n)
    pool._decode_chunk = lambda n: sizes.append(("plain", n)) or \
        decode_chunk(n)
    try:
        pool.warmup()
        assert {("spec", 2), ("spec", 3), ("plain", 2), ("plain", 3)} \
            <= set(sizes)
        assert pool._spec_live and pool._acc_ema is None
        assert (pool.spec_rounds, pool.spec_emitted,
                pool.spec_disables) == (0, 0, 0)
    finally:
        pool.close()


# -- entry points -------------------------------------------------------------


def _frame_dir(path, n=4):
    import cv2

    path.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        cv2.imwrite(str(path / f"{i:03d}.png"),
                    rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
    return path


def test_run_valley_speculative_on_frame_dir(tmp_path, capsys):
    """``run_valley --speculative`` prints the same answer as without it
    (greedy, random:tiny)."""
    from valley_tpu_torch.inference import run_valley

    d = _frame_dir(tmp_path / "frames")
    outs = []
    for extra in ([], ["--speculative"]):
        run_valley.main(["--model-name", "random:tiny", "--video-file",
                         str(d), "--device", "cpu", "--max-new-tokens", "8"]
                        + extra)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip() != ""


def test_batch_infer_speculative(tmp_path):
    """``batch_infer --speculative`` on random:tiny answers every request
    with the tokens of the plain pool."""
    import json

    from valley_tpu_torch.inference import batch_infer

    rows = [{"id": "a", "query": "Hello there, hello there"},
            {"id": "b", "query": "What is shown?"}]
    (tmp_path / "in.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    answers = []
    for i, extra in enumerate(([], ["--speculative"])):
        out = tmp_path / f"out{i}.jsonl"
        summary = batch_infer.run_batch(batch_infer.build_parser().parse_args(
            ["--model-path", "random:tiny", "--input",
             str(tmp_path / "in.jsonl"), "--output", str(out),
             "--device", "cpu", "--rows", "2", "--buckets", "128",
             "--system-prompt", "sys", "--kv-cache", "bf16",
             "--max-new-tokens", "6", "--steps-per-call", "2"] + extra))
        assert summary["errors"] == 0 and summary["ran"] == 2
        answers.append({r["id"]: r["response"] for r in
                        map(json.loads, out.read_text().splitlines())})
    assert answers[0] == answers[1]
