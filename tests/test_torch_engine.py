"""The PyTorch port's engine and offline API against the JAX package on the
CPU (``valley_tiny``, fp32 weights from the JAX ``init_params``).

Greedy decoding must give identical tokens: both sides compute the same
fp32 logits up to summation order (~1e-6), far below the gaps between the
top logits of these prompts.  ``filter_logits`` is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import engine as jengine
from valley_tpu.inference import generate as jgenerate
from valley_tpu.models import valley as jvalley
from valley_tpu.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch.inference import engine, generate, run_valley
from valley_tpu_torch.weights import from_jax_params

# TF32 off, so fp32 matmuls stay fp32 wherever these run on a card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW = 16


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    return jvalley.init_params(cfg, jax.random.key(11), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def jeng(cfg, jparams):
    return jengine.Engine(cfg, jparams, buckets=(64, 128),
                          max_new_tokens=NEW, cache_dtype=jnp.float32,
                          use_flash=False, steps_per_call=4)


@pytest.fixture(scope="module")
def teng(cfg, tparams):
    return engine.Engine(cfg, tparams, buckets=(64, 128), max_new_tokens=NEW,
                         cache_dtype=torch.float32, steps_per_call=4)


def _media_prompt(cfg, frames, n_text, seed):
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
        [tok.vi_end]
    return [1] + span + np.random.default_rng(seed).integers(
        5, 400, n_text).tolist()


def _frames(cfg, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (1, t, 3, cfg.vision.image_size, cfg.vision.image_size)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def _tokens(eng, prompt, images, gen):
    return [int(t[0]) for t in eng.generate_tokens([prompt], images, gen,
                                                   eos_ids=[-1])]


@pytest.mark.parametrize("case", ["text", "image", "video4", "video_uint8"])
def test_greedy_tokens_identical_to_jax_engine(cfg, jeng, teng, case):
    """Each prompt is shorter than its bucket, so decode runs with the
    hole of invalid slots between the prompt and slot ``bucket``."""
    rng = np.random.default_rng(0)
    if case == "text":
        prompt, images = rng.integers(5, 400, 21).tolist(), None
    elif case == "image":
        prompt, images = _media_prompt(cfg, 1, 12, 1), _frames(cfg, 1, 1)
    elif case == "video4":
        prompt, images = _media_prompt(cfg, 4, 20, 2), _frames(cfg, 4, 2)
    else:
        prompt = _media_prompt(cfg, 4, 30, 3)
        images = _frames(cfg, 4, 3, np.uint8)
    gen = engine.GenerationConfig(max_new_tokens=NEW)
    want = _tokens(jeng, prompt, images,
                   jengine.GenerationConfig(max_new_tokens=NEW))
    got = _tokens(teng, prompt, images, gen)
    assert len(got) == NEW
    assert got == want


def test_decode_ramp_keeps_tokens_and_chunks(cfg, tparams, teng):
    """Chunking changes when tokens reach the host, never which tokens."""
    prompt = np.random.default_rng(4).integers(5, 400, 9).tolist()
    gen = engine.GenerationConfig(max_new_tokens=11)
    ramped = engine.Engine(cfg, tparams, buckets=(64,), max_new_tokens=NEW,
                           cache_dtype=torch.float32, steps_per_call=4,
                           decode_ramp=(1, 2))
    assert _tokens(ramped, prompt, None, gen) == _tokens(teng, prompt, None,
                                                         gen)
    sched = ramped._ramp_iter()
    assert [next(sched) for _ in range(4)] == [1, 2, 4, 4]


def test_eos_stops_generation(cfg, teng):
    prompt = np.random.default_rng(5).integers(5, 400, 9).tolist()
    gen = engine.GenerationConfig(max_new_tokens=NEW)
    toks = _tokens(teng, prompt, None, gen)
    stopped = [int(t[0]) for t in teng.generate_tokens(
        [prompt], None, gen, eos_ids=[toks[2]])]
    assert stopped == toks[:toks.index(toks[2]) + 1]


def test_prefill_state_layout(cfg, teng):
    prompt = np.random.default_rng(6).integers(5, 400, 21).tolist()
    state = teng.prefill([prompt])
    assert state.bucket == 64
    assert state.cache.max_len == 64 + NEW + 4
    assert state.valid.dtype == torch.bool
    assert state.valid[0, :21].all() and not state.valid[0, 21:].any()
    assert state.logits.dtype == torch.float32
    assert tuple(state.logits.shape) == (1, cfg.text.vocab_size)


def test_empty_prompt_and_long_prompt_rejected(teng):
    with pytest.raises(ValueError):
        list(teng.generate_tokens([[]]))
    with pytest.raises(ValueError, match="bucket"):
        list(teng.generate_tokens([[5] * 200]))


@pytest.mark.parametrize("temperature,top_p", [
    (1.0, 1.0), (0.7, 0.9), (1.3, 0.5), (0.5, 0.05)])
def test_filter_logits_matches_jax(temperature, top_p):
    logits = np.random.default_rng(7).standard_normal((3, 50)).astype(
        np.float32) * 3
    want = np.asarray(jengine.filter_logits(jnp.asarray(logits), temperature,
                                            top_p))
    got = engine.filter_logits(torch.from_numpy(logits), temperature,
                               top_p).numpy()
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_filter_logits_per_row_settings():
    logits = np.random.default_rng(8).standard_normal((2, 40)).astype(
        np.float32)
    t, p = np.array([0.5, 1.5], np.float32), np.array([0.3, 0.95],
                                                      np.float32)
    want = np.asarray(jengine.filter_logits(jnp.asarray(logits),
                                            jnp.asarray(t), jnp.asarray(p)))
    got = engine.filter_logits(torch.from_numpy(logits), torch.from_numpy(t),
                               torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sample_token_rules():
    logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 30)).astype(np.float32))
    greedy = logits.argmax(-1)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(engine.sample_token(logits, g, 1.0, 1.0, False),
                       greedy)
    # temperature below 1e-4 is greedy even when sampling
    assert torch.equal(engine.sample_token(logits, g, 1e-5, 1.0, True),
                       greedy)
    a = engine.sample_token(logits, torch.Generator().manual_seed(3), 0.8,
                            0.9, True)
    b = engine.sample_token(logits, torch.Generator().manual_seed(3), 0.8,
                            0.9, True)
    assert torch.equal(a, b)
    # a tiny nucleus keeps only the top token
    assert torch.equal(engine.sample_token(logits, g, 1.0, 1e-6, True),
                       greedy)


def test_sampled_generation_reproducible(teng):
    prompt = list(range(10, 30))
    gen = engine.GenerationConfig(max_new_tokens=6, do_sample=True,
                                  temperature=0.8, top_p=0.9, seed=42)
    assert _tokens(teng, prompt, None, gen) == _tokens(teng, prompt, None,
                                                       gen)


MESSAGES = [
    [{"role": "system", "content": "Be brief."},
     {"role": "user", "content": "What happens? <video>"}],
    [{"role": "user", "content": "Look <image> here"},
     {"role": "assistent", "content": "A cat."},
     {"role": "human", "content": "And then?"}],
]


@pytest.mark.parametrize("messages", MESSAGES)
def test_build_prompt_matches_jax(messages):
    assert generate.build_prompt(messages, 4, 3) == \
        jgenerate.build_prompt(messages, 4, 3)
    assert generate.media_replace_token(4, 2) == \
        jgenerate.media_replace_token(4, 2)


def test_build_prompt_rules():
    with pytest.raises(ValueError, match="<video>"):
        generate.build_prompt([{"role": "user", "content": "hi"}])
    assert generate.build_prompt([{"role": "user", "content": "hi"}],
                                 require_media=False) == " Human: hi \n###"
    with pytest.raises(ValueError, match="Role"):
        generate.build_prompt([{"role": "bot", "content": "<video>"}])


@pytest.mark.parametrize("text", [
    "### Assistant: A dog runs. ### Human: more", "  Valley: ok", "plain",
    "Assistent: ### Response: two ###"])
def test_process_response_matches_jax(text):
    assert generate.process_response([text]) == \
        jgenerate.process_response([text])


def test_stream_text_and_stops_match_jax():
    tk = ByteFallbackTokenizer()
    ids = tk.encode("hello ### world", add_bos=False)
    gen_t = engine.GenerationConfig(stream_interval=3)
    gen_j = jengine.GenerationConfig(stream_interval=3)
    assert list(engine.stream_text(iter(ids), tk, gen_t)) == \
        list(jengine.stream_text(iter(ids), tk, gen_j))
    assert engine.find_stop_index(ids, ["###"], tk) == \
        jengine.find_stop_index(ids, ["###"], tk)
    assert engine.find_stop_index(ids, ["zz"], tk) is None


@pytest.fixture(scope="module")
def byte_setup():
    tk = ByteFallbackTokenizer()
    cfg = C.valley_tiny().replace(tokens=tk.special_tokens())
    jp = jvalley.init_params(cfg, jax.random.key(5), jnp.float32)
    tp = from_jax_params(jax.device_get(jp), "cpu", torch.float32)
    return tk, cfg, jp, tp


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_completion_matches_jax(byte_setup, dtype):
    tk, cfg, jp, tp = byte_setup
    frames = _frames(cfg, 3, 10, dtype)[0]
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "What is shown? <video>"}]
    jeng = jengine.Engine(cfg, jp, buckets=(64,), max_new_tokens=8,
                          cache_dtype=jnp.float32, use_flash=False)
    teng = engine.Engine(cfg, tp, buckets=(64,), max_new_tokens=8,
                         cache_dtype=torch.float32)
    want = jgenerate.completion(jeng, tk, None, messages,
                                jengine.GenerationConfig(max_new_tokens=8),
                                frames=frames)
    got = generate.completion(teng, tk, None, messages,
                              engine.GenerationConfig(max_new_tokens=8),
                              frames=frames)
    assert got == want
    with pytest.raises(ValueError, match="video"):
        generate.completion(teng, tk, None, messages)


def test_run_valley_cli_on_frame_dir(tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(12)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            tmp_path / f"f{i}.png")
    run_valley.main(["--model-name", "random:tiny", "--video-file",
                     str(tmp_path), "--device", "cpu", "--max-new-tokens",
                     "4", "--temperature", "0"])
    out = capsys.readouterr().out
    assert out.endswith("\n")


def test_run_valley_refuses_checkpoints(tmp_path):
    """Checkpoint directories load (tests/test_torch_serve.py serves one)
    and take ``--lora-path`` (tests/test_torch_train_cli.py merges one);
    what is not a checkpoint or a known random model is refused, and so
    is an adapter over random weights."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        run_valley.load_model(str(tmp_path / "no_such_checkpoint"), "cpu")
    with pytest.raises(ValueError, match="random:7b"):
        run_valley.load_model("random:huge", "cpu")
    with pytest.raises(ValueError, match="lora-path"):
        run_valley.main(["--model-name", "random:tiny", "--video-file", ".",
                         "--lora-path", "x", "--device", "cpu"])


def _frame_dir(path, n=4):
    from PIL import Image

    rng = np.random.default_rng(13)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            path / f"f{i}.png")
    return str(path)


def test_run_valley_wants_the_card_without_device_cpu(tmp_path,
                                                      monkeypatch):
    """With no card, the entry point and its CLI stop, naming --device
    cpu, instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(run_valley.valley, "init_params",
                        lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_valley.load_model("random:tiny")
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_valley.main(["--model-name", "random:tiny", "--video-file",
                         _frame_dir(tmp_path), "--max-new-tokens", "2"])
    assert built == []


def test_run_valley_cli_int8_serving_on_frame_dir(tmp_path, capsys):
    """The worker's int8 flagship options on the CPU: fused int8a8 weights
    and an int8 KV cache answer a question about a frame directory."""
    run_valley.main(["--model-name", "random:tiny", "--video-file",
                     _frame_dir(tmp_path), "--device", "cpu",
                     "--max-new-tokens", "4", "--temperature", "0",
                     "--quantize", "int8a8", "--fused", "--kv-cache",
                     "int8"])
    assert capsys.readouterr().out.endswith("\n")
    eng, _ = run_valley.load_model("random:tiny", "cpu", buckets=(64,),
                                   max_new_tokens=2, quantize="int8a8",
                                   fused=True, kv_cache="int8")
    lay = eng.params["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.int8 and "wqkv_scale_a8" in lay
    assert eng.cache_dtype == torch.int8


# -- the decode schedule, frame buckets and warmup ---------------------------


@pytest.mark.parametrize("ramp,spc", [((), 1), ((), 4), ((2,), 4),
                                      ((2, 3), 4), ((1, 6), 8),
                                      ((3, 3, 5), 2)])
def test_tail_steps_equal_jax(jparams, tparams, cfg, ramp, spc):
    """`_tail_steps` over every (want, room) of a grid, against JAX's."""
    jeng = jengine.Engine(cfg, jparams, buckets=(64,), max_new_tokens=NEW,
                          cache_dtype=jnp.float32, use_flash=False,
                          steps_per_call=spc, decode_ramp=ramp)
    teng = engine.Engine(cfg, tparams, buckets=(64,), max_new_tokens=NEW,
                         cache_dtype=torch.float32, steps_per_call=spc,
                         decode_ramp=ramp)
    assert teng._sched_sizes == jeng._sched_sizes
    for want in range(1, 20):
        for room in range(0, 24):
            assert teng._tail_steps(want, room) == \
                jeng._tail_steps(want, room), (want, room)


TAIL_CACHES = {"fp32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16),
               "int8": (jnp.int8, torch.int8)}


def _spy_chunks(eng, name):
    """Record the ``n_steps`` of every decode chunk ``eng`` runs through
    its method ``name`` (JAX ``_decode``, the port's ``_decode_chunk``)."""
    sizes = []
    orig = getattr(eng, name)

    def spy(*a, **k):
        sizes.append(k["n_steps"] if "n_steps" in k else a[1])
        return orig(*a, **k)

    setattr(eng, name, spy)
    return sizes


@pytest.mark.parametrize("cache", list(TAIL_CACHES))
@pytest.mark.parametrize("b", [1, 3])
def test_every_tail_gives_jax_tokens_and_chunks(cfg, jparams, tparams, cache,
                                                b):
    """``steps_per_call=4``, ``decode_ramp=(2, 3)`` and max_new_tokens 1 to
    13, so the final chunk pads up from every remainder: the tokens kept,
    and the size of every chunk run (padded tails included), are JAX's.
    The port's chunks run the step its graphs capture, eagerly."""
    jdt, tdt = TAIL_CACHES[cache]
    jeng = jengine.Engine(cfg, jparams, buckets=(64,), max_new_tokens=13,
                          cache_dtype=jdt, use_flash=False, steps_per_call=4,
                          decode_ramp=(2, 3))
    teng = engine.Engine(cfg, tparams, buckets=(64,), max_new_tokens=13,
                         cache_dtype=tdt, steps_per_call=4,
                         decode_ramp=(2, 3))
    jsizes = _spy_chunks(jeng, "_decode")
    tsizes = _spy_chunks(teng, "_decode_chunk")
    rng = np.random.default_rng(30 + b)
    if b == 1:
        prompts, images = [_media_prompt(cfg, 2, 11, 31)], _frames(cfg, 2, 31)
    else:
        prompts, images = [rng.integers(5, 400, n).tolist()
                           for n in (9, 40, 23)], None
    for new in range(1, 14):
        jsizes.clear()
        tsizes.clear()
        steps0 = teng.steps_run
        want = np.stack(list(jeng.generate_tokens(
            prompts, images, jengine.GenerationConfig(max_new_tokens=new),
            eos_ids=[-1])))
        got = np.stack(list(teng.generate_tokens(
            prompts, images, engine.GenerationConfig(max_new_tokens=new),
            eos_ids=[-1])))
        assert got.shape == (new, b)
        np.testing.assert_array_equal(got, want)
        assert tsizes == jsizes, new
        assert teng.steps_run - steps0 == sum(jsizes)


@pytest.fixture(scope="module")
def bucket_engines(cfg, jparams, tparams):
    return (jengine.Engine(cfg, jparams, buckets=(64,), max_new_tokens=NEW,
                           cache_dtype=jnp.float32, use_flash=False,
                           steps_per_call=4, frame_buckets=(2, 4, 8)),
            engine.Engine(cfg, tparams, buckets=(64,), max_new_tokens=NEW,
                          cache_dtype=torch.float32, steps_per_call=4,
                          frame_buckets=(2, 4, 8)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_frame_buckets_match_jax(cfg, teng, bucket_engines, dtype):
    """A 3-frame video with ``frame_buckets=(2, 4, 8)`` pads to 4 frames,
    the fourth masked out of the pooling: the tokens are JAX's, the fp32
    prefill logits within 1e-5 of its, and within 1e-5 of an engine
    without frame buckets (masked pooling ignores the padding)."""
    jeng, tb = bucket_engines
    prompt, images = _media_prompt(cfg, 3, 14, 40), _frames(cfg, 3, 40,
                                                              dtype)
    media = tb._prepare_images(images, 1)
    assert tuple(media.frames.shape[:2]) == (1, 4)
    assert media.frame_mask.tolist() == [[True, True, True, False]]
    gen = engine.GenerationConfig(max_new_tokens=NEW)
    want = _tokens(jeng, prompt, images,
                   jengine.GenerationConfig(max_new_tokens=NEW))
    assert _tokens(tb, prompt, images, gen) == want
    ids = np.zeros((1, 64), np.int32)
    ids[0, :len(prompt)] = prompt
    imgs, frame_mask, has = jeng._prepare_images(images, 1)
    _, jlogits, _, _ = jeng._prefill(
        jeng.params, jnp.asarray(ids), imgs,
        jnp.asarray([len(prompt)], jnp.int32), jax.random.key(0), 1.0, 1.0,
        frame_mask, bucket=64, cache_len=64 + NEW + 4, do_sample=False,
        has_images=has)
    got = tb.prefill([prompt], images).logits.numpy()
    np.testing.assert_allclose(got, np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(got, teng.prefill([prompt], images)
                               .logits.numpy(), atol=1e-5)


def test_frames_past_the_last_bucket_keep_their_count(cfg, bucket_engines):
    """Past the largest bucket the frame axis stays as it is, all valid
    (JAX engine.py:440-442)."""
    media = bucket_engines[1]._prepare_images(_frames(cfg, 9, 41), 1)
    assert tuple(media.frames.shape[:2]) == (1, 9)
    assert bool(media.frame_mask.all())


def test_warmup_visits_what_jax_warms(cfg, jparams, tparams):
    """`Engine.warmup` runs the prefill of every (batch, bucket, frame
    bucket or text, greedy and sampled) and every decode chunk size that
    JAX's does, in the same order (on the card each decode chunk size is
    a graph it captures)."""
    kw = dict(buckets=(64,), max_new_tokens=NEW, steps_per_call=4,
              decode_ramp=(2,), frame_buckets=(2, 4))
    jeng = jengine.Engine(cfg, jparams, cache_dtype=jnp.float32,
                          use_flash=False, **kw)
    teng = engine.Engine(cfg, tparams, cache_dtype=torch.float32, **kw)
    jseen, tseen = [], []
    jprefill, jdecode = jeng._prefill, jeng._decode
    tprefill, tchunk = teng._prefill, teng._decode_chunk

    def jp(params, ids, images, *a, **k):
        jseen.append(("prefill", ids.shape, images.shape[1]
                      if k["has_images"] else None, k["do_sample"]))
        return jprefill(params, ids, images, *a, **k)

    def jd(params, cache, valid, token, *a, **k):
        jseen.append(("decode", token.shape[0], k["n_steps"],
                      k["do_sample"]))
        return jdecode(params, cache, valid, token, *a, **k)

    def tp(ids, media, *a, **k):
        tseen.append(("prefill", tuple(ids.shape), None if media is None
                      else media.frames.shape[1], a[4]))
        return tprefill(ids, media, *a, **k)

    def tc(state, n_steps, do_sample, *a, **k):
        tseen.append(("decode", state.rows, n_steps, do_sample))
        return tchunk(state, n_steps, do_sample, *a, **k)

    jeng._prefill, jeng._decode = jp, jd
    teng._prefill, teng._decode_chunk = tp, tc
    jeng.warmup(batch_sizes=(1, 2))
    teng.warmup(batch_sizes=(1, 2))
    assert tseen == jseen
    assert {s for s in tseen if s[0] == "decode"} == {
        ("decode", b, n, m) for b in (1, 2) for n in (2, 4)
        for m in (False, True)}
