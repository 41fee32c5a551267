"""Multi-turn sessions of the PyTorch port (`ChatSession`, `PrefixCache`,
`Engine._extend`, the ``cross_valid`` extend branch, ``run_valley_conv``)
against the JAX package on the CPU, mirroring ``tests/test_session.py``.

One JAX init of the tiny model (fp32) feeds both packages through
``from_jax_params``; the int8a8 and int4gp trees are that init fused and
quantized by the JAX quantizer, as the worker does.  Greedy tokens must be
identical: both sides compute the same fp32 logits up to summation order
(~1e-6, `test_extend_logits_match_jax`), far below the gaps between the
top logits of these prompts.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import engine as jengine
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import quant as jquant
from valley_tpu_torch.inference import engine, run_valley_conv
from valley_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def trees(cfg):
    """The JAX trees of one init: fp32, fused int8a8, fused int4gp at
    group 32 (nibble-packed)."""
    base = jvalley.init_params(cfg, jax.random.key(21), jnp.float32)

    def fused():      # a fresh tree of dicts: the JAX transforms edit theirs
        return jllama.fuse_llama_params(jax.tree.map(lambda x: x, base))

    return {"fp32": jax.device_get(base),
            "int8a8": jax.device_get(jquant.quantize_llama_params(
                fused(), act8=True)),
            "int4gp": jax.device_get(jquant.pack_int4_params(
                jquant.quantize_llama_params(fused(), bits=4,
                                             group_size=32)))}


CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8), "fp32": (jnp.float32, torch.float32)}


def _engines(cfg, trees, weights="fp32", cache="fp32", **kw):
    """A JAX engine and the port's on the same weights and cache dtype."""
    kw = {"buckets": (64,), "max_new_tokens": 8, "steps_per_call": 3, **kw}
    tree = trees[weights]
    jdt, tdt = CACHES[cache]
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree),
                          cache_dtype=jdt, use_flash=False,
                          w4_packed=weights == "int4gp", **kw)
    teng = engine.Engine(cfg, from_jax_params(tree, "cpu", torch.float32),
                         cache_dtype=tdt, **kw)
    return jeng, teng


def _video_prompt(cfg, frames=2, n_text=10):
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
        [tok.vi_end]
    images = np.random.default_rng(3).standard_normal(
        (1, frames, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(
        np.float32)
    return [1] + span + list(range(10, 10 + n_text)), images


def _chat(sess_cls, eng, gen_cls, turns, images=None, **kw):
    sess = sess_cls(eng, gen_cls(max_new_tokens=5, do_sample=False), **kw)
    return [sess.chat(t, images=images if i == 0 else None, eos_ids=[-1])
            for i, t in enumerate(turns)], sess


@pytest.mark.parametrize("weights,cache", [
    ("fp32", "bf16"), ("fp32", "int8"), ("int8a8", "int8"),
    ("int4gp", "int8")])
def test_three_turns_identical_to_jax(cfg, trees, weights, cache):
    """A video first turn, then two text turns, through both packages'
    ChatSession: the same greedy tokens at every turn."""
    jeng, teng = _engines(cfg, trees, weights, cache)
    prompt, images = _video_prompt(cfg)
    turns = [prompt, [77, 78, 79], [90, 91, 92, 93]]
    want, _ = _chat(jengine.ChatSession, jeng, jengine.GenerationConfig,
                    turns, images)
    got, sess = _chat(engine.ChatSession, teng, engine.GenerationConfig,
                      turns, images)
    assert got == want
    assert (sess.prefills, sess.extends, sess.decode_steps) == (1, 2, 12)


def _jax_extend_logits(jeng, cache, valid, ids, new_len, seq_len, slot0):
    """The fp32 logits JAX's _extend_impl samples from (engine.py:327-341,
    which returns only the token)."""
    p = jeng.params["llama"]
    c = ids.shape[1]
    hidden, cache = jllama.forward_hidden(
        p, jeng.cfg.text, jllama.embed(p, ids),
        positions=seq_len[:, None] + jnp.arange(c)[None, :], cache=cache,
        cache_index=slot0, cross_valid=valid, use_flash=False)
    last = jnp.take_along_axis(hidden, (new_len - 1)[:, None, None], axis=1)
    return np.asarray(jllama.logits_from_hidden(p, last)[:, 0]), cache


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_extend_logits_match_jax(cfg, trees, cache):
    """A 19-token chunk (pow-2 padded to 32) appended at slot 64 after a
    video prefill: the extend's logits within 1e-5 (fp32), the cache it
    wrote and the mask it returns as JAX's, the cache of the int8 branch to
    one int8 step and its scales to bf16 rounding."""
    jeng, teng = _engines(cfg, trees, "fp32", cache)
    prompt, images = _video_prompt(cfg)
    n = len(prompt)
    ids = np.zeros((1, 64), np.int64)
    ids[0, :n] = prompt
    cache_len = 64 + 8 + 40
    jimg, fmask, has = jeng._prepare_images(images, 1)
    _, _, jcache, jvalid = jeng._prefill(
        jeng.params, jnp.asarray(ids, jnp.int32), jimg,
        jnp.asarray([n], np.int32), jax.random.key(0), 1.0, 1.0, fmask,
        bucket=64, cache_len=cache_len, do_sample=False, has_images=has)
    _, _, tcache, tvalid = teng._prefill(
        torch.from_numpy(ids), teng._prepare_images(images, 1),
        torch.tensor([n]), torch.Generator().manual_seed(0), 1.0, 1.0, False,
        cache_len)
    chunk = np.zeros((1, 32), np.int64)
    chunk[0, :19] = np.arange(100, 119)
    want, jcache = _jax_extend_logits(
        jeng, jcache, jvalid, jnp.asarray(chunk, jnp.int32),
        jnp.asarray([19]), jnp.asarray([n]), 64)
    tok, got, tcache, tvalid2, seq = teng._extend(
        tcache, tvalid, torch.from_numpy(chunk), torch.tensor([19]),
        torch.tensor([n]), 64, torch.Generator().manual_seed(0), 1.0, 1.0,
        False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert int(tok[0]) == int(want.argmax()) and int(seq[0]) == n + 19
    jtok, _, jvalid2, _ = jeng._extend(
        jeng.params, jax.tree.map(jnp.copy, jcache), jvalid,
        jnp.asarray(chunk, jnp.int32), jnp.asarray([19], np.int32),
        jnp.asarray([n]), jnp.int32(64), jax.random.key(0), 1.0, 1.0,
        do_sample=False)
    assert int(jtok[0]) == int(tok[0])
    np.testing.assert_array_equal(tvalid2.numpy(), np.asarray(jvalid2))
    assert not tvalid[0, 64:].any()        # the input mask is left as it was
    for name in ("k", "v"):
        a = getattr(tcache, name).float().numpy()
        b = np.asarray(getattr(jcache, name), np.float32)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1.0 if cache == "int8"
                                   else 1e-5 * np.abs(b).max())
    if cache == "int8":
        np.testing.assert_allclose(
            tcache.k_scale.float().numpy(),
            np.asarray(jcache.k_scale, np.float32), rtol=2 ** -7, atol=0)


def test_second_turn_matches_full_reprefill(cfg, trees):
    """The port alone: turn 2 through the kept cache gives the tokens of
    the whole conversation prefilled again (tests/test_session.py)."""
    _, teng = _engines(cfg, trees)
    gen = engine.GenerationConfig(max_new_tokens=5, do_sample=False)
    prompt, turn2 = list(range(10, 40)), list(range(50, 62))
    sess = engine.ChatSession(teng, gen)
    reply1 = sess.chat(prompt, eos_ids=[-1])
    reply2 = sess.chat(turn2, eos_ids=[-1])
    full = [int(t[0]) for t in teng.generate_tokens(
        [prompt + reply1 + turn2], None, gen, eos_ids=[-1])]
    assert reply2 == full


def test_eos_trims_the_overshoot(cfg, trees):
    """An eos mid-chunk: the reply stops at it, the slots decoded after it
    are invalid afterwards, and turn 2 is JAX's."""
    jeng, teng = _engines(cfg, trees)
    prompt = list(range(10, 40))
    probe = [int(t[0]) for t in teng.generate_tokens(
        [prompt], None, engine.GenerationConfig(max_new_tokens=6),
        eos_ids=[-1])]
    eos = probe[1]
    got, want = [], []
    for sess_cls, eng, gen_cls, out in (
            (engine.ChatSession, teng, engine.GenerationConfig, got),
            (jengine.ChatSession, jeng, jengine.GenerationConfig, want)):
        sess = sess_cls(eng, gen_cls(max_new_tokens=6, do_sample=False))
        out.append(sess.chat(prompt, eos_ids=[eos]))
        if sess_cls is engine.ChatSession:
            _, valid, seq, commit, pending = sess._state
            # the chunk of 3 steps fed back the first token (slot 64), the
            # eos (65) and the token after it (66); the eos is the turn's
            # pending last token, whose slot the next turn writes, so 65
            # and 66 are trimmed
            assert pending == eos and commit == 65 and seq == 32
            assert valid[0, 64] and not valid[0, 65:].any()
        out.append(sess.chat([70, 71, 72], eos_ids=[-1]))
    assert got[0] == probe[:2]
    assert got == want


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_compaction_keeps_tokens_identical_to_jax(cfg, trees, cache):
    """A 64-slot session cache (tests/test_session.py: 32 + 4 + 24 + the
    decode slack of 4): turn 3 would need slot 52 + a 16-slot chunk + 7 and
    compacts to the 18 live slots; every turn's tokens stay JAX's."""
    jeng, teng = _engines(cfg, trees, "fp32", cache, buckets=(32,),
                          max_new_tokens=4, steps_per_call=4)
    turns = [list(range(10, 20)), [40, 41, 42], [50, 51], [60, 61]]
    outs = []
    for sess_cls, eng, gen_cls in (
            (jengine.ChatSession, jeng, jengine.GenerationConfig),
            (engine.ChatSession, teng, engine.GenerationConfig)):
        sess = sess_cls(eng, gen_cls(max_new_tokens=3, do_sample=False),
                        extra_slots=24)
        outs.append([sess.chat(t, eos_ids=[-1]) for t in turns])
    assert outs[0] == outs[1]
    assert sess.compactions == 1 and sess._state[0].max_len == 64


def test_compact_cache_moves_valid_slots_in_order():
    from valley_tpu_torch.models.llama import KVCache

    k = torch.arange(2 * 3 * 8 * 2, dtype=torch.float32).reshape(2, 3, 8, 2)
    k = k[..., None].expand(2, 3, 8, 2, 4).contiguous()
    scale = torch.arange(2 * 3 * 8 * 2).reshape(2, 3, 8, 2).bfloat16()
    valid = torch.tensor([[1, 0, 1, 1, 0, 0, 1, 0], [0, 0, 0, 0, 0, 0, 0, 1],
                          [1, 1, 1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    cache, new_valid, n = engine._compact_cache(
        KVCache(k, k.clone(), scale, scale.clone()), valid)
    assert n.tolist() == [4, 1, 8]
    for r in range(3):
        keep = valid[r].nonzero()[:, 0]
        assert torch.equal(cache.k[:, r, :len(keep)], k[:, r, keep])
        assert torch.equal(cache.v_scale[:, r, :len(keep)], scale[:, r, keep])
        assert new_valid[r, :len(keep)].all() and \
            not new_valid[r, len(keep):].any()


def test_session_cache_exhaustion_raises(cfg, trees):
    _, teng = _engines(cfg, trees, max_new_tokens=4)
    sess = engine.ChatSession(teng, engine.GenerationConfig(
        max_new_tokens=4, do_sample=False), extra_slots=8)
    sess.chat(list(range(10, 20)), eos_ids=[-1])
    with pytest.raises(RuntimeError, match="exhausted"):
        for _ in range(20):
            sess.chat(list(range(30, 40)), eos_ids=[-1])


def test_media_rejected_on_a_later_turn(cfg, trees):
    _, teng = _engines(cfg, trees)
    sess = engine.ChatSession(teng, engine.GenerationConfig(
        max_new_tokens=2, do_sample=False))
    assert not sess.started
    sess.chat(list(range(10, 20)), eos_ids=[-1])
    assert sess.started
    with pytest.raises(ValueError, match="first turn"):
        sess.chat([5, 6], images=np.zeros(
            (1, 1, 3, cfg.vision.image_size, cfg.vision.image_size),
            np.float32))


def _spawned(pc_cls, eng, gen_cls, prefix, images):
    """Two spawns with different questions, then a second turn of the
    first: the spawns must not share a cache."""
    gen = gen_cls(max_new_tokens=4, do_sample=False)
    pc = pc_cls(eng, prefix, images=images, gen=gen)
    a, b = pc.spawn(), pc.spawn()
    return [a.chat([40, 41], eos_ids=[-1]), b.chat([50, 51, 52], eos_ids=[-1]),
            a.chat([60], eos_ids=[-1])], pc


@pytest.mark.parametrize("media", [False, True])
def test_prefix_cache_spawns_identical_to_jax(cfg, trees, media):
    jeng, teng = _engines(cfg, trees, max_new_tokens=6)
    if media:
        prefix, images = _video_prompt(cfg, n_text=6)
    else:
        prefix, images = list(range(10, 30)), None
    want, _ = _spawned(jengine.PrefixCache, jeng, jengine.GenerationConfig,
                       prefix, images)
    got, pc = _spawned(engine.PrefixCache, teng, engine.GenerationConfig,
                       prefix, images)
    assert got == want
    # independent: a's second turn is that of a session holding a's turns
    full = engine.ChatSession(teng, engine.GenerationConfig(
        max_new_tokens=4, do_sample=False))
    full.chat(prefix + [40, 41], images=images, eos_ids=[-1])
    assert full.chat([60], eos_ids=[-1]) == got[2]
    assert pc._frag.k.shape[2] == 64 and not pc._valid[0, len(prefix):].any()


def test_speculative_spawn_is_not_ported(cfg, trees):
    """Once refused; now `spawn(speculative=True)` gives a SpecChatSession
    whose lookup history starts with the prefix and whose turn equals the
    plain spawn's."""
    from valley_tpu_torch.inference.speculative import SpecChatSession

    _, teng = _engines(cfg, trees)
    pc = engine.PrefixCache(teng, list(range(10, 20)),
                            gen=engine.GenerationConfig(max_new_tokens=5,
                                                        do_sample=False))
    sess = pc.spawn(speculative=True)
    assert isinstance(sess, SpecChatSession)
    assert sess._hist == list(range(10, 20))
    assert sess.chat([30, 31], eos_ids=[-1]) == \
        pc.spawn().chat([30, 31], eos_ids=[-1])


def _frame_dir(path, n=4):
    from PIL import Image

    rng = np.random.default_rng(13)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            path / f"f{i}.png")
    return str(path)


def test_run_valley_conv_repl_on_frame_dir(tmp_path, monkeypatch, capsys):
    """Questions on standard input: a video turn, a text turn, a switch of
    clips (the conversation starts again), one more turn, then exit."""
    clip = _frame_dir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "What happens?\nAnd then?\nchange video " + clip + "\nWhy?\nexit\n"))
    seen = []
    real = engine.ChatSession.chat

    def chat(self, new_ids, images=None, **kw):
        seen.append((images is not None, self.started, len(new_ids)))
        return real(self, new_ids, images=images, **kw)

    monkeypatch.setattr(engine.ChatSession, "chat", chat)
    run_valley_conv.main(["--model-name", "random:tiny", "--video-file",
                          clip, "--device", "cpu", "--max-new-tokens", "4",
                          "--temperature", "0"])
    out = capsys.readouterr().out
    assert "switched to" in out and out.count("Assistant: ") == 3
    # media and the whole prompt on each first turn; the follow-up sends
    # only " Human: And then?###Assistant:" (no BOS)
    assert [s[:2] for s in seen] == [(True, False), (False, True),
                                     (True, False)]
    assert seen[1][2] == len(" Human: And then?###Assistant:".encode())


def test_run_valley_conv_wants_the_card_without_device_cpu(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_valley_conv.main(["--model-name", "random:tiny", "--video-file",
                              _frame_dir(tmp_path)])
    # an adapter merges into a checkpoint's weights, not random ones
    with pytest.raises(ValueError, match="lora-path"):
        run_valley_conv.main(["--model-name", "random:tiny", "--video-file",
                              ".", "--lora-path", "x", "--device", "cpu"])
