"""Model modules of the PyTorch port against the JAX package on the CPU,
on ``valley_tiny`` with fp32 weights made once by the JAX ``init_params``
and carried over by ``weights.from_jax_params``.

Tolerances: op-level fp32 outputs to 1e-5 (summation order only); logits
after the whole tiny decoder to 1e-4 (the order differences of a dozen
matmuls, on logits of magnitude ~5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.models import clip_vit as jclip
from valley_tpu.models import llama as jllama
from valley_tpu.models import temporal as jtemporal
from valley_tpu.models import valley as jvalley
from valley_tpu_torch.models import clip_vit, llama, temporal, valley
from valley_tpu_torch.weights import from_jax_params

# TF32 off, so fp32 matmuls stay fp32 wherever these run on a card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    return jvalley.init_params(cfg, jax.random.key(3), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu", torch.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _frames(cfg, b, t, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (b, t, 3, cfg.vision.image_size, cfg.vision.image_size)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def test_weights_keep_jax_layouts(cfg, jparams, tparams):
    lay = tparams["llama"]["layers"]
    assert tuple(lay["wq"].shape) == tuple(jparams["llama"]["layers"]["wq"]
                                           .shape)   # (L, out, in)
    assert tuple(tparams["llama"]["lm_head"].shape) == (
        cfg.text.hidden_size, cfg.text.vocab_size)   # (in, out)
    assert tuple(tparams["vision"]["layers"]["fc1"].shape) == (
        cfg.vision.num_hidden_layers, cfg.vision.hidden_size,
        cfg.vision.intermediate_size)                 # (L, in, out)
    np.testing.assert_array_equal(
        _np(lay["w_down"]), np.asarray(jparams["llama"]["layers"]["w_down"]))
    assert not any(p.requires_grad for p in tparams.parameters())


def test_weights_from_bf16_tree(cfg):
    jp = jvalley.init_params(cfg, jax.random.key(4), jnp.bfloat16)
    tp = from_jax_params(jax.device_get(jp), "cpu", torch.bfloat16)
    w = tp["llama"]["embed"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(w), np.asarray(jp["llama"]["embed"], np.float32))


@pytest.mark.parametrize("mutate,match", [
    ("fused", "fused"), ("int8", "quantized"), ("w4a8", "W4A8"),
    ("lora", "LoRA")])
def test_weights_refuse_unported_trees(jparams, mutate, match):
    """The fused layout, int8 and int4 trees convert (tests/
    test_torch_quant.py, tests/test_torch_int4.py); a half-fused tree
    (wqkv beside unfused MLP projections), an int8 vision tower, grouped
    W4A8 (a packed weight with a ``_scale_a8`` scale) and LoRA factors do
    not."""
    tree = jax.device_get(jparams)
    tree = {**tree, "llama": {**tree["llama"],
                              "layers": dict(tree["llama"]["layers"])}}
    lay = tree["llama"]["layers"]
    if mutate == "fused":
        lay["wqkv"] = np.concatenate([lay.pop("wq"), lay.pop("wk"),
                                      lay.pop("wv")], axis=1)
    elif mutate == "int8":
        tree["vision"] = {**tree["vision"],
                          "layers": dict(tree["vision"]["layers"])}
        vl = tree["vision"]["layers"]
        vl["wq"] = np.zeros(np.shape(vl["wq"]), np.int8)
        vl["wq_scale"] = np.ones(np.shape(vl["wq"])[:1] + (1,)
                                 + np.shape(vl["wq"])[-1:], np.float32)
    elif mutate == "w4a8":
        shape = lay["wq"].shape
        lay["wq"] = np.zeros(shape[:-1] + (shape[-1] // 2,), np.uint8)
        lay["wq_scale_a8"] = np.ones(shape[:-1] + (shape[-1] // 32,),
                                     np.float32)
    else:
        lay["wq_lora_a"] = np.zeros((2, 64, 4), np.float32)
    with pytest.raises(NotImplementedError, match=match):
        from_jax_params(tree)


def test_init_params_shapes_match_jax(cfg):
    tp = valley.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    jshapes = jax.eval_shape(lambda k: jvalley.init_params(cfg, k,
                                                           jnp.float32),
                             jax.random.key(0))
    for part in ("llama", "vision"):
        for name, leaf in jshapes[part].items():
            if isinstance(leaf, dict):
                for n, l2 in leaf.items():
                    assert tuple(tp[part][name][n].shape) == l2.shape, n
            else:
                assert tuple(tp[part][name].shape) == leaf.shape, name
    # same scaling: normal * fan_in^-1/2
    std = tp["llama"]["layers"]["w_down"].std().item()
    assert abs(std - cfg.text.intermediate_size ** -0.5) < 0.01


def _prompt(cfg, frames, n_text, seed=0):
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
        [tok.vi_end]
    rng = np.random.default_rng(seed)
    return [1] + span + rng.integers(5, 400, n_text).tolist()


def test_forward_hidden_prefill_then_decode(cfg, jparams, tparams):
    """Bucketed prefill (prompt 17 of 32, cache 48), then 3 decode steps
    from slot 32 at rotary position 17 on: logits, and the cache on its
    valid slots."""
    tc = cfg.text
    rng = np.random.default_rng(1)
    plen, bucket, smax = 17, 32, 48
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :plen] = rng.integers(5, 400, plen)
    valid = np.arange(smax)[None] < plen

    jl = jparams["llama"]
    tl = tparams["llama"]
    jcache = jllama.init_cache(tc, 1, smax, jnp.float32)
    tcache = llama.init_cache(tc, 1, smax, torch.float32)
    jh, jcache = jllama.forward_hidden(
        jl, tc, jllama.embed(jl, jnp.asarray(ids)), cache=jcache,
        cache_index=0, kv_valid=jnp.asarray(valid), use_flash=False)
    th, tcache = llama.forward_hidden(
        tl, tc, llama.embed(tl, torch.from_numpy(ids)), cache=tcache,
        cache_index=0, kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(
        _np(llama.logits_from_hidden(tl, th))[:, :plen],
        np.asarray(jllama.logits_from_hidden(jl, jh))[:, :plen], atol=1e-4)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(_np(a)[:, :, :plen],
                                   np.asarray(b)[:, :, :plen], atol=1e-5)

    tok = int(np.asarray(jnp.argmax(
        jllama.logits_from_hidden(jl, jh)[0, plen - 1])))
    for i in range(3):
        slot, pos = bucket + i, plen + i
        valid[:, slot] = True
        tid = np.array([[tok]])
        jh, jcache = jllama.forward_hidden(
            jl, tc, jllama.embed(jl, jnp.asarray(tid)),
            positions=jnp.asarray([[pos]]), cache=jcache, cache_index=slot,
            kv_valid=jnp.asarray(valid), use_flash=False)
        th, tcache = llama.forward_hidden(
            tl, tc, llama.embed(tl, torch.from_numpy(tid)),
            positions=torch.tensor([[pos]]), cache=tcache, cache_index=slot,
            kv_valid=torch.from_numpy(valid))
        want = np.asarray(jllama.logits_from_hidden(jl, jh))
        np.testing.assert_allclose(_np(llama.logits_from_hidden(tl, th)),
                                   want, atol=1e-4)
        np.testing.assert_allclose(_np(tcache.k)[:, :, slot],
                                   np.asarray(jcache.k)[:, :, slot],
                                   atol=1e-5)
        tok = int(want[0, 0].argmax())


def test_cacheless_forward_matches_jax(cfg, jparams, tparams):
    ids = np.asarray([_prompt(cfg, 2, 9)])
    frames = _frames(cfg, 1, 2)
    want = jvalley.forward(jparams, cfg, jnp.asarray(ids),
                           jnp.asarray(frames))
    got = valley.forward(tparams, cfg, torch.from_numpy(ids),
                         torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("select_layer", [-2, -1, 1])
def test_clip_encode_matches_jax(cfg, jparams, tparams, select_layer):
    px = _frames(cfg, 2, 1)[:, 0]
    want = jclip.encode(jparams["vision"], cfg.vision, jnp.asarray(px),
                        select_layer)
    got = clip_vit.encode(tparams["vision"], cfg.vision, torch.from_numpy(px),
                          select_layer)
    assert tuple(got.shape) == (2, cfg.num_patches + 1,
                                cfg.vision.hidden_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_clip_tap_minus_two_skips_the_last_layer(cfg, tparams):
    """-2 runs L-1 layers: changing the last layer's weights changes
    nothing."""
    px = torch.from_numpy(_frames(cfg, 1, 1)[:, 0])
    before = clip_vit.encode(tparams["vision"], cfg.vision, px)
    lay = tparams["vision"]["layers"]
    saved = lay["fc2"][-1].clone()
    with torch.no_grad():
        lay["fc2"][-1].mul_(3.0)
    try:
        after = clip_vit.encode(tparams["vision"], cfg.vision, px)
    finally:
        with torch.no_grad():
            lay["fc2"][-1].copy_(saved)
    assert torch.equal(before, after)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_encode_images_matches_jax(cfg, jparams, tparams, dtype):
    frames = _frames(cfg, 2, 3, seed=2, dtype=dtype)
    want = jvalley.encode_images(jparams, cfg, jnp.asarray(frames))
    got = valley.encode_images(tparams, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got.pooled), np.asarray(want.pooled),
                               atol=1e-5)
    np.testing.assert_allclose(_np(got.frame_cls),
                               np.asarray(want.frame_cls), atol=1e-5)


def test_encode_images_with_frame_mask(cfg, jparams, tparams):
    frames = _frames(cfg, 2, 4, seed=3)
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    want = jvalley.encode_images(jparams, cfg, jnp.asarray(frames),
                                 frame_mask=jnp.asarray(mask))
    got = valley.encode_images(tparams, cfg, torch.from_numpy(frames),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got.pooled), np.asarray(want.pooled),
                               atol=1e-5)


@pytest.mark.parametrize("method", ["mean", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_pool_patches_matches_jax(cfg, method, masked):
    c = cfg.replace(patch_pooling_method=method)
    x = np.random.default_rng(4).standard_normal((5, 6, 8)).astype(
        np.float32)
    m = np.array([True, True, True, False, False]) if masked else None
    want = jtemporal.pool_patches({}, c, jnp.asarray(x),
                                  None if m is None else jnp.asarray(m))
    got = temporal.pool_patches(c, torch.from_numpy(x),
                                None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_mean_pool_of_bf16_accumulates_in_fp32(cfg):
    x = np.random.default_rng(5).standard_normal((8, 6, 8)).astype(
        np.float32)
    want = jtemporal.pool_patches({}, cfg, jnp.asarray(x, jnp.bfloat16))
    got = temporal.pool_patches(cfg, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=0)


def test_unported_pooling_refused(cfg):
    c = cfg.replace(patch_pooling_method="temporal_transformer")
    with pytest.raises(NotImplementedError, match="not ported"):
        temporal.pool_patches(c, torch.zeros((2, 3, 4)))
    with pytest.raises(NotImplementedError, match="not ported"):
        valley.init_params(c, torch.Generator())


def test_splice_embeddings_multiple_spans(cfg):
    """Two media spans in one row (each receives the same features) and a
    text-only row that passes through."""
    rng = np.random.default_rng(6)
    p, t, h = cfg.num_patches, 3, cfg.text.hidden_size
    row0 = _prompt(cfg, t, 4) + _prompt(cfg, t, 3)[1:]
    row1 = rng.integers(5, 400, len(row0)).tolist()
    ids = np.array([row0, row1])
    embeds = rng.standard_normal(ids.shape + (h,)).astype(np.float32)
    pooled = rng.standard_normal((2, p, h)).astype(np.float32)
    cls = rng.standard_normal((2, t, h)).astype(np.float32)
    want = jvalley.splice_embeddings(
        cfg, jnp.asarray(ids), jnp.asarray(embeds),
        jvalley.VisionFeatures(jnp.asarray(pooled), jnp.asarray(cls)))
    got = valley.splice_embeddings(
        cfg, torch.from_numpy(ids), torch.from_numpy(embeds),
        valley.VisionFeatures(torch.from_numpy(pooled),
                              torch.from_numpy(cls)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got)[1], embeds[1])


def test_unported_branches_raise(cfg, tparams):
    tc = cfg.text
    x = torch.zeros((2, 4, tc.hidden_size))
    cache = llama.init_cache(tc, 2, 8, torch.float32)
    # batched cached inference is ported now: B = 2 prefills at slot 0
    valid = torch.ones((2, 8), dtype=torch.bool)
    hidden, _ = llama.forward_hidden(tparams["llama"], tc, x, cache=cache,
                                     kv_valid=valid)
    assert hidden.shape == x.shape and bool(torch.isfinite(hidden).all())
    with pytest.raises(ValueError, match="per-row cache slots"):
        llama.forward_hidden(tparams["llama"], tc, x[:, :1], cache=cache,
                             cache_index=torch.zeros(3, dtype=torch.long),
                             kv_valid=valid)
    with pytest.raises(NotImplementedError, match="cross_valid"):
        llama.forward_hidden(tparams["llama"], tc, x[:1],
                             cache=llama.init_cache(tc, 1, 8),
                             cross_valid=torch.ones((1, 8), dtype=bool))
