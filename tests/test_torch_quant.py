"""The port's int8 serving path against the JAX package on the CPU: the
quantizer, the int8 GEMV's plain version (K4), W8A8, the int8 KV cache,
the int8-cache decode attention, weight conversion, and the whole slice
(fused int8a8 weights with an int8 cache) through both engines.

Inputs are made with numpy from a seed and handed to both sides.  Pallas
kernels run in interpret mode.  Tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valley_tpu import config as C
from valley_tpu.inference import engine as jengine
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import attention as jattn
from valley_tpu.ops import quant as jquant
from valley_tpu.ops.decode_pallas import decode_attention_stacked as jdecode
from valley_tpu_torch.inference import engine
from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import quant
from valley_tpu_torch.ops.attention import KERNELS, PLAIN, decode_attention
from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.weights import from_jax_params, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False

NEW = 12


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


def _np(x):
    """A writable numpy copy; bf16 as float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                    else x)


def _jax_tree(cfg, seed, dtype, fused=True, mode=None):
    """A JAX Valley tree, fused and quantized as the worker does: fuse,
    then quantize (``mode`` int8 or int8a8)."""
    tree = jvalley.init_params(cfg, jax.random.key(seed), dtype)
    if fused:
        tree = jllama.fuse_llama_params(tree)
    if mode:
        tree = jquant.quantize_llama_params(
            tree, act8=jquant.parse_quant_mode(mode)["act8"])
    return jax.device_get(tree)


def _mismatches(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).sum())


@pytest.mark.parametrize("mode,fused,dtype", [
    ("int8", False, jnp.bfloat16), ("int8a8", True, jnp.bfloat16),
    ("int8a8", True, jnp.float32)])
def test_quantizer_matches_jax_bit_for_bit(cfg, mode, fused, dtype):
    """int8 values and bf16 scales equal the JAX quantizer's on every
    target (round-half ties included: both round half to even on the same
    quotients, so the bound of 0.01 % of elements is met with 0)."""
    tree = _jax_tree(cfg, 0, dtype, fused=fused)
    want = _jax_tree(cfg, 0, dtype, fused=fused, mode=mode)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    params = from_jax_params(tree, "cpu", tdtype)
    knobs = quant.parse_quant_mode(mode)
    got = quant.quantize_llama_params(params, act8=knobs["act8"])
    key = "_scale_a8" if knobs["act8"] else "_scale"
    gl, wl = got["llama"], want["llama"]
    names = ("wqkv", "wo", "w_gateup", "w_down") if fused else (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    bad = total = 0
    for n in names:
        q = gl["layers"][n]
        assert q.dtype == torch.int8 and not q.requires_grad
        bad += _mismatches(_np(q), wl["layers"][n])
        total += q.numel()
        s = gl["layers"][n + key]
        assert s.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(s), _np(wl["layers"][n + key]))
    # lm_head: stored (out, in) in the port, (in, out) in JAX
    assert tuple(gl["lm_head"].shape) == wl["lm_head"].shape[::-1]
    bad += _mismatches(_np(gl["lm_head"]).T, wl["lm_head"])
    total += gl["lm_head"].numel()
    np.testing.assert_array_equal(_np(gl["lm_head_scale"]),
                                  _np(wl["lm_head_scale"]))
    assert bad <= 1e-4 * total, f"{bad} of {total} int8 values differ"
    assert bad == 0


def test_unserved_modes_raise():
    """Every mode is served now: the grouped W4A8 modes parse to the JAX
    knobs as the others do, and so does every other mode; an unknown mode
    raises JAX's ValueError, and act8 with per-channel int4 or grouped
    int8 JAX's refusals (the W4A8 quantizer, grouped int8 and the vision
    quantizer against JAX: tests/test_torch_w4a8.py,
    tests/test_torch_vision_quant.py)."""
    for mode in quant.QUANT_MODES:
        assert quant.parse_quant_mode(mode) == jquant.parse_quant_mode(mode)
    assert set(quant.SERVED_MODES) == set(jquant.QUANT_MODES)
    with pytest.raises(ValueError, match="group_size"):
        quant.quantize_llama_params(None, act8=True, bits=4, group_size=0)
    with pytest.raises(ValueError, match="per-channel"):
        quant.quantize_llama_params(None, act8=True, bits=8, group_size=128)
    with pytest.raises(ValueError, match="unknown"):
        quant.parse_quant_mode("fp8")
    assert quant.QUANT_MODES == jquant.QUANT_MODES


@pytest.mark.parametrize("b,k,f,block_f", [(1, 256, 384, 128),
                                           (3, 512, 200, 512),
                                           (9, 256, 384, 128),
                                           (16, 512, 200, 512),
                                           (9, 272, 383, 128),
                                           (16, 4112, 1001, 512)])
def test_int8_matvec_plain_matches_jax_kernel(b, k, f, block_f):
    """JAX's Pallas kernel (interpret mode) takes w (in, out) and a (1, F)
    scale; the port's takes w (out, in) and an (F,) scale.  fp32 outputs
    agree to 1e-5 of their largest (the same exact products, summed in
    another order), at 1 to 16 rows, and at an odd F with a K that is not a
    multiple of the kernel's 64-input units."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, f)).astype(np.int8)
    s = (rng.random((1, f)) * 0.01).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    sb = jnp.asarray(s, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jquant.int8_matvec(xb, jnp.asarray(w), sb,
                                             block_f=block_f))
    tx = torch.from_numpy(_np(xb)).bfloat16()
    tw = torch.from_numpy(w.T.copy())
    ts = torch.from_numpy(_np(sb)).bfloat16().reshape(-1)
    for fn in (quant.int8_matvec_plain, quant.int8_matvec):  # CPU: plain
        got = fn(tx, tw, ts)
        assert got.dtype == torch.float32 and got.shape == (b, f)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert quant.int8_matvec.launches == 0
    # the JAX dequant_matmul (w (in, out)) gives the same product
    np.testing.assert_allclose(
        _np(quant.dequant_matmul(tx.float(), torch.from_numpy(w), ts)),
        np.asarray(jquant.dequant_matmul(jnp.asarray(_np(xb)),
                                         jnp.asarray(w), sb)),
        rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def a8_trees(cfg):
    """A fused int8a8 JAX tree (fp32 float leaves) and the port's."""
    tree = _jax_tree(cfg, 7, jnp.float32, fused=True, mode="int8a8")
    return tree, from_jax_params(tree, "cpu", torch.float32)


@pytest.mark.parametrize("name,rows", [
    ("wqkv", 1), ("w_down", 1), ("wo", 8), ("w_gateup", 16),
    ("wqkv", 128), ("w_down", 256)])
def test_proj_matches_jax(cfg, a8_trees, name, rows):
    """The port's ``_proj`` against JAX's on one layer of the int8a8 tree:
    rows <= 8 take K4's plain version, 16 the dequantized product, 128+
    (the a8 gate) W8A8.  fp32 activations; agreement to 1e-5 of the
    largest output (W8A8: both quantize the same fp32 rows)."""
    tree, params = a8_trees
    lp = {n: jnp.asarray(v[1]) for n, v in tree["llama"]["layers"].items()}
    k = lp[name].shape[-1]
    x = np.random.default_rng(2).standard_normal((1, rows, k)).astype(
        np.float32)
    want = np.asarray(jllama._proj(lp, name, jnp.asarray(x)))
    for attention in (KERNELS, PLAIN):
        got = llama._proj(params["llama"]["layers"], 1, name,
                          torch.from_numpy(x), attention)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rows", [1, 3, 20])
def test_int8_lm_head_matches_jax(a8_trees, rows):
    """logits_from_hidden with the int8 lm_head, stored (out, in) in the
    port and (in, out) in JAX: fp32 logits to 1e-5 of the largest."""
    tree, params = a8_trees
    h = np.random.default_rng(3).standard_normal(
        (1, rows, tree["llama"]["lm_head"].shape[0])).astype(np.float32)
    want = np.asarray(jllama.logits_from_hidden(
        jax.tree.map(jnp.asarray, tree["llama"]), jnp.asarray(h)))
    got = llama.logits_from_hidden(params["llama"], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,shape", [
    (np.float32, (2, 130, 64)), (jnp.bfloat16, (1, 128, 128))])
def test_w8a8_dot_matches_jax(dtype, shape):
    """Same per-token int8 activations, exact int32 products, the same
    fp32 rescale: equal to 1e-6 of the largest output in fp32, one bf16
    ulp (2^-8 relative) in bf16."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(shape), dtype)
    w = rng.integers(-127, 128, (96, shape[-1])).astype(np.int8)
    s = jnp.asarray(rng.random(96) * 0.01, jnp.bfloat16)
    want = _np(jllama._w8a8_dot(x, jnp.asarray(w), s))
    tx = torch.from_numpy(_np(x))
    if dtype == jnp.bfloat16:
        tx = tx.bfloat16()
    got = llama._w8a8_dot(tx, torch.from_numpy(w),
                          torch.from_numpy(_np(s)).bfloat16())
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    rel = 1e-6 if dtype == np.float32 else 2 ** -8
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _tensor(x):
    """A torch copy of a JAX or numpy array, bf16 kept bf16."""
    t = torch.from_numpy(_np(x))
    return t.bfloat16() if np.asarray(x).dtype == jnp.bfloat16 else t


# (shape, seed): the serving cache's width at 4 rows of 512 slots, and the
# tiny config's (2 KV heads of 32, a 16-slot chunk)
KV_SHAPES = [((4, 512, 32, 128), 0), ((2, 16, 4, 32), 5)]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_kv_matches_jax(dtype):
    """Identical int8 values and bf16 scales to JAX's `_quantize_kv` under
    jax.jit, as its engine runs it, at each of `KV_SHAPES`: XLA takes
    JAX's ``/ 127.0`` as the product with fl32(1/127), the port writes
    that product.  Run op by op, JAX divides: at the 7B shape in bf16 that
    moves 885 of its 8,388,608 values, which this test must see (the
    quotient is not the jitted form)."""
    for shape, seed in KV_SHAPES:
        x = jnp.asarray(np.random.default_rng(seed).standard_normal(
            shape) * 3, dtype)
        wq, ws = jax.jit(jllama._quantize_kv)(x)
        q, s = llama._quantize_kv(_tensor(x))
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_np(s), _np(ws))
        if shape[1] == 512 and dtype == jnp.bfloat16:
            eq, _ = jllama._quantize_kv(x)
            assert _mismatches(eq, wq) == 885


# (bits, group): int8 per channel, the int4 modes per channel and grouped,
# and grouped int8, whose fp32 case parts from the quotient
STACK_QUANT = [(8, 0), (4, 0), (4, 128), (8, 64), (4, 32)]


@pytest.mark.parametrize("bits,group", STACK_QUANT)
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_stacked_quantizer_matches_jitted_jax(dtype, bits, group):
    """A decoder stack (L, out, in) through `quant.quantize_tensor`: int8
    values and bf16 scales identical to JAX's `quantize_tensor`, whose
    stacks go through the jitted ``_quantize_stacked``: the scale amax
    times fl32(1/qmax), the values round(w / scale).  The quotient (JAX's
    numpy host quantizer) moves values of the fp32 grouped int8 stack
    (checked, so the case tells the two forms apart)."""
    w = jnp.asarray(np.random.default_rng(1).standard_normal(
        (8, 512, 1024)) * 0.02, dtype)
    wq, ws = jquant.quantize_tensor(w, bits=bits, group_size=group)
    q, s = quant.quantize_tensor(_tensor(w), bits=bits, group_size=group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_np(s), _np(ws))
    if (bits, group, dtype) == (8, 64, np.float32):
        hq, _ = jquant._quantize_one_host(np.asarray(w), -1, bits, group)
        assert _mismatches(hq, wq) > 0


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_tower_w8a8_dot_matches_jitted_jax(dtype):
    """The W8A8 tower product `clip_vit._dot` bit for bit against JAX's
    under jax.jit, as the engine serves the tower (8 frames of 257
    tokens): the token scale is the absmax times fl32(1/127), as XLA
    compiles JAX's ``/ 127.0``.  JAX run op by op divides and differs in
    thousands of outputs (checked)."""
    from valley_tpu.models import clip_vit as jclip
    from valley_tpu_torch.models import clip_vit

    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((8, 257, 256)), dtype)
    w = rng.integers(-127, 128, (1, 256, 384)).astype(np.int8)
    sc = jnp.asarray(rng.random((1, 1, 384)) * 0.01, jnp.bfloat16)
    lp = {"wq": jnp.asarray(w[0]), "wq_scale_a8": sc[0]}
    want = _np(jax.jit(lambda x: jclip._dot(lp, "wq", x))(x))
    got = clip_vit._dot({"wq": torch.from_numpy(w),
                         "wq_scale_a8": _tensor(sc)}, 0, "wq", _tensor(x))
    assert got.dtype == _tensor(x).dtype
    np.testing.assert_array_equal(_np(got), want)
    assert _mismatches(_np(jclip._dot(lp, "wq", x)), want) > 1000


def test_init_cache_int8_has_two_scale_buffers(cfg):
    c = llama.init_cache(cfg.text, 1, 16, torch.int8)
    assert c.k.dtype == torch.int8 and c.k_scale.dtype == torch.bfloat16
    assert tuple(c.k_scale.shape) == tuple(c.k.shape[:-1])
    assert c.k_scale.data_ptr() != c.v_scale.data_ptr()
    assert llama.init_cache(cfg.text, 1, 16).k_scale is None


# the int8 geometries of tests/test_decode_kernel.py
@pytest.mark.parametrize("geo", [(1, 96, 4, 2, 32), (2, 640, 8, 8, 128)])
def test_decode_int8_plain_matches_jax(geo):
    """decode_attention_plain over an int8 cache with scales: within 2e-2
    of the Pallas kernel in interpret mode (its bar against the oracle,
    tests/test_decode_kernel.py: the kernel scales unnormalised block
    probabilities) and within one bf16 rounding (2^-7 at outputs below 1)
    of the XLA oracle."""
    b, s, h, hkv, d = geo
    rng = np.random.default_rng(0)
    n_layers, li = 3, 1
    q = jnp.asarray(rng.standard_normal((b, 1, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((n_layers, b, s, hkv, d)) * 0.5,
                    jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((n_layers, b, s, hkv, d)) * 0.5,
                    jnp.bfloat16)
    mask = np.asarray(rng.random((b, s)) < 0.8)
    mask[:, :4] = True
    kq, ks = jllama._quantize_kv(k.reshape(n_layers * b, s, hkv, d))
    vq, vs = jllama._quantize_kv(v.reshape(n_layers * b, s, hkv, d))
    kq, vq = (a.reshape(n_layers, b, s, hkv, d) for a in (kq, vq))
    ks, vs = (a.reshape(n_layers, b, s, hkv) for a in (ks, vs))
    with pltpu.force_tpu_interpret_mode():
        kern = _np(jdecode(q, kq, vq, li, jnp.asarray(mask), k_scale=ks,
                           v_scale=vs))
    oracle = _np(jattn.decode_attention(q, kq[li], vq[li], jnp.asarray(mask),
                                        k_scale=ks[li], v_scale=vs[li]))
    tq = torch.from_numpy(_np(q)).bfloat16()
    tk, tv = (torch.from_numpy(np.asarray(a)) for a in (kq, vq))
    tks, tvs = (torch.from_numpy(_np(a)).bfloat16() for a in (ks, vs))
    tm = torch.from_numpy(mask)
    got = decode_attention_plain(tq, tk, tv, li, tm, tks, tvs)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, 1, h, d)
    assert np.abs(_np(got) - kern).max() < 2e-2
    np.testing.assert_allclose(_np(got), oracle, atol=2 ** -7)
    # the wrapper on CPU tensors and the per-layer oracle are the same
    assert torch.equal(decode_attention_stacked(tq, tk, tv, li, tm, tks, tvs),
                       got)
    assert torch.equal(decode_attention(tq, tk[li], tv[li], tm, tks[li],
                                        tvs[li]), got)


def test_fused_int8a8_tree_converts_and_round_trips(a8_trees):
    tree, params = a8_trees
    lay = params["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.int8
    assert lay["wqkv_scale_a8"].dtype == torch.bfloat16
    assert "wq" not in lay and "wq_scale" not in lay
    assert lay["attn_norm"].dtype == torch.float32
    assert params["vision"]["layers"]["ln1_scale"].dtype == torch.float32
    assert not any(p.requires_grad for p in params.parameters())
    back = to_numpy(params)
    for part in ("llama",):
        for name, a in tree[part]["layers"].items():
            np.testing.assert_array_equal(back[part]["layers"][name],
                                          _np(a))
            assert back[part]["layers"][name].dtype == (
                np.int8 if np.asarray(a).dtype == np.int8 else np.float32)
        for name in ("lm_head", "lm_head_scale", "embed"):
            np.testing.assert_array_equal(back[part][name],
                                          _np(tree[part][name]))
    again = from_jax_params(back, "cpu", torch.float32)
    for (n, a), (m, b_) in zip(params.state_dict().items(),
                               again.state_dict().items()):
        assert n == m and a.dtype == b_.dtype and torch.equal(a, b_)
    # bf16 float leaves: int8 leaves and scales keep their types
    half = from_jax_params(tree, "cpu", torch.bfloat16)
    assert half["llama"]["lm_head"].dtype == torch.int8
    assert half["llama"]["embed"].dtype == torch.bfloat16


def test_port_fuse_matches_jax(cfg):
    tree = _jax_tree(cfg, 8, jnp.float32, fused=False)
    fused = _jax_tree(cfg, 8, jnp.float32, fused=True)
    params = llama.fuse_llama_params(from_jax_params(tree, "cpu"))
    for n in ("wqkv", "w_gateup"):
        np.testing.assert_array_equal(_np(params["llama"]["layers"][n]),
                                      fused["llama"]["layers"][n])
    assert llama.fuse_llama_params(params) is params


@pytest.fixture(scope="module")
def engines(cfg, a8_trees):
    tree, params = a8_trees
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree),
                          buckets=(64, 128), max_new_tokens=NEW,
                          cache_dtype=jnp.int8, use_flash=False,
                          steps_per_call=4)
    teng = engine.Engine(cfg, params, buckets=(64, 128), max_new_tokens=NEW,
                         cache_dtype=torch.int8, steps_per_call=4)
    return jeng, teng


def _prompt_and_media(cfg, case, n_text, seed):
    rng = np.random.default_rng(seed)
    tok = cfg.tokens
    size = cfg.vision.image_size
    if case == "text":
        return rng.integers(5, 400, n_text).tolist(), None
    t = 1 if case == "image" else 4
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * t + [tok.vi_end]
    prompt = [1] + span + rng.integers(5, 400, n_text).tolist()
    if case == "image":
        return prompt, rng.standard_normal((1, t, 3, size, size)).astype(
            np.float32)
    return prompt, rng.integers(0, 256, (1, t, 3, size, size)).astype(
        np.uint8)


def _jax_prefill_logits(jeng, prompt, images):
    bucket = jeng.pick_bucket(len(prompt))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(prompt)] = prompt
    imgs, frame_mask, has = jeng._prepare_images(images, 1)
    _, logits, _, _ = jeng._prefill(
        jeng.params, jnp.asarray(ids), imgs,
        jnp.asarray([len(prompt)], np.int32), jax.random.key(0), 1.0, 1.0,
        frame_mask, bucket=bucket,
        cache_len=bucket + jeng.max_new_tokens + jeng.steps_per_call,
        do_sample=False, has_images=has)
    return np.asarray(logits)


# The prefill logits of the two engines: the same fp32 arithmetic summed
# in another order.  Readings of this file on the CPU: at most 2.7e-6.  The
# bar leaves room for that noise only: at the 128 bucket W8A8 quantizes
# activations that carry it, and one int8 step moved by it would show as
# ~1e-3, which these seeded inputs do not hit.
PREFILL_LOGIT_TOL = 1e-4


@pytest.mark.parametrize("bucket", [64, 128])
@pytest.mark.parametrize("case", ["text", "image", "video_uint8"])
def test_int8_slice_tokens_identical_to_jax_engine(cfg, engines, case,
                                                   bucket):
    """Fused int8a8 weights with an int8 KV cache, greedy: the same tokens
    as the JAX engine, below the a8 gate (bucket 64, dequantized prefill)
    and above it (bucket 128, W8A8 prefill); decode runs K4's and the
    int8-cache decode attention's plain versions."""
    jeng, teng = engines
    n_text = 20 if bucket == 64 else 90
    prompt, media = _prompt_and_media(cfg, case, n_text, seed=bucket)
    assert teng.pick_bucket(len(prompt)) == bucket
    want = [int(t[0]) for t in jeng.generate_tokens(
        [prompt], media, jengine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    state = teng.prefill([prompt], media)
    assert state.cache.k.dtype == torch.int8
    assert state.cache.k_scale.dtype == torch.bfloat16
    diff = np.abs(state.logits.numpy()
                  - _jax_prefill_logits(jeng, prompt, media)).max()
    assert diff <= PREFILL_LOGIT_TOL, diff
    got = [int(t[0]) for t in teng.generate_tokens(
        [prompt], media, engine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    assert len(got) == NEW
    assert got == want


def _teacher_forced_logits(jeng, teng, prompt, media, steps=3):
    """Relative max differences (port vs JAX, over JAX's largest |logit|)
    of the prefill logits and of ``steps`` decode steps, both fed JAX's
    greedy tokens at slot bucket + i and rotary position len(prompt) + i,
    as the engines' decode does."""
    bucket = jeng.pick_bucket(len(prompt))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(prompt)] = prompt
    imgs, frame_mask, has = jeng._prepare_images(media, 1)
    _, jlog, jcache, jvalid = jeng._prefill(
        jeng.params, jnp.asarray(ids), imgs,
        jnp.asarray([len(prompt)], np.int32), jax.random.key(0), 1.0, 1.0,
        frame_mask, bucket=bucket,
        cache_len=bucket + jeng.max_new_tokens + jeng.steps_per_call,
        do_sample=False, has_images=has)
    state = teng.prefill([prompt], media)
    tc = teng.cfg.text
    jl, tl = jeng.params["llama"], teng.params["llama"]
    tvalid = state.valid.clone()
    out = []
    jl_np, tl_np = _np(jlog), _np(state.logits)
    for i in range(steps + 1):
        out.append(float(np.abs(tl_np - jl_np).max() / np.abs(jl_np).max()))
        if i == steps:
            break
        tok, slot, pos = int(jl_np[0].argmax()), bucket + i, len(prompt) + i
        jvalid = jvalid.at[:, slot].set(True)
        jh, jcache = jllama.forward_hidden(
            jl, tc, jllama.embed(jl, jnp.asarray([[tok]])),
            positions=jnp.asarray([[pos]]), cache=jcache, cache_index=slot,
            kv_valid=jvalid, use_flash=False)
        jl_np = _np(jllama.logits_from_hidden(jl, jh)[:, 0])
        tvalid[:, slot] = True
        with torch.inference_mode():
            th, _ = llama.forward_hidden(
                tl, tc, llama.embed(tl, torch.tensor([[tok]])),
                positions=torch.tensor([[pos]]), cache=state.cache,
                cache_index=slot, kv_valid=tvalid)
            tl_np = _np(llama.logits_from_hidden(tl, th)[:, 0])
    return out


@pytest.mark.parametrize("case", ["text", "video_uint8"])
@pytest.mark.parametrize("mode", ["int8a8", None])
def test_int8a8_bf16_logits_near_jax(cfg, mode, case):
    """bf16 float leaves, as the card serves: fused int8a8 weights (``mode``
    None: the same tree unquantized, for scale), int8 cache, bucket 64; the
    prefill and three teacher-forced decode steps.  Both packages round
    activations to bf16 between ops; the port computes the decode GEMVs'
    products in fp32 (K4's and K6's plain versions) where JAX multiplies
    bf16 lm_head and projections in bf16, and an int8 value of the cache or
    of W8A8 moved across a rounding edge moves one int8 step.  Bar: within
    4e-2 of the largest |logit| at every step, about twice the largest
    reading.  Readings (prefill, steps 1-3): int8a8 text 1.30e-2, 1.27e-2,
    7.30e-3, 8.23e-3; video 1.00e-2, 8.99e-3, 1.08e-2, 1.21e-2; unquantized
    text 8.54e-3, 1.21e-2, 1.22e-2, 7.67e-3; video 1.45e-2, 1.24e-2,
    1.73e-2, 1.82e-2: the int8 path stays as near JAX as the bf16 model
    does."""
    tree = _jax_tree(cfg, 13, jnp.bfloat16, fused=True, mode=mode)
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree), buckets=(64,),
                          max_new_tokens=NEW, cache_dtype=jnp.int8,
                          use_flash=False, steps_per_call=4)
    teng = engine.Engine(cfg, from_jax_params(tree, "cpu", torch.bfloat16),
                         buckets=(64,), max_new_tokens=NEW,
                         cache_dtype=torch.int8, steps_per_call=4)
    prompt, media = _prompt_and_media(cfg, case, 20, seed=19)
    diffs = _teacher_forced_logits(jeng, teng, prompt, media)
    assert max(diffs) <= 4e-2, diffs
