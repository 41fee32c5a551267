"""Grouped W4A8 (modes ``int4ga8`` and ``int4gpa8``) and grouped int8 scales
in the PyTorch port against the JAX package on the CPU: the quantizer bit
for bit (packed bytes included) with its refusals, K8's plain version
against JAX's ``_w4a8_group_dot``, ``_proj`` on either side of the
sequence gate and at the per-channel fallback, grouped int8 products, and
greedy tokens of both engines with an int8 tower and each learned pooling.

The tiny model's hidden size is 128 here (valley_tiny's 64 takes no group
of 128), and the engines' prompts sit in the 128 bucket, so prefill runs
W4A8.  Inputs are made with numpy from a seed and one JAX init feeds both
packages through ``weights.from_jax_params``.  On the CPU the K8 wrapper
runs its plain version, whose calls the tests count to show the W4A8 path
ran.  Tolerances are stated in each test.
"""

import dataclasses

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
from valley_tpu_torch.inference import engine
from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import quant, w4a8
from valley_tpu_torch.ops.attention import KERNELS, PLAIN
from valley_tpu_torch.weights import from_jax_params, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False

NEW = 16


def _cfg(method="mean"):
    cfg = C.valley_tiny(patch_pooling_method=method)
    return cfg.replace(text=dataclasses.replace(
        cfg.text, hidden_size=128, intermediate_size=256))


def _np(x):
    """A writable numpy copy; bf16 as float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                    else x)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of K8's plain version (what the wrapper runs on the
    CPU) in a one-element list."""
    calls = [0]
    real = w4a8.w4a8_group_plain

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(w4a8, "w4a8_group_plain", counted)
    return calls


def _jax_tree(cfg, seed, dtype, mode, fused=True):
    """A JAX tree as the JAX worker makes it: fuse, quantize (``mode``'s
    knobs), pack where the mode packs."""
    tree = jvalley.init_params(cfg, jax.random.key(seed), dtype)
    if fused:
        tree = jllama.fuse_llama_params(tree)
    qm = jquant.parse_quant_mode(mode)
    tree = jquant.quantize_llama_params(tree, bits=qm["bits"],
                                        group_size=qm["group_size"],
                                        act8=qm["act8"])
    if qm["packed"]:
        tree = jquant.pack_int4_params(tree)
    return jax.device_get(tree)


@pytest.mark.parametrize("mode,fused,dtype,hidden", [
    ("int4gpa8", True, jnp.bfloat16, 128), ("int4ga8", False, jnp.float32,
                                            64)])
def test_w4a8_quantizer_matches_jax_bit_for_bit(mode, fused, dtype, hidden):
    """``quantize_llama_params`` with act8 and bits 4 against the JAX
    quantizer and packer: every packed byte and ``_scale_a8`` scale equal
    (int4ga8's int8-stored tree packed by the conversion), the lm_head per
    channel with ``lm_head_scale``; group-128 scales where 128 divides a
    projection's K, per channel where it does not (valley_tiny's 64-wide
    projections)."""
    qm = quant.parse_quant_mode(mode)
    assert qm == jquant.parse_quant_mode(mode)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    cfg = _cfg() if hidden == 128 else C.valley_tiny()
    want = from_jax_params(_jax_tree(cfg, 3, dtype, mode, fused), "cpu", tdt)
    base = jvalley.init_params(cfg, jax.random.key(3), dtype)
    if fused:
        base = jllama.fuse_llama_params(base)
    got = quant.quantize_llama_params(
        from_jax_params(jax.device_get(base), "cpu", tdt),
        act8=qm["act8"], bits=qm["bits"], group_size=qm["group_size"])
    g, w = got["llama"].state_dict(), want["llama"].state_dict()
    assert set(g) == set(w)
    for n in w:
        assert g[n].dtype == w[n].dtype and torch.equal(g[n], w[n]), n
    lay = got["llama"]["layers"]
    scales = [n for n in g if n.endswith("_scale_a8")]
    assert scales and "lm_head_scale" in g
    for n in scales:
        name = n[len("layers."):-len("_scale_a8")]
        k = 2 * lay[name].shape[-1]
        assert (g[n].dim() == 3) == (k % 128 == 0), n


def test_grouped_int8_and_refusals_match_jax():
    """Grouped int8 scales (bits 8 with a group size; no mode asks for
    them) bit for bit against JAX, with JAX's per-channel fallback where
    the group does not divide K; act8 with per-channel int4 and act8 with
    grouped int8 raise JAX's ValueErrors."""
    cfg = C.valley_tiny()         # hidden 64, intermediate 128
    base = jax.device_get(jvalley.init_params(cfg, jax.random.key(4),
                                              jnp.float32))
    want = from_jax_params(jax.device_get(jquant.quantize_llama_params(
        jax.tree.map(jnp.asarray, base), bits=8, group_size=128)), "cpu")
    got = quant.quantize_llama_params(from_jax_params(base, "cpu"), bits=8,
                                      group_size=128)
    g, w = got["llama"].state_dict(), want["llama"].state_dict()
    assert set(g) == set(w)
    for n in w:
        assert g[n].dtype == w[n].dtype and torch.equal(g[n], w[n]), n
    # w_down (K 128) grouped, the 64-wide projections per channel
    assert g["layers.w_down_scale"].shape == (2, 64, 1)
    assert g["layers.wq_scale"].shape == (2, 64)
    assert g["layers.w_down"].dtype == torch.int8
    for kw, match in ((dict(bits=4, group_size=0), "group_size"),
                      (dict(bits=8, group_size=128), "per-channel")):
        with pytest.raises(ValueError, match=match):
            jquant.quantize_llama_params(jax.tree.map(jnp.asarray, base),
                                         act8=True, **kw)
        with pytest.raises(ValueError, match=match):
            quant.quantize_llama_params(from_jax_params(base, "cpu"),
                                        act8=True, **kw)


@pytest.mark.parametrize("rows", [1, 9, 128])
def test_grouped_int8_proj_matches_jax(rows):
    """A grouped int8 projection's product (the dequantized weight in the
    port; JAX's grouped branches), fp32, within 1e-5 of the largest."""
    cfg = C.valley_tiny()
    tree = jax.device_get(jquant.quantize_llama_params(
        jvalley.init_params(cfg, jax.random.key(5), jnp.float32), bits=8,
        group_size=32))
    params = from_jax_params(tree, "cpu")
    lp = {n: jnp.asarray(v[1]) for n, v in tree["llama"]["layers"].items()}
    x = np.random.default_rng(rows).standard_normal((1, rows, 64)).astype(
        np.float32)
    want = np.asarray(jllama._proj(lp, "wq", jnp.asarray(x)))
    got = llama._proj(params["llama"]["layers"], 1, "wq",
                      torch.from_numpy(x), KERNELS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("t,k,f", [(128, 256, 384), (200, 512, 130),
                                   (130, 1024, 8)])
def test_w4a8_group_dot_matches_jax(plain_calls, t, k, f):
    """`llama._w4a8_group_dot` (per-token quantization, then K8's plain
    version) against JAX's on the same int4 values and bf16 group scales,
    fp32 activations: within 2e-6 of the largest |y|.  Both sum each group
    exactly in int32; the fp32 sum over the K/128 groups may take another
    order in XLA's reduction, the only difference (the readings here are
    0)."""
    rng = np.random.default_rng(t + k)
    x = rng.standard_normal((1, t, k)).astype(np.float32)
    w8 = rng.integers(-8, 8, (f, k)).astype(np.int8)
    s = jnp.asarray(rng.random((f, k // 128)) * .02 + .01, jnp.bfloat16)
    want = np.asarray(jllama._w4a8_group_dot(jnp.asarray(x),
                                             jnp.asarray(w8), s))
    got = llama._w4a8_group_dot(torch.from_numpy(x),
                                quant.pack_int4(torch.from_numpy(w8)),
                                torch.from_numpy(_np(s)).bfloat16())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert plain_calls[0] == 1 and w4a8.w4a8_group_gemm.launches == 0


def test_w4a8_plain_rejects_misshapen_groups():
    with pytest.raises(ValueError, match="grouped W4A8"):
        w4a8.w4a8_group_plain(torch.zeros((4, 100), dtype=torch.int8),
                              torch.ones(4), torch.zeros((3, 50),
                                                         dtype=torch.uint8),
                              torch.ones((3, 3), dtype=torch.bfloat16))


@pytest.fixture(scope="module")
def a8_trees():
    """int4gpa8 trees (fp32 float leaves) of the 128-wide model, fused and
    unfused, as JAX makes them, and the port's conversions."""
    out = {}
    for fused in (True, False):
        tree = _jax_tree(_cfg(), 6, jnp.float32, "int4gpa8", fused)
        out[fused] = (tree, from_jax_params(tree, "cpu", torch.float32))
    return out


@pytest.mark.parametrize("name,rows", [
    ("wqkv", 127), ("wqkv", 128), ("w_down", 127), ("w_down", 128),
    ("w_gateup", 256), ("wo", 1)])
def test_w4a8_proj_gate_matches_jax(plain_calls, a8_trees, name, rows):
    """``_proj`` of layer 1 of the fused int4gpa8 tree on either side of
    the sequence gate: 127 rows take the dequantized product (JAX: the
    grouped einsum), 128 and more W4A8 (K8's plain version; JAX:
    ``_w4a8_group_dot``), one row K5's plain version; `PLAIN` gives the
    same bits.  fp32 activations,
    within 2e-6 of the largest output at the gate and above, 1e-5 below
    (the dequantized product sums in another order)."""
    tree, params = a8_trees[True]
    view = jquant.unpack_int4_view(jax.tree.map(jnp.asarray, tree))
    lp = {n: v[1] for n, v in view["llama"]["layers"].items()}
    k = params["llama"]["layers"][name].shape[-1] * 2
    x = np.random.default_rng(rows).standard_normal((1, rows, k)).astype(
        np.float32)
    want = np.asarray(jllama._proj(lp, name, jnp.asarray(x)))
    got = llama._proj(params["llama"]["layers"], 1, name,
                      torch.from_numpy(x), KERNELS)
    a8 = rows >= llama._A8_MIN_SEQ
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=(
        2e-6 if a8 else 1e-5) * np.abs(want).max())
    assert plain_calls[0] == int(a8)
    # the plain choice (the card's reference path) computes the same
    assert torch.equal(llama._proj(params["llama"]["layers"], 1, name,
                                   torch.from_numpy(x), PLAIN), got)


@pytest.mark.parametrize("rows", [127, 128])
def test_w4a8_per_channel_fallback_matches_jax(plain_calls, rows):
    """Where 128 does not divide K (valley_tiny's 64-wide projections)
    int4ga8 keeps per-channel scales under ``_scale_a8``, and 128+ rows
    take W8A8 on the int4 values as JAX's ``_proj`` sends them
    (`_w8a8_dot`), not K8; 127 rows the dequantized product.  fp32, within
    2e-6 of the largest output (1e-5 below the gate)."""
    cfg = C.valley_tiny()
    tree = _jax_tree(cfg, 8, jnp.float32, "int4ga8")
    params = from_jax_params(tree, "cpu", torch.float32)
    lay = params["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.uint8
    assert lay["wqkv_scale_a8"].shape == (2, 192)
    lp = {n: jnp.asarray(v[1]) for n, v in tree["llama"]["layers"].items()}
    x = np.random.default_rng(rows).standard_normal((1, rows, 64)).astype(
        np.float32)
    want = np.asarray(jllama._proj(lp, "wqkv", jnp.asarray(x)))
    got = llama._proj(lay, 1, "wqkv", torch.from_numpy(x), KERNELS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=(
        2e-6 if rows >= 128 else 1e-5) * np.abs(want).max())
    assert plain_calls[0] == 0


def test_w4a8_tree_round_trips(a8_trees):
    """A converted int4gpa8 tree goes back to JAX's layout unchanged
    (`to_numpy`), and the port's quantizer makes it from the float tree."""
    tree, params = a8_trees[False]
    back = to_numpy(params)
    for level in ("layers",):
        for n, v in tree["llama"][level].items():
            np.testing.assert_array_equal(back["llama"][level][n],
                                          _np(jnp.asarray(v)), err_msg=n)
    np.testing.assert_array_equal(back["llama"]["lm_head"],
                                  tree["llama"]["lm_head"])


def _prompt_and_media(cfg, seed):
    """A video prompt of 4 raw uint8 frames in the 128 bucket."""
    rng = np.random.default_rng(seed)
    tok = cfg.tokens
    size = cfg.vision.image_size
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 4 + [tok.vi_end]
    prompt = [1] + span + rng.integers(5, 400, 100).tolist()
    return prompt, rng.integers(0, 256, (1, 4, 3, size, size)).astype(
        np.uint8)


@pytest.mark.parametrize("mode,method,vision", [
    ("int4ga8", "temporal_importance", "int8"),
    ("int4gpa8", "temporal_transformer", "int8a8")])
def test_w4a8_slice_tokens_identical_to_jax_engine(plain_calls, mode, method,
                                                   vision):
    """Fused int4ga8 / int4gpa8 weights, an int8 (weight-only) or int8a8
    tower, learned pooling, an int8 KV cache, greedy over 16 tokens: the
    same tokens as the JAX engine (``decode_w4`` / ``w4_packed`` as the JAX
    worker sets them).  The 128-bucket prefill runs W4A8 (4 products a
    layer through K8's plain version, counted), decode K5's plain version
    with the a8 scales, as int4g's.  W4A8 and W8A8 round activations to
    int8, so an fp32 difference at a rounding edge moves an input one int8
    step and the logits by ~1e-2 (a trace of this model at another seed
    shows one); these seeded inputs part no greedy token."""
    cfg = _cfg(method)
    qm = jquant.parse_quant_mode(mode)
    tree = jvalley.init_params(cfg, jax.random.key(9), jnp.float32)
    tree = jquant.quantize_llama_params(jllama.fuse_llama_params(tree),
                                        bits=4, group_size=128, act8=True)
    if qm["packed"]:
        tree = jquant.pack_int4_params(tree)
    tree = jquant.quantize_vision_params(tree, act8=vision == "int8a8")
    params = from_jax_params(jax.device_get(tree), "cpu", torch.float32)
    assert params["vision"]["layers"]["fc1"].dtype == torch.int8
    jeng = jengine.Engine(cfg, tree, buckets=(128,), max_new_tokens=NEW,
                          cache_dtype=jnp.int8, use_flash=False,
                          steps_per_call=4, decode_w4=not qm["packed"],
                          w4_packed=qm["packed"])
    teng = engine.Engine(cfg, params, buckets=(128,), max_new_tokens=NEW,
                         cache_dtype=torch.int8, steps_per_call=4)
    prompt, media = _prompt_and_media(cfg, 10)
    want = [int(t[0]) for t in jeng.generate_tokens(
        [prompt], media, jengine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    got = [int(t[0]) for t in teng.generate_tokens(
        [prompt], media, engine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    assert len(got) == NEW
    assert got == want
    # the prefill's four fused products a layer took W4A8, decode did not
    assert plain_calls[0] == 4 * cfg.text.num_hidden_layers
