"""The quantized CLIP tower of the PyTorch port (``quantize_vision_params``,
the int8 and W8A8 `clip_vit._dot`, worker ``--quantize-vision``) against
the JAX package on the CPU: the quantizer bit for bit, each product, the
tower, `encode_images`, conversion both ways and the serving budget's
bytes.

Inputs are made with numpy from a seed and one JAX init feeds both packages
through ``weights.from_jax_params``.  Tolerances: fp32 outputs within 1e-5
of the largest |output| (the same arithmetic summed in another order; the
int8 products are exact).  W8A8 rounds each activation to int8, so where
summation order moves an fp32 activation across a rounding edge, that
input moves one int8 step and the outputs after it by up to ~1/127 of
their token's largest: the products fed the same activations (`_dot`) and
the tower on these float frames cross no edge and hold 1e-5;
`encode_images` on raw uint8 frames crosses some (63 of its 512 pooled
values moved, at most 3.6e-3 of the largest), and its W8A8 case is held
to 1e-2 of the largest, about one int8 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.models import clip_vit as jclip
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import quant as jquant
from valley_tpu.serve import hbm as jhbm
from valley_tpu_torch.models import clip_vit, valley
from valley_tpu_torch.ops import quant
from valley_tpu_torch.serve import hbm
from valley_tpu_torch.weights import from_jax_params, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False

ACT8 = [False, True]
IDS = ["int8", "int8a8"]


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def trees(cfg):
    """{act8: (JAX tree with the int8 tower, the port's conversion)} of
    one fp32 JAX init."""
    out = {}
    for act8 in ACT8:
        tree = jvalley.init_params(cfg, jax.random.key(21), jnp.float32)
        tree = jax.device_get(jquant.quantize_vision_params(tree, act8=act8))
        out[act8] = (tree, from_jax_params(tree, "cpu", torch.float32))
    return out


def _frames(cfg, n, seed):
    size = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act8", ACT8, ids=IDS)
def test_vision_quantizer_matches_jax_bit_for_bit(cfg, act8, dtype):
    """Every int8 value and every (L, 1, out) bf16 scale of the tower's six
    GEMMs equal JAX's, under ``_scale`` or ``_scale_a8``; the other tower
    tensors and the decoder untouched, and the input tree consumed."""
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    base = jax.device_get(jvalley.init_params(cfg, jax.random.key(22),
                                              dtype))
    want = from_jax_params(jax.device_get(jquant.quantize_vision_params(
        jax.tree.map(jnp.asarray, base), act8=act8)), "cpu", tdt)
    params = from_jax_params(base, "cpu", tdt)
    before = {n: p.clone() for n, p in params.named_parameters()}
    old_layers = params["vision"]["layers"]
    got = quant.quantize_vision_params(params, act8=act8)
    assert got is params and len(list(old_layers.parameters())) == 0
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w)
    for n in w:
        assert g[n].dtype == w[n].dtype and torch.equal(g[n], w[n]), n
    key = "_scale_a8" if act8 else "_scale"
    lay = got["vision"]["layers"]
    for name in quant.VISION_QUANT_TARGETS:
        assert lay[name].dtype == torch.int8
        assert lay[name + key].shape == (cfg.vision.num_hidden_layers, 1,
                                          lay[name].shape[-1])
    for n, t in before.items():
        if not n.startswith("vision.layers."):
            assert torch.equal(g[n], t), n
    # quantizing again leaves it as it is
    again = quant.quantize_vision_params(got, act8=act8).state_dict()
    assert all(torch.equal(again[n], g[n]) for n in g)


@pytest.mark.parametrize("rows", [5, 40])
@pytest.mark.parametrize("name", ["wq", "fc1", "fc2"])
@pytest.mark.parametrize("act8", ACT8, ids=IDS)
def test_vision_dot_matches_jax(cfg, trees, act8, name, rows):
    """`clip_vit._dot` of layer 1 against JAX's ``_dot``: weight-only int8
    (the dequantized product) and W8A8 (``torch._int_mm``), fp32
    activations of a few frames' tokens."""
    tree, params = trees[act8]
    lp = {n: jnp.asarray(v[1]) for n, v in tree["vision"]["layers"].items()}
    k = lp[name].shape[0]
    x = np.random.default_rng(rows).standard_normal((2, rows, k)).astype(
        np.float32)
    want = np.asarray(jclip._dot(lp, name, jnp.asarray(x)))
    got = clip_vit._dot(params["vision"]["layers"], 1, name,
                        torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("act8", ACT8, ids=IDS)
def test_quantized_tower_matches_jax(cfg, trees, act8):
    """The whole tower to the -2 tap on three frames, fp32."""
    tree, params = trees[act8]
    x = _frames(cfg, 3, 23)
    want = np.asarray(jclip.encode(jax.tree.map(jnp.asarray, tree["vision"]),
                                   cfg.vision, jnp.asarray(x)))
    got = clip_vit.encode(params["vision"], cfg.vision, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("act8", ACT8, ids=IDS)
def test_encode_images_with_quantized_tower_matches_jax(cfg, trees, act8):
    """`encode_images` over a ragged batch of raw uint8 frames (one video
    of 4, one of 2 padded and masked): pooled and per-frame features,
    fp32, within 1e-5 of the largest (weight-only) and 1e-2 (W8A8: one
    int8 step where an activation crossed a rounding edge, module
    docstring)."""
    tree, params = trees[act8]
    size = cfg.vision.image_size
    frames = np.random.default_rng(24).integers(
        0, 256, (2, 4, 3, size, size)).astype(np.uint8)
    mask = np.array([[True] * 4, [True, True, False, False]])
    want = jvalley.encode_images(jax.tree.map(jnp.asarray, tree), cfg,
                                 jnp.asarray(frames),
                                 frame_mask=jnp.asarray(mask))
    got = valley.encode_images(params, cfg, torch.from_numpy(frames),
                               torch.from_numpy(mask))
    bar = 1e-2 if act8 else 1e-5
    for g, w in ((got.pooled, want.pooled), (got.frame_cls, want.frame_cls)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=bar * np.abs(w).max())


@pytest.mark.parametrize("act8", ACT8, ids=IDS)
def test_quantized_tower_converts_both_ways(cfg, trees, act8):
    """The int8 tower's leaves keep int8 and their scales bf16 in the
    port; `to_numpy` gives JAX's tree back (scales as float32, which holds
    bf16 exactly)."""
    tree, params = trees[act8]
    lay = params["vision"]["layers"]
    key = "_scale_a8" if act8 else "_scale"
    assert lay["wo"].dtype == torch.int8
    assert lay["wo" + key].dtype == torch.bfloat16
    back = to_numpy(params)
    for n, v in tree["vision"]["layers"].items():
        np.testing.assert_array_equal(
            back["vision"]["layers"][n],
            np.asarray(jnp.asarray(v).astype(jnp.float32))
            if np.asarray(v).dtype != np.int8 else v, err_msg=n)


def test_hbm_counts_the_quantized_tower_as_jax_does(cfg):
    """The serving budget's weight bytes (`hbm.tree_bytes`) of a bf16 tree
    with an int8 tower and int4gpa8 decoder weights equal JAX's
    ``hbm.tree_bytes`` of the same tree (both hold packed int4, int8
    tower weights and bf16 scales)."""
    tree = jvalley.init_params(cfg, jax.random.key(25), jnp.bfloat16)
    from valley_tpu.models import llama as jllama
    tree = jquant.pack_int4_params(jquant.quantize_llama_params(
        jllama.fuse_llama_params(tree), bits=4, group_size=32, act8=True))
    tree = jquant.quantize_vision_params(tree, act8=True)
    params = from_jax_params(jax.device_get(tree), "cpu", torch.bfloat16)
    assert hbm.tree_bytes(params) == jhbm.tree_bytes(tree)
    bf16 = from_jax_params(jax.device_get(jvalley.init_params(
        cfg, jax.random.key(25), jnp.bfloat16)), "cpu", torch.bfloat16)
    assert hbm.tree_bytes(params["vision"]) < hbm.tree_bytes(bf16["vision"])
