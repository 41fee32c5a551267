"""The port's int4 serving path (modes int4, int4g, int4gp) against the JAX
package on the CPU: the quantizer and nibble packing, the grouped-int4
GEMV's plain version (K5) against the Pallas kernel it replaces, `_proj`
and `logits_from_hidden`, weight conversion, and the whole slice (fused
int4gp weights) through both engines.

Inputs are made with numpy from a seed and handed to both sides.  Pallas
kernels run in interpret mode.  The tiny model's widths (64, 128) take
group-128 scales only where 128 divides the contraction axis (``w_down``),
as in JAX, so most tests use group 32 to exercise several groups per row.
Tolerances are stated in each test.
"""

import importlib.util
from pathlib import Path

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
from valley_tpu.ops import quant as jquant
from valley_tpu_torch.inference import engine, run_valley
from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import quant
from valley_tpu_torch.ops.attention import KERNELS, PLAIN
from valley_tpu_torch.weights import from_jax_params, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False

NEW = 10
ROOT = Path(__file__).resolve().parent.parent


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


def _jax_tree(cfg, seed, dtype, fused=True, group_size=None, packed=True):
    """A JAX Valley tree as the worker makes it: fuse, quantize with bits 4
    (``group_size`` None: not quantized), then pack."""
    tree = jvalley.init_params(cfg, jax.random.key(seed), dtype)
    if fused:
        tree = jllama.fuse_llama_params(tree)
    if group_size is not None:
        tree = jquant.quantize_llama_params(tree, bits=4,
                                            group_size=group_size)
        if packed:
            tree = jquant.pack_int4_params(tree)
    return jax.device_get(tree)


@pytest.mark.parametrize("group_size,fused,dtype", [
    (32, True, jnp.float32), (32, False, jnp.bfloat16),
    (128, True, jnp.bfloat16), (128, False, jnp.float32),
    (0, True, jnp.bfloat16)])
def test_int4_quantizer_matches_jax_bit_for_bit(cfg, group_size, fused,
                                                dtype):
    """Packed bytes and bf16 scales equal JAX's quantize_llama_params(bits=4)
    + pack_int4_params on every target; group 128 falls back to per channel
    where it does not divide K (hidden 64), as in JAX; lm_head is per
    channel, stored (vocab, hidden/2) in the port, (hidden/2, vocab) in
    JAX."""
    tree = _jax_tree(cfg, 0, dtype, fused=fused)
    want = _jax_tree(cfg, 0, dtype, fused=fused, group_size=group_size)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = quant.quantize_llama_params(from_jax_params(tree, "cpu", tdtype),
                                      bits=4, group_size=group_size)
    gl, wl = got["llama"], want["llama"]
    names = ("wqkv", "wo", "w_gateup", "w_down") if fused else (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    for n in names:
        q = gl["layers"][n]
        assert q.dtype == torch.uint8 and not q.requires_grad
        np.testing.assert_array_equal(q.numpy(), wl["layers"][n])
        s = gl["layers"][n + "_scale"]
        assert s.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(s), _np(wl["layers"][n + "_scale"]))
        k = 2 * q.shape[-1]
        grouped = bool(group_size) and k % group_size == 0
        assert s.dim() == (3 if grouped else 2)
    np.testing.assert_array_equal(gl["lm_head"].numpy().T, wl["lm_head"])
    np.testing.assert_array_equal(_np(gl["lm_head_scale"]),
                                  _np(wl["lm_head_scale"]))


@pytest.mark.parametrize("shape,axis", [((6, 10), -1), ((6, 10), -2),
                                        ((3, 5, 8), -1)])
def test_pack_unpack_match_jax_nibbles(shape, axis):
    """`pack_int4` bit-equal to `_pack_nibbles`; `unpack_int4` equal to
    `_unpack_nibbles` on every byte value and the inverse of the pack."""
    rng = np.random.default_rng(1)
    w = rng.integers(-8, 8, shape).astype(np.int8)
    want = np.asarray(jquant._pack_nibbles(jnp.asarray(w), axis))
    got = quant.pack_int4(torch.from_numpy(w), axis)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quant.unpack_int4(got, axis).numpy(), w)
    p = rng.integers(0, 256, want.shape).astype(np.uint8)
    np.testing.assert_array_equal(
        quant.unpack_int4(torch.from_numpy(p), axis).numpy(),
        np.asarray(jquant._unpack_nibbles(jnp.asarray(p), axis)).astype(
            np.int8))
    with pytest.raises(ValueError, match="odd"):
        quant.pack_int4(torch.zeros((3, 5), dtype=torch.int8), -1)


def _exp_int4_group():
    spec = importlib.util.spec_from_file_location(
        "exp_int4_group", ROOT / "tools" / "exp_int4_group.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,k", [(1024, 512), (640, 1280)])
def test_int4_matvec_plain_matches_pallas_grouped(n, k):
    """The Pallas grouped GEMV (tools/exp_int4_group.py:91, interpret mode)
    takes int4 w (N, K) and (N, G) scales; the port's plain version takes
    the same values nibble-packed.  fp32 outputs agree to 1e-5 of their
    largest (the same exact products and fp32 group scales, summed in
    another order)."""
    mod = _exp_int4_group()
    rng = np.random.default_rng(2)
    g = k // 128                    # the tool fixes its group at 128
    x = jnp.asarray(rng.standard_normal((1, k)), jnp.bfloat16)
    w8 = rng.integers(-7, 8, (n, k)).astype(np.int8)
    s = jnp.asarray(rng.standard_normal((n, g)) * .01 + 1, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod._with_dims(
            mod.pallas_grouped, x, jnp.asarray(w8).astype(jnp.int4), None, s,
            n, k, g))
    tx = torch.from_numpy(_np(x)).bfloat16()
    tw = quant.pack_int4(torch.from_numpy(w8))
    ts = torch.from_numpy(_np(s)).bfloat16()
    for fn in (quant.int4_matvec_plain, quant.int4_matvec):   # CPU: plain
        got = fn(tx, tw, ts)
        assert got.dtype == torch.float32 and got.shape == (1, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert quant.int4_matvec.launches == 0
    # the dequantized matrix gives the same product
    deq = quant.int4_dequantize(tw, ts, torch.float32)
    np.testing.assert_allclose((tx.float() @ deq.t()).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def int4_trees(cfg):
    """Fused int4gp JAX trees (fp32 float leaves) at group 32 and per
    channel (mode int4, then packed), and the port's conversions."""
    out = {}
    for gs in (32, 0):
        tree = _jax_tree(cfg, 7, jnp.float32, fused=True, group_size=gs)
        out[gs] = (tree, from_jax_params(tree, "cpu", torch.float32))
    return out


@pytest.mark.parametrize("gs", [32, 0])
@pytest.mark.parametrize("name,rows", [
    ("wqkv", 1), ("w_down", 1), ("wo", 8), ("w_gateup", 8),
    ("wqkv", 128), ("w_down", 256)])
def test_int4_proj_matches_jax(cfg, int4_trees, gs, name, rows):
    """The port's ``_proj`` against JAX's on layer 1 of the int4gp tree
    (JAX: its unpacked int4 view): up to 8 rows K5's plain version against
    the block-diagonal branch (grouped) or the dequant-dot (per channel),
    128+ rows the dequantized product against the grouped einsum.  fp32
    activations; agreement to 1e-5 of the largest output."""
    tree, params = int4_trees[gs]
    view = jquant.unpack_int4_view(jax.tree.map(jnp.asarray, tree))
    lp = {n: v[1] for n, v in view["llama"]["layers"].items()}
    k = lp[name].shape[-1]
    x = np.random.default_rng(3).standard_normal((1, rows, k)).astype(
        np.float32)
    want = np.asarray(jllama._proj(lp, name, jnp.asarray(x)))
    for attention in (KERNELS, PLAIN):
        got = llama._proj(params["llama"]["layers"], 1, name,
                          torch.from_numpy(x), attention)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rows", [1, 3, 20])
def test_int4_lm_head_matches_jax(int4_trees, rows):
    """logits_from_hidden with the packed per-channel lm_head, stored
    (vocab, hidden/2) in the port: fp32 logits to 1e-5 of the largest."""
    tree, params = int4_trees[32]
    view = jquant.unpack_int4_view(jax.tree.map(jnp.asarray, tree))
    h = np.random.default_rng(4).standard_normal(
        (1, rows, params["llama"]["embed"].shape[1])).astype(np.float32)
    want = np.asarray(jllama.logits_from_hidden(view["llama"],
                                                jnp.asarray(h)))
    got = llama.logits_from_hidden(params["llama"], torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_int4_trees_convert_and_round_trip(cfg):
    """An int4g tree (int8 storage, grouped scales) is packed on conversion
    and an int4gp tree taken as it is: the same port tree, and `to_numpy`
    gives the int4gp tree back bit for bit.  A per-channel int4 tree (mode
    int4: int8 storage, values in [-7, 7]) packs too, while an int8 tree
    stays int8; a grouped tree's values outside [-7, 7] and W4A8 trees are
    refused."""
    gp = _jax_tree(cfg, 5, jnp.float32, group_size=32)
    g = _jax_tree(cfg, 5, jnp.float32, group_size=32, packed=False)
    a, b = (from_jax_params(t, "cpu", torch.bfloat16) for t in (gp, g))
    for (n, x), (m, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y), n
    lay = a["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.uint8
    assert lay["wqkv_scale"].dtype == torch.bfloat16
    assert a["llama"]["lm_head"].dtype == torch.uint8
    assert a["llama"]["embed"].dtype == torch.bfloat16
    assert not any(p.requires_grad for p in a.parameters())
    back = to_numpy(from_jax_params(gp, "cpu", torch.float32))
    for name, arr in gp["llama"]["layers"].items():
        np.testing.assert_array_equal(back["llama"]["layers"][name], _np(arr))
        assert back["llama"]["layers"][name].dtype == np.asarray(arr).dtype \
            or np.asarray(arr).dtype == jnp.bfloat16
    for name in ("lm_head", "lm_head_scale", "embed"):
        np.testing.assert_array_equal(back["llama"][name],
                                      _np(gp["llama"][name]))
    assert back["llama"]["lm_head"].dtype == np.uint8
    # per-channel int4 (mode int4): int8 storage told from int8 by range
    pc = _jax_tree(cfg, 5, jnp.float32, group_size=0, packed=False)
    pcp = _jax_tree(cfg, 5, jnp.float32, group_size=0)
    got = from_jax_params(pc, "cpu")["llama"]
    np.testing.assert_array_equal(got["layers"]["wo"].numpy(),
                                  pcp["llama"]["layers"]["wo"])
    np.testing.assert_array_equal(got["lm_head"].numpy().T,
                                  pcp["llama"]["lm_head"])
    i8 = jax.device_get(jquant.quantize_llama_params(jllama.fuse_llama_params(
        jvalley.init_params(cfg, jax.random.key(5), jnp.float32))))
    i8w = from_jax_params(i8, "cpu")["llama"]
    assert i8w["layers"]["wo"].dtype == i8w["lm_head"].dtype == torch.int8
    bad = _jax_tree(cfg, 5, jnp.float32, group_size=32, packed=False)
    bad["llama"]["layers"]["wo"] = np.array(bad["llama"]["layers"]["wo"])
    bad["llama"]["layers"]["wo"][0, 0, 0] = 9
    with pytest.raises(ValueError, match=r"\[-7, 7\]"):
        from_jax_params(bad, "cpu")
    a8 = jax.device_get(jquant.pack_int4_params(jquant.quantize_llama_params(
        jllama.fuse_llama_params(jvalley.init_params(
            cfg, jax.random.key(5), jnp.float32)), bits=4, group_size=32,
        act8=True)))
    with pytest.raises(NotImplementedError, match="W4A8"):
        from_jax_params(a8, "cpu")


@pytest.fixture(scope="module")
def engines(cfg, int4_trees):
    tree, params = int4_trees[32]
    jtree = jax.tree.map(jnp.asarray, tree)
    out = {}
    for name, jdt, tdt in (("int8", jnp.int8, torch.int8),
                           ("fp32", jnp.float32, torch.float32)):
        out[name] = (
            jengine.Engine(cfg, jtree, buckets=(64, 128), max_new_tokens=NEW,
                           cache_dtype=jdt, use_flash=False, steps_per_call=4,
                           w4_packed=True),
            engine.Engine(cfg, params, buckets=(64, 128), max_new_tokens=NEW,
                          cache_dtype=tdt, steps_per_call=4))
    return out


def _prompt_and_media(cfg, case, n_text, seed):
    rng = np.random.default_rng(seed)
    tok = cfg.tokens
    size = cfg.vision.image_size
    if case == "text":
        return rng.integers(5, 400, n_text).tolist(), None
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 4 + [tok.vi_end]
    prompt = [1] + span + rng.integers(5, 400, n_text).tolist()
    return prompt, rng.integers(0, 256, (1, 4, 3, size, size)).astype(
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


@pytest.mark.parametrize("cache", ["int8", "fp32"])
@pytest.mark.parametrize("bucket", [64, 128])
@pytest.mark.parametrize("case", ["text", "video_uint8"])
def test_int4gp_slice_tokens_identical_to_jax_engine(cfg, engines, cache,
                                                     bucket, case):
    """Fused int4gp weights at group 32, greedy, with an int8 or an fp32
    cache: the same tokens as the JAX ``Engine(w4_packed=True)``.  The
    prefill runs the dequantized product (JAX: the grouped einsum), decode
    K5's plain version (JAX: the block-diagonal GEMV).  Prefill logits: the
    same fp32 arithmetic summed in another order, within 1e-4 (readings of
    the int8 slice's test, tests/test_torch_quant.py: at most 2.7e-6)."""
    jeng, teng = engines[cache]
    n_text = 20 if bucket == 64 else 90
    prompt, media = _prompt_and_media(cfg, case, n_text, seed=bucket)
    assert teng.pick_bucket(len(prompt)) == bucket
    want = [int(t[0]) for t in jeng.generate_tokens(
        [prompt], media, jengine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    state = teng.prefill([prompt], media)
    diff = np.abs(state.logits.numpy()
                  - _jax_prefill_logits(jeng, prompt, media)).max()
    assert diff <= 1e-4, diff
    got = [int(t[0]) for t in teng.generate_tokens(
        [prompt], media, engine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    assert len(got) == NEW
    assert got == want


@pytest.mark.parametrize("case", ["text", "video_uint8"])
@pytest.mark.parametrize("group_size", [32, None])
def test_int4gp_bf16_prefill_logits_near_jax(cfg, group_size, case):
    """bf16 float leaves, as the card serves: fused int4gp weights at group
    32 (``group_size`` None: the same tree unquantized, for scale), int8
    cache, bucket 64.  The port's int4 prefill rounds each dequantized
    weight to bf16 before the product, where JAX keeps fp32 per-group
    partial sums, and both packages round activations to bf16 between
    ops.  Bar: prefill logits within 3e-2 of the largest |logit|, twice the
    largest reading.  Readings: int4gp 1.17e-2 (text), 1.02e-2 (video);
    unquantized 1.02e-2, 1.49e-2; so int4's bf16 prefill stays as near JAX
    as the bf16 model does."""
    tree = _jax_tree(cfg, 11, jnp.bfloat16, fused=True,
                     group_size=group_size)
    jeng = jengine.Engine(cfg, jax.tree.map(jnp.asarray, tree), buckets=(64,),
                          max_new_tokens=NEW, cache_dtype=jnp.int8,
                          use_flash=False, steps_per_call=4,
                          w4_packed=group_size is not None)
    teng = engine.Engine(cfg, from_jax_params(tree, "cpu", torch.bfloat16),
                         buckets=(64,), max_new_tokens=NEW,
                         cache_dtype=torch.int8, steps_per_call=4)
    prompt, media = _prompt_and_media(cfg, case, 20, seed=17)
    want = _jax_prefill_logits(jeng, prompt, media)
    got = teng.prefill([prompt], media).logits.numpy()
    diff = np.abs(got - want).max() / np.abs(want).max()
    assert diff <= 3e-2, diff


def test_run_valley_cli_int4gp_serving_on_frame_dir(tmp_path, capsys):
    """The worker's 13B options on the CPU: fused int4gp weights and an
    int8 KV cache answer a question about a frame directory; at the tiny
    widths group 128 divides only w_down's contraction axis."""
    from PIL import Image

    rng = np.random.default_rng(13)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            tmp_path / f"f{i}.png")
    run_valley.main(["--model-name", "random:tiny", "--video-file",
                     str(tmp_path), "--device", "cpu", "--max-new-tokens",
                     "4", "--temperature", "0", "--quantize", "int4gp",
                     "--fused", "--kv-cache", "int8"])
    assert capsys.readouterr().out.endswith("\n")
    eng, _ = run_valley.load_model("random:tiny", "cpu", buckets=(64,),
                                   max_new_tokens=2, quantize="int4gp",
                                   fused=True, kv_cache="int8")
    lay = eng.params["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.uint8
    assert lay["wqkv_scale"].dim() == 2          # per channel: K = 64
    assert lay["w_down_scale"].shape[-1] == 1    # one group of 128
    assert eng.params["llama"]["lm_head"].dtype == torch.uint8
    assert eng.cache_dtype == torch.int8
