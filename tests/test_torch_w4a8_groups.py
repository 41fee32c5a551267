"""Grouped W4A8 at every group size, and the per-token activation
quantization, in the PyTorch port against the JAX package on the CPU.

K8 (``ops/w4a8.py``) takes every group size that is a multiple of 32 on
the card; the JAX package serves any group that divides K.  Here, on the
CPU, where the wrapper runs its plain version: `llama._w4a8_group_dot` at
groups of 32, 64 and 256 against JAX's on the same int4 values and bf16
scales; `llama._quantize_tokens` (K8q's plain version) bit for bit against
JAX's quantization as the package serves it, under ``jax.jit`` (which
multiplies by 1/127 where JAX run op by op divides by 127); the card's
refusal of other group sizes, decided by
`w4a8.check_card_group` given the device, where a tree is quantized or
loaded; and a tiny checkpoint written by JAX's exporter, loaded as
int4gpa8 with ``quantize_group_size=64`` by both packages, whose greedy
tokens agree.  Inputs are made with numpy from a seed.  Tolerances are
stated in each test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import engine as jengine
from valley_tpu.models import llama as jllama
from valley_tpu.utils import hf_bridge as jbridge
from valley_tpu_torch.inference import engine
from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import quant, w4a8
from valley_tpu_torch.utils import hf_bridge as tbridge

NEW = 8


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


@pytest.mark.parametrize("group,t,k,f", [
    (32, 128, 256, 130), (32, 200, 512, 64), (64, 128, 256, 130),
    (64, 130, 1024, 96), (256, 200, 512, 130), (256, 128, 1024, 64)])
def test_w4a8_group_dot_matches_jax_at_every_group(plain_calls, group, t, k,
                                                   f):
    """`llama._w4a8_group_dot` (per-token quantization, then K8's plain
    version) against JAX's on the same int4 values and bf16 scales of
    ``group`` inputs, fp32 activations: within 2e-6 of the largest |y|, the
    bar of the group-128 test (tests/test_torch_w4a8.py).  Both sum each
    group exactly in int32; XLA's fp32 sum over the K/group groups may
    take another order, the only difference."""
    rng = np.random.default_rng(group + t + k)
    x = rng.standard_normal((1, t, k)).astype(np.float32)
    w8 = rng.integers(-8, 8, (f, k)).astype(np.int8)
    s = jnp.asarray(rng.random((f, k // group)) * .02 + .01, jnp.bfloat16)
    want = np.asarray(jllama._w4a8_group_dot(jnp.asarray(x),
                                             jnp.asarray(w8), s))
    got = llama._w4a8_group_dot(
        torch.from_numpy(x), quant.pack_int4(torch.from_numpy(w8)),
        torch.from_numpy(np.array(s.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert plain_calls[0] == 1 and w4a8.w4a8_group_gemm.launches == 0


def _jax_quantize_ops(x):
    """JAX's per-token quantization as ``valley_tpu/models/llama.py:232-235``
    writes it: (int8 (T, K), fp32 (T, 1))."""
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    a = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                    1e-6) / 127.0
    return jnp.round(xf / a).astype(jnp.int8), a


def _jax_quantize(x, jit: bool = True) -> tuple:
    """`_jax_quantize_ops` under ``jax.jit``, as the package serves it
    (the forward is jitted), or run op by op: numpy (xq, a)."""
    fn = jax.jit(_jax_quantize_ops) if jit else _jax_quantize_ops
    return tuple(np.asarray(v) for v in fn(jnp.asarray(x)))


def _quantize_rows(rng) -> np.ndarray:
    """Rows that reach every branch: N(0, 1) rows, rows of exact .5 ties
    (an absmax of 127 gives the scale 1.0), an all-zero row (the 1e-6
    clamp) and rows whose absmax is subnormal."""
    k = 256
    normal = rng.standard_normal((5, k)).astype(np.float32) * 3
    ties = np.zeros((2, k), np.float32)
    ties[:, 0] = 127.0
    ties[:, 1:] = np.arange(k - 1) % 254 - 126.5
    ties[1] *= -1
    zeros = np.zeros((1, k), np.float32)
    sub = np.full((2, k), 1e-40, np.float32)
    sub[1, 3] = -2e-39
    return np.concatenate([normal, ties, zeros, sub])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tokens_matches_jax_bit_for_bit(dtype):
    """`llama._quantize_tokens`, the plain version of K8q, against JAX's
    quantization under jit on the same rows (`_quantize_rows`) in fp32 and
    bf16: xq and the scales equal bit for bit (the scale the absmax times
    fl32(1/127), the division by it correctly rounded, ties to even).  The
    rows are exact in bf16 but for the N(0, 1) ones, which both packages
    round the same way from the same fp32 values."""
    rows = _quantize_rows(np.random.default_rng(0))
    x = torch.from_numpy(rows)
    jx = jnp.asarray(rows)
    if dtype == "bfloat16":
        x, jx = x.bfloat16(), jx.astype(jnp.bfloat16)
    want_q, want_a = _jax_quantize(jx)
    got_q, got_a = llama._quantize_tokens(x[None])
    assert got_q.dtype == torch.int8 and got_a.dtype == torch.float32
    assert got_a.shape == (rows.shape[0], 1)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_a.numpy().view(np.uint32),
                                  want_a.view(np.uint32))
    # the branches were reached: ties rounded to even, the clamp, zeros
    assert got_q[5, 1].item() == -126 and got_q[5, 2].item() == -126
    assert got_a[7, 0].item() == np.float32(1e-6) * np.float32(1 / 127)
    assert not got_q[7:].any() and (got_a[8:] == got_a[7]).all()
    # K8q's wrapper on a CPU tensor is this plain version
    for a, b in zip(w4a8.quantize_tokens(x[None]), (got_q, got_a)):
        assert torch.equal(a, b)


def test_quantize_tokens_matches_jax_under_jit_not_op_by_op():
    """Under ``jax.jit`` XLA compiles JAX's ``/ 127.0`` into a product with
    fl32(1/127); run op by op, JAX divides.  On 4096 rows of varied
    magnitude: every jitted scale is the product, every op-by-op one the
    quotient, and the two differ in the last bit of some rows (so the
    check can tell them apart).  The port's scales (`_quantize_tokens`, on
    the CPU as on the card, and K8q's) and its int8 values equal the
    jitted ones."""
    rng = np.random.default_rng(3)
    rows = (rng.standard_normal((4096, 64))
            * rng.uniform(1e-3, 1e3, (4096, 1))).astype(np.float32)
    jit_q, jit_a = _jax_quantize(rows)
    ops_q, ops_a = _jax_quantize(rows, jit=False)
    amax = np.maximum(np.abs(rows).max(-1, keepdims=True), np.float32(1e-6))
    product, quotient = amax * np.float32(1 / 127), amax / np.float32(127)
    np.testing.assert_array_equal(jit_a.view(np.uint32),
                                  product.view(np.uint32))
    np.testing.assert_array_equal(ops_a.view(np.uint32),
                                  quotient.view(np.uint32))
    assert (product != quotient).sum() > 10
    got_q, got_a = llama._quantize_tokens(torch.from_numpy(rows))
    np.testing.assert_array_equal(got_a.numpy().view(np.uint32),
                                  jit_a.view(np.uint32))
    np.testing.assert_array_equal(got_q.numpy(), jit_q)


def test_card_refuses_groups_k8_cannot_take():
    """On the card, a W4A8 projection grouped by a size that is not a
    multiple of 32 is refused where the tree is made: by the decision
    function given the device, and by the loader before it reads a layer
    (the quantizer's refusal on the card is a card test,
    tests/test_torch_cuda.py).  The CPU takes every group; a group that
    does not divide K gives per-channel scales (W8A8), which the card
    serves."""
    for group, k in ((16, 128), (48, 96), (96 + 8, 208)):
        with pytest.raises(ValueError, match="multiple of 32"):
            w4a8.check_card_group(group, k, "cuda")
        w4a8.check_card_group(group, k, "cpu")
    for group, k in ((32, 128), (64, 128), (128, 5120), (256, 13824),
                     (48, 5120), (16, 8)):
        w4a8.check_card_group(group, k, torch.device("cuda"))
    cfg = C.valley_tiny().text            # hidden 64, intermediate 128
    with pytest.raises(ValueError, match="group size 16"):
        # an empty state dict: the refusal comes before any layer is read
        tbridge._quantized_llama({}, cfg, torch.bfloat16, "cuda", True,
                                 "int4gpa8", 16, None)
    with pytest.raises(ValueError, match="group size 16"):
        tbridge._quantized_llama({}, cfg, torch.bfloat16, "cuda", False,
                                 "int4ga8", 16, None)


def _word_level_tokenizer(path, vocab_size=120):
    """The minimal fast tokenizer of tests/test_checkpoint_loading.py."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i in range(3, vocab_size):
        vocab[f"w{i}"] = i
    tk = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = Whitespace()
    tk.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
        "model_max_length": 512,
    }))


def test_group64_checkpoint_tokens_identical_to_jax_engine(
        tmp_path, monkeypatch, plain_calls):
    """A tiny checkpoint (hidden 64, intermediate 128) written by JAX's
    exporter, loaded int4gpa8 with ``quantize_group_size=64`` and fused by
    both loaders (JAX's tower config replaced by the tiny one, as
    tests/test_torch_hf_bridge.py does): the same packed weights and
    group scales, and greedy over 8 tokens from a video prompt in the 128
    bucket (W4A8 prefill through K8's plain version, counted; int8 KV
    cache) the same tokens as JAX's engine."""
    pytest.importorskip("transformers")
    cfg = C.valley_tiny()
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=127))
    vis = cfg.vision
    monkeypatch.setattr(jbridge.C, "VisionConfig", lambda select_layer=-2,
                        **kw: dataclasses.replace(vis,
                                                  select_layer=select_layer,
                                                  **kw))
    from valley_tpu.models import valley as jvalley

    params = jvalley.init_params(cfg, jax.random.key(11), jnp.float32)
    ckpt, tok = tmp_path / "ckpt", tmp_path / "tok"
    tok.mkdir()
    _word_level_tokenizer(tok)
    jbridge.export_valley_checkpoint(cfg, params, str(ckpt),
                                     tokenizer_src=str(tok))
    hf_cfg = json.loads((ckpt / "config.json").read_text())
    hf_cfg["vision_config"] = {k: getattr(vis, k) for k in tbridge.VISION_KEYS}
    (ckpt / "config.json").write_text(json.dumps(hf_cfg))

    jcfg, jtree, _ = jbridge.load_valley_checkpoint(
        str(ckpt), quantize="int4gpa8", quantize_group_size=64, fused=True,
        dtype=jnp.float32)
    tcfg, tparams, _ = tbridge.load_valley_checkpoint(
        str(ckpt), quantize="int4gpa8", quantize_group_size=64, fused=True,
        dtype=torch.float32, device="cpu")
    lay = tparams["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.uint8
    assert lay["wqkv_scale_a8"].shape[-1] == 64 // 64
    assert lay["w_down_scale_a8"].shape[-1] == 128 // 64
    jlay = jax.device_get(jtree)["llama"]["layers"]
    np.testing.assert_array_equal(
        lay["w_down_scale_a8"].float().numpy(),
        np.asarray(jnp.asarray(jlay["w_down_scale_a8"]).astype(jnp.float32)))

    tk = tcfg.tokens
    rng = np.random.default_rng(12)
    prompt = [1, tk.im_start] + [tk.im_patch] * tcfg.num_patches + [
        tk.im_end, tk.vi_start] + [tk.vi_frame] * 4 + [tk.vi_end] + \
        rng.integers(5, 120, 100).tolist()
    size = tcfg.vision.image_size
    frames = rng.integers(0, 256, (1, 4, 3, size, size)).astype(np.uint8)
    jeng = jengine.Engine(jcfg, jtree, buckets=(128,), max_new_tokens=NEW,
                          cache_dtype=jnp.int8, use_flash=False,
                          steps_per_call=4, w4_packed=True)
    teng = engine.Engine(tcfg, tparams, buckets=(128,), max_new_tokens=NEW,
                         cache_dtype=torch.int8, steps_per_call=4)
    want = [int(t[0]) for t in jeng.generate_tokens(
        [prompt], frames, jengine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    got = [int(t[0]) for t in teng.generate_tokens(
        [prompt], frames, engine.GenerationConfig(max_new_tokens=NEW),
        eos_ids=[-1])]
    assert len(got) == NEW and got == want
    assert plain_calls[0] == 4 * tcfg.text.num_hidden_layers
