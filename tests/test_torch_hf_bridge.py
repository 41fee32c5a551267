"""Hugging Face checkpoints in the PyTorch port (`utils/hf_bridge.py`,
`utils/safetensors_io.py`, `utils/delta.py`) against the JAX package's
``utils/hf_bridge.py`` and ``utils/delta.py`` on the CPU.

The checkpoints are written by JAX's ``export_valley_checkpoint`` from one
JAX init of the tiny model with a 120-word WordLevel tokenizer, and by the
port's exporter.  The tokenizer adds a pad and the six Valley markers: the
checkpoint of the bit-for-bit tests holds their 127 rows, and the one of
the growth test 120, which both loaders grow by the mean of the old rows
(in float32 summed in different orders, so those rows agree to rounding).  The JAX loader builds a CLIP ViT-L/14 config whatever the
checkpoint holds, so its ``VisionConfig`` is replaced by the tiny tower's
here; the port's loader reads the tower's shape from config.json's
``vision_config``, which the tests add to JAX's export (the port's
exporter writes it).  Trees must be equal
bit for bit: the port's loader against ``from_jax_params`` of the JAX
loader's tree, in every served quantization mode, fused and unfused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.models import llama as jllama
from valley_tpu.models import valley as jvalley
from valley_tpu.utils import delta as jdelta
from valley_tpu.utils import hf_bridge as jbridge
from valley_tpu_torch.models import valley as tvalley
from valley_tpu_torch.utils import delta as tdelta
from valley_tpu_torch.utils import hf_bridge as tbridge
from valley_tpu_torch.utils import safetensors_io as sio
from valley_tpu_torch.weights import from_jax_params

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")
pytest.importorskip("transformers")

torch.backends.cuda.matmul.allow_tf32 = False
VOCAB = 120        # the WordLevel tokenizer's words
FULL = VOCAB + 7   # and its pad and the six Valley markers


def _word_level_tokenizer(path, vocab_size=VOCAB):
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


@pytest.fixture(scope="module")
def tiny_vision(monkeypatch_module):
    """The tiny tower's config for both loaders (module docstring)."""
    vis = C.valley_tiny().vision

    def vision_config(select_layer=-2, **kw):
        return dataclasses.replace(vis, select_layer=select_layer, **kw)

    monkeypatch_module.setattr(jbridge.C, "VisionConfig", vision_config)
    return vis


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _export(tmp_path_factory, vocab: int):
    """A JAX-exported tiny Valley checkpoint of ``vocab`` rows with the
    WordLevel tokenizer, and the JAX init it holds."""
    cfg = C.valley_tiny()
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=vocab))
    params = jvalley.init_params(cfg, jax.random.key(7), jnp.float32)
    d = tmp_path_factory.mktemp("jax_ckpt")
    tok_dir = tmp_path_factory.mktemp("tok")
    _word_level_tokenizer(tok_dir)
    jbridge.export_valley_checkpoint(cfg, params, str(d),
                                     tokenizer_src=str(tok_dir))
    hf_cfg = json.loads((d / "config.json").read_text())
    hf_cfg["vision_config"] = {k: getattr(cfg.vision, k)
                               for k in tbridge.VISION_KEYS}
    (d / "config.json").write_text(json.dumps(hf_cfg))
    return str(d), cfg, params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tiny_vision):
    return _export(tmp_path_factory, FULL)


@pytest.fixture(scope="module")
def ckpt_grow(tmp_path_factory, tiny_vision):
    return _export(tmp_path_factory, VOCAB)


def _jax_load(path, mode=None, fused=False, group=128, dtype=jnp.bfloat16):
    """JAX's tree as the worker's ``load_engine`` builds it: quantized on
    load with ``fused`` applied before, or loaded and then fused."""
    cfg, p, tok = jbridge.load_valley_checkpoint(
        path, quantize=mode, quantize_group_size=group,
        fused=fused and mode is not None, dtype=dtype)
    if fused and mode is None:
        p = jllama.fuse_llama_params(p)
    return cfg, jax.device_get(p), tok


def _port_load(path, **kw):
    return tbridge.load_valley_checkpoint(path, device="cpu", **kw)


def _assert_same(got: tvalley.ValleyWeights, want: tvalley.ValleyWeights):
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert g[name].shape == w[name].shape, name
        assert torch.equal(g[name], w[name]), name


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", [None, "int8", "int8a8", "int4", "int4g",
                                  "int4gp"])
def test_load_matches_jax_loader_bit_for_bit(ckpt, tiny_vision, mode, fused):
    """Every leaf of the port's load equals ``from_jax_params`` of the JAX
    loader's (bf16, quantized on load where asked: int4 group 32 so the
    tiny widths group)."""
    path, _, _ = ckpt
    group = 32
    jcfg, jp, _ = _jax_load(path, mode, fused, group)
    cfg, got, tok = _port_load(path, quantize=mode,
                               quantize_group_size=group, fused=fused)
    want = from_jax_params(jp, dtype=torch.bfloat16)
    _assert_same(got, want)
    assert dataclasses.asdict(cfg.text) == dataclasses.asdict(jcfg.text)
    assert dataclasses.asdict(cfg.tokens) == dataclasses.asdict(jcfg.tokens)
    assert cfg.vision.select_layer == jcfg.vision.select_layer


def test_vocab_growth_and_select_layer(ckpt, ckpt_grow, tiny_vision,
                                      tmp_path):
    """The Valley markers grow the 120-row table to the tokenizer's 127,
    new rows the mean of the old, as in JAX; the checkpoint's
    ``mm_vision_select_layer`` overrides the argument's default."""
    path, _, params = ckpt_grow
    cfg, got, tok = _port_load(path, dtype=torch.float32)
    jcfg, jp, _ = _jax_load(path, dtype=jnp.float32)
    assert cfg.text.vocab_size == jcfg.text.vocab_size == len(tok) == FULL
    want = from_jax_params(jp)["llama"]
    for name in ("embed", "lm_head"):
        w, g = want[name], got["llama"][name]
        assert g.shape == w.shape, name
        old = (slice(None, VOCAB),) if name == "embed" else \
            (slice(None), slice(None, VOCAB))
        new = (slice(VOCAB, None),) if name == "embed" else \
            (slice(None), slice(VOCAB, None))
        assert torch.equal(g[old], w[old]), name
        torch.testing.assert_close(g[new], w[new], atol=1e-8, rtol=1e-6)
    emb = got["llama"]["embed"]
    old = torch.from_numpy(np.array(params["llama"]["embed"]))
    assert torch.equal(emb[VOCAB:], old.double().mean(0).float().expand(
        FULL - VOCAB, -1))
    assert cfg.tokens.vi_end == jcfg.tokens.vi_end == \
        tok.convert_tokens_to_ids("<vi_end>")
    path, _, _ = ckpt
    # a checkpoint trained with the -1 tap loads with it
    d = tmp_path / "tap"
    os.makedirs(d)
    for f in os.listdir(path):
        os.symlink(os.path.join(path, f), d / f)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    hf_cfg["mm_vision_select_layer"] = -1
    os.unlink(d / "config.json")
    (d / "config.json").write_text(json.dumps(hf_cfg))
    cfg1, _, _ = _port_load(str(d))
    jcfg1, _, _ = jbridge.load_valley_checkpoint(str(d))
    assert cfg1.vision.select_layer == jcfg1.vision.select_layer == -1


def test_passed_tokenizer_only_grows(ckpt, tiny_vision):
    """A tokenizer passed by the caller keeps the table where it holds
    fewer ids than the table has rows (the byte tokenizer on a 32000-row
    checkpoint), and takes its marker ids."""
    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    path, _, _ = ckpt
    tk = ByteFallbackTokenizer()      # 265 ids > 127 rows: grows
    cfg, got, tok = _port_load(path, tokenizer=tk)
    assert tok is tk and cfg.text.vocab_size == tk.vocab_size
    assert cfg.tokens == tk.special_tokens()
    assert got["llama"]["lm_head"].shape[1] == tk.vocab_size
    class Small:          # 100 ids, fewer than the table's 127 rows
        vocab_size = 100

        def special_tokens(self):
            return tk.special_tokens()

    cfg2, got2, _ = _port_load(path, tokenizer=Small(),
                               quantize="int8")
    assert cfg2.text.vocab_size == FULL
    assert got2["llama"]["embed"].shape[0] == FULL


def test_missing_transformers_names_the_package(ckpt, tiny_vision,
                                                monkeypatch):
    import builtins

    path, _, _ = ckpt
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers":
            raise ImportError("No module named 'transformers'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        _port_load(path)


def test_refusals(ckpt, tiny_vision):
    """The grouped W4A8 modes, once refused, quantize on load bit-equal to
    the JAX loader (group 32, fused; int4ga8's int8-stored tree packed by
    the conversion), and importance pooling asked of a checkpoint that
    holds no pooling layer raises KeyError in both loaders (checkpoints of
    the learned pooling: tests/test_torch_temporal.py)."""
    path, _, _ = ckpt
    for mode in ("int4ga8", "int4gpa8"):
        _, jp, _ = _jax_load(path, mode, True, 32)
        _, got, _ = _port_load(path, quantize=mode, quantize_group_size=32,
                               fused=True)
        _assert_same(got, from_jax_params(jp, dtype=torch.bfloat16))
        assert "wqkv_scale_a8" in got["llama"]["layers"]
    with pytest.raises(KeyError, match="pooling_layer"):
        jbridge.load_valley_checkpoint(path, pooling="temporal_importance")
    with pytest.raises(KeyError, match="pooling_layer"):
        _port_load(path, pooling="temporal_importance")


def test_fp32_logits_match_jax_loaded_model(ckpt, tiny_vision):
    """The loaded models' fp32 logits on a video prompt, within 1e-5."""
    path, _, _ = ckpt
    jcfg, jp, _ = _jax_load(path, dtype=jnp.float32)
    cfg, got, tok = _port_load(path, dtype=torch.float32)
    tk = cfg.tokens
    t = 2
    ids = ([1] + [tk.im_start] + [tk.im_patch] * cfg.num_patches
           + [tk.im_end, tk.vi_start] + [tk.vi_frame] * t + [tk.vi_end]
           + list(range(5, 25)))
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((1, t, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jvalley.forward(jp, jcfg, jnp.asarray([ids]),
                                      jnp.asarray(frames)))
    have = tvalley.forward(got, cfg, torch.tensor([ids]),
                           torch.from_numpy(frames))
    assert have.shape == want.shape
    np.testing.assert_allclose(have.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I8", "U8"])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    """The port's reader against the ``safetensors`` package's writer, and
    the port's writer against its reader, per dtype."""
    tdt = sio.DTYPES[dtype]
    g = torch.Generator().manual_seed(3)
    if tdt.is_floating_point:
        ts = {"a": torch.randn((3, 5), generator=g).to(tdt),
              "b.c": torch.randn((7,), generator=g).to(tdt),
              "e": torch.randn((0, 4)).to(tdt)}
    else:
        ts = {"a": torch.randint(-128 if tdt == torch.int8 else 0, 127,
                                 (3, 5), generator=g).to(tdt),
              "b.c": torch.randint(0, 100, (2, 2, 3), generator=g).to(tdt)}
    safetensors_torch.save_file(ts, str(tmp_path / "pkg.safetensors"))
    got = sio.load_file(str(tmp_path / "pkg.safetensors"))
    assert set(got) == set(ts)
    for k in ts:
        assert got[k].dtype == tdt and torch.equal(got[k], ts[k]), k
    sio.save_file(ts, str(tmp_path / "port.safetensors"))
    back = safetensors_torch.load_file(str(tmp_path / "port.safetensors"))
    for k in ts:
        assert back[k].dtype == tdt and torch.equal(back[k], ts[k]), k


def test_sharded_index_and_bin_directories(tmp_path):
    """A sharded directory (index naming its files, extra files ignored)
    and ``pytorch_model*.bin`` shards read as the JAX reader reads them."""
    g = torch.Generator().manual_seed(4)
    ts = {f"t{i}": torch.randn((64, 32), generator=g) for i in range(5)}
    d = tmp_path / "sharded"
    n = sio.save_sharded(ts, str(d), max_shard_bytes=3 * 64 * 32 * 4)
    assert n > 5 * 64 * 32 * 4
    index = json.loads((d / sio.INDEX).read_text())
    assert len(set(index["weight_map"].values())) == 2
    assert index["metadata"]["total_size"] == 5 * 64 * 32 * 4
    (d / "stray.safetensors").write_bytes(b"not read: not in the index")
    got = sio.read_state_dict(str(d))
    assert set(got) == set(ts)
    for k in ts:
        assert torch.equal(got[k], ts[k])
    b = tmp_path / "bins"
    os.makedirs(b)
    torch.save({k: ts[k] for k in ("t0", "t1")},
               b / "pytorch_model-00001-of-00002.bin")
    torch.save({k: ts[k] for k in ("t2", "t3", "t4")},
               b / "pytorch_model-00002-of-00002.bin")
    got = sio.read_state_dict(str(b))
    want = jbridge.read_state_dict(str(b))
    assert set(got) == set(want) == set(ts)
    for k in ts:
        assert torch.equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        sio.read_state_dict(str(tmp_path))


def test_port_export_reads_back_in_jax(ckpt, tiny_vision, tmp_path):
    """The port's exporter (sharded, fp32) read by the JAX loader gives the
    JAX tree the port's weights came from; the port reads it back too."""
    path, _, _ = ckpt
    jcfg, jp, _ = _jax_load(path, dtype=jnp.float32)
    cfg, got, _ = _port_load(path, dtype=torch.float32)
    out = tmp_path / "port_ckpt"
    tbridge.export_valley_checkpoint(cfg, got, str(out),
                                     tokenizer_src=path,
                                     max_shard_bytes=200_000)
    assert (out / sio.INDEX).is_file()
    jcfg2, jp2, _ = _jax_load(str(out), dtype=jnp.float32)
    assert dataclasses.asdict(jcfg2.text) == dataclasses.asdict(jcfg.text)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(jp2)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(kp))
    _, again, _ = _port_load(str(out), dtype=torch.float32)
    _assert_same(again, got)


def test_delta_matches_jax(ckpt, tmp_path):
    """`make_delta` and `apply_delta` write what JAX's write, and apply
    gives the target back."""
    path, cfg, params = ckpt
    base = tmp_path / "base"
    rng = np.random.default_rng(5)
    # the base: the target's decoder perturbed, at the plain LLaMA
    # vocabulary (a smaller embedding than the target's)
    sd = {k: np.asarray(v) for k, v in jbridge.read_state_dict(path).items()
          if "vision_tower" not in k and "mm_projector" not in k}
    sd = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.01)
          for k, v in sd.items()}
    for k in ("model.embed_tokens.weight", "lm_head.weight"):
        sd[k] = sd[k][:100]
    os.makedirs(base)
    safetensors_numpy.save_file(sd, str(base / "model.safetensors"))
    for name, mk, ap in (("jax", jdelta.make_delta, jdelta.apply_delta),
                         ("port", tdelta.make_delta, tdelta.apply_delta)):
        mk(str(base), path, str(tmp_path / f"delta_{name}"))
        ap(str(base), str(tmp_path / f"delta_{name}"),
           str(tmp_path / f"target_{name}"))
    for kind in ("delta", "target"):
        want = jbridge.read_state_dict(str(tmp_path / f"{kind}_jax"))
        got = sio.read_state_dict(str(tmp_path / f"{kind}_port"))
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    target = sio.read_state_dict(path)
    back = sio.read_state_dict(str(tmp_path / "target_port"))
    for k in target:
        np.testing.assert_allclose(back[k].numpy(), target[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    tdelta.main(["make", "--base-model-path", str(base),
                 "--target-model-path", path, "--delta-path",
                 str(tmp_path / "delta_cli")])
    cli = sio.read_state_dict(str(tmp_path / "delta_cli"))
    want = jbridge.read_state_dict(str(tmp_path / "delta_jax"))
    assert all(np.array_equal(cli[k].numpy(), np.asarray(want[k]))
               for k in want)
