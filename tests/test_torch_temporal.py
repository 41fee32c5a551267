"""The learned temporal pooling of the PyTorch port (``temporal_importance``
and ``temporal_transformer``, `models/temporal.py`) against the JAX
package's ``models/temporal.py`` on the CPU: the sinusoidal table, both
variants with and without a frame mask in fp32 and bf16, `encode_images`,
full stage 2's gradients of the pooling's parameters and their labels, and
Hugging Face checkpoints of both variants across the two packages.

Inputs are made with numpy from a seed and one JAX init feeds both packages
through ``weights.from_jax_params``.  Tolerances: fp32 outputs within 1e-5
of the largest |output| (both compute in fp32 and differ in summation order
only); bf16 inputs and weights within one bf16 rounding of the largest
|output| (2^-7: the fp32 result is rounded to bf16 once on each side, and an
fp32 difference at a rounding edge moves it one bf16 step); gradients within
1e-4 of the largest |gradient| over the pooling's parameters.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.models import temporal as jtemporal
from valley_tpu.models import valley as jvalley
from valley_tpu.utils import hf_bridge as jbridge
from valley_tpu_torch.models import temporal, valley
from valley_tpu_torch.train import trainer
from valley_tpu_torch.utils import hf_bridge as tbridge
from valley_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

METHODS = ("temporal_importance", "temporal_transformer")
T = 5          # frames; the masked cases keep the first 3


def _cfg(method):
    return C.valley_tiny(patch_pooling_method=method)


@pytest.fixture(scope="module")
def trees():
    """{method: (cfg, JAX fp32 tree, port fp32 weights)} of one JAX init."""
    out = {}
    for method in METHODS:
        cfg = _cfg(method)
        jp = jax.device_get(jvalley.init_params(cfg, jax.random.key(11),
                                                jnp.float32))
        out[method] = (cfg, jp, from_jax_params(jp, "cpu", torch.float32))
    return out


def _features(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (T, cfg.num_patches, cfg.text.hidden_size)).astype(np.float32)


def _mask(masked):
    return np.array([True, True, True, False, False]) if masked else None


@pytest.mark.parametrize("seq_len,d", [(2048, 64), (37, 10), (8, 4096)])
def test_sinusoidal_table_matches_jax(seq_len, d):
    """The sinusoidal table within 1e-6 (both evaluate sin and cos of the
    same fp32 angles)."""
    want = np.asarray(jtemporal.sinusoidal_position_matrix(seq_len, d))
    got = temporal.sinusoidal_position_matrix(seq_len, d).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("method", METHODS)
def test_pool_patches_matches_jax_fp32(trees, method, masked):
    cfg, jp, tp = trees[method]
    x, m = _features(cfg, 1), _mask(masked)
    want = np.asarray(jtemporal.pool_patches(
        jp["temporal"], cfg, jnp.asarray(x),
        None if m is None else jnp.asarray(m)))
    got = temporal.pool_patches(tp["temporal"], cfg, torch.from_numpy(x),
                                None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("method", METHODS)
def test_pool_patches_matches_jax_bf16(method, masked):
    """bf16 features and parameters (cast up inside, fp32 math, the result
    rounded to bf16)."""
    cfg = _cfg(method)
    jp = jax.device_get(jvalley.init_params(cfg, jax.random.key(12),
                                            jnp.bfloat16))
    tp = from_jax_params(jp, "cpu", torch.bfloat16)
    x, m = _features(cfg, 2), _mask(masked)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jtemporal.pool_patches(
        jp["temporal"], cfg, xb, None if m is None else jnp.asarray(m)),
        np.float32)
    got = temporal.pool_patches(
        tp["temporal"], cfg, torch.from_numpy(np.asarray(xb, np.float32))
        .bfloat16(), None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_masked_pooling_equals_the_valid_frames_alone(trees):
    """A frame mask with the padding at the end pools as the valid frames
    alone do (the reference's per-sample loop over variable T)."""
    for method in METHODS:
        cfg, _, tp = trees[method]
        x = torch.from_numpy(_features(cfg, 3))
        masked = temporal.pool_patches(tp["temporal"], cfg, x,
                                       torch.from_numpy(_mask(True)))
        alone = temporal.pool_patches(tp["temporal"], cfg, x[:3])
        torch.testing.assert_close(masked, alone, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_encode_images_matches_jax(trees, method):
    """The tower, projector and learned pooling of a ragged batch (one
    video of 4 frames, one of 2 padded to 4 and masked), fp32."""
    cfg, jp, tp = trees[method]
    rng = np.random.default_rng(4)
    size = cfg.vision.image_size
    frames = rng.standard_normal((2, 4, 3, size, size)).astype(np.float32)
    mask = np.array([[True] * 4, [True, True, False, False]])
    want = jvalley.encode_images(jp, cfg, jnp.asarray(frames),
                                 frame_mask=jnp.asarray(mask))
    got = valley.encode_images(tp, cfg, torch.from_numpy(frames),
                               torch.from_numpy(mask))
    for g, w in ((got.pooled, want.pooled), (got.frame_cls, want.frame_cls)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _batch(cfg, seed=5):
    """A two-row video batch with labels, the second row's frames masked
    past the second."""
    rng = np.random.default_rng(seed)
    tk = cfg.tokens
    span = [tk.im_start] + [tk.im_patch] * cfg.num_patches + \
        [tk.im_end, tk.vi_start] + [tk.vi_frame] * 3 + [tk.vi_end]
    ids = np.array([[1] + span + rng.integers(5, 400, 12).tolist()
                    for _ in range(2)], np.int32)
    labels = ids.copy()
    labels[:, :len(span) + 1] = -100
    size = cfg.vision.image_size
    return {"input_ids": ids, "labels": labels,
            "attention_mask": np.ones_like(ids),
            "images": rng.standard_normal((2, 3, 3, size, size)).astype(
                np.float32),
            "frame_mask": np.array([[True] * 3, [True, True, False]])}


@pytest.mark.parametrize("method", METHODS)
def test_stage2_temporal_grads_match_jax(trees, method):
    """Full stage 2 trains the pooling's parameters ('base', as JAX labels
    them; frozen under ``freeze_backbone`` or LoRA), and their gradients of
    the loss equal ``jax.grad``'s within 1e-4 of the largest |gradient|
    over the pooling's parameters (not of each tensor's: the importance
    score's bias has a gradient of 0 in exact arithmetic, since the softmax
    over the frames ignores a shift, and both sides read rounding there)."""
    cfg, jp, _ = trees[method]
    batch = _batch(cfg)
    jtree = jax.tree.map(jnp.asarray, jp)
    jgrad = jax.jit(jax.grad(lambda t: jvalley.loss_fn(
        {**jtree, "temporal": t}, cfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)))(
        jax.tree.map(jnp.asarray, jp["temporal"]))
    tp = from_jax_params(jp, "cpu", torch.float32)
    full = trainer.TrainConfig(freeze_backbone=False)
    names = [n for n, lab in trainer.label_params(tp, full).items()
             if lab != "frozen"]
    assert {n for n in names if n.startswith("temporal.")} == {
        f"temporal.{n}" for n in jp["temporal"]}
    for n, p in tp["temporal"].named_parameters():
        p.requires_grad_(True)
    loss = valley.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, remat=False)
    loss.backward()
    top = max(float(np.abs(np.asarray(g)).max()) for g in jgrad.values())
    assert top > 0
    for n, p in tp["temporal"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad[n]),
                                   rtol=0, atol=1e-4 * top, err_msg=n)
    for frozen in (trainer.TrainConfig(freeze_backbone=True),
                   trainer.TrainConfig(freeze_backbone=False, lora=True)):
        labels = trainer.label_params(tp, frozen)
        assert all(labels[f"temporal.{n}"] == "frozen"
                   for n in jp["temporal"])


def _export_jax(tmp_path, method):
    """A JAX-exported tiny checkpoint of ``method``'s pooling (the byte
    tokenizer's vocabulary, so the port loads it with that tokenizer) with
    config.json's ``vision_config`` (the port reads the tower's shape from
    it), and the JAX tree it holds."""
    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    tk = ByteFallbackTokenizer()
    cfg = _cfg(method).replace(tokens=tk.special_tokens())
    cfg = cfg.replace(text=dataclasses.replace(cfg.text,
                                               vocab_size=tk.vocab_size))
    jp = jvalley.init_params(cfg, jax.random.key(13), jnp.float32)
    d = tmp_path / f"jax_{method}"
    jbridge.export_valley_checkpoint(cfg, jp, str(d))
    hf_cfg = json.loads((d / "config.json").read_text())
    hf_cfg["vision_config"] = {k: getattr(cfg.vision, k)
                               for k in tbridge.VISION_KEYS}
    (d / "config.json").write_text(json.dumps(hf_cfg))
    return d, cfg, jax.device_get(jp), tk


@pytest.mark.parametrize("method", METHODS)
def test_learned_pooling_checkpoints_cross_packages(tmp_path, method):
    """A checkpoint JAX's exporter wrote with ``use_patch_importance_pooling``
    or ``use_delta_transformer`` loads into the port with that pooling, its
    parameters bit-equal to the tree JAX exported; the port's export of it
    carries the same flag and tensors, which JAX's ``convert_temporal``
    reads back bit for bit."""
    d, cfg, jp, tk = _export_jax(tmp_path, method)
    pcfg, got, _ = tbridge.load_valley_checkpoint(
        str(d), dtype=torch.float32, tokenizer=tk, device="cpu")
    assert pcfg.patch_pooling_method == method
    want = from_jax_params(jp, "cpu", torch.float32)["temporal"]
    for n, w in want.named_parameters():
        assert torch.equal(got["temporal"][n], w), n
    out = tmp_path / "port"
    tbridge.export_valley_checkpoint(pcfg, got, str(out))
    hf_cfg = json.loads((out / "config.json").read_text())
    assert hf_cfg["use_patch_importance_pooling"] == (
        method == "temporal_importance")
    assert hf_cfg["use_delta_transformer"] == (
        method == "temporal_transformer")
    back = jbridge.convert_temporal(
        {k: v.numpy() for k, v in tbridge.read_state_dict(str(out)).items()},
        cfg, jnp.float32)
    assert set(back) == set(jp["temporal"])
    for n, w in jp["temporal"].items():
        np.testing.assert_array_equal(np.asarray(back[n]), w, err_msg=n)
