"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device (decided
inside the fixture, at run time).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: max abs error <= 2^-6 * max|ref|, two bf16 ulps at the largest
output.  Both sides compute in fp32 from the same bf16 inputs and round the
output to bf16; the decode kernel also rounds probabilities to bf16 per
64-slot chunk rather than after the global softmax.  The backward kernel
is held to the same bar on each of dq, dk and dv, with the forward
kernel's out and lse as both sides' inputs.  Inputs are N(0, 1), so
logits have unit spread and attending a wrong slot moves the output by far
more than the tolerance (the decode test plants that fault and checks it
is caught).  The int8 GEMV (K4) and the int8-cache decode attention are
held to the same bar, each with a planted fault (a scale vector shifted
by one channel; the V scales replaced by ones) that must fail it, and so is
the grouped-int4 GEMV (K5), whose fault is its group scales shifted by one
group, and the bf16 GEMV (K6), whose fault is every row reading row 0's
activations.  The read-bandwidth probe (K7), a sum over an array, is held
to 1e-5 of its result on positive inputs; its fault drops the last block
of rows.
"""

import numpy as np
import pytest
import torch

from valley_tpu_torch import valley_tiny
from valley_tpu_torch.data.dataset import (DataCollatorForSupervisedDataset,
                                           DataLoader)
from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
from valley_tpu_torch.inference.engine import Engine, GenerationConfig
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops.attention import KERNELS, PLAIN
from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain
from valley_tpu_torch.ops.read_bw import read_sum, read_sum_plain
from valley_tpu_torch.ops.flash_attention import (FlashAttention,
                                                  flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain)
from valley_tpu_torch.ops.quant import (int4_matvec, int4_matvec_plain,
                                        int8_matvec, int8_matvec_plain,
                                        pack_int4, quantize_llama_params,
                                        quantize_tensor)
from valley_tpu_torch.train.trainer import TrainConfig, Trainer

REL_TOL = 2 ** -6

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _err_and_tol(out, ref):
    return ((out.float() - ref.float()).abs().max().item(),
            REL_TOL * ref.float().abs().max().item())


@pytest.mark.parametrize("b,s,h,d,causal,tail", [
    (1, 512, 32, 128, True, 39), (2, 300, 4, 64, True, 17),
    (1, 77, 2, 32, False, 0), (2, 130, 4, 16, True, 5)])
def test_flash_kernel_matches_plain(gen, b, s, h, d, causal, tail):
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.bool, device="cuda")
    if tail:
        mask[:, s - tail:] = False
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                         return_lse=True)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_kernel_refuses_what_it_cannot_take(gen):
    q = _randn(gen, 1, 64, 2, 128)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


@pytest.mark.parametrize("b,smax,h,hkv,d", [
    (1, 639, 32, 32, 128), (1, 96, 4, 2, 32), (2, 640, 8, 8, 128),
    (1, 3000, 4, 4, 128), (1, 100, 8, 1, 64), (1, 70, 4, 4, 16)])
def test_decode_kernel_matches_plain_with_mask_hole(gen, b, smax, h, hkv, d):
    n_layers, li = 3, 2
    q = _randn(gen, b, 1, h, d)
    k = _randn(gen, n_layers, b, smax, hkv, d)
    v = _randn(gen, n_layers, b, smax, hkv, d)
    valid = torch.zeros((b, smax), dtype=torch.bool, device="cuda")
    valid[:, :3 * smax // 8] = True                 # the prompt
    valid[:, smax // 2:smax // 2 + smax // 4] = True  # decoded tokens
    before = decode_attention_stacked.launches
    out = decode_attention_stacked(q, k, v, li, valid)
    torch.cuda.synchronize()
    assert decode_attention_stacked.launches == before + 1
    ref = decode_attention_plain(q, k, v, li, valid)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    # a kernel that attended the hole (read a length, not the mask) fails
    filled = valid.clone()
    filled[:, 3 * smax // 8:smax // 2] = True
    fault, _ = _err_and_tol(decode_attention_stacked(q, k, v, li, filled),
                            ref)
    assert fault > tol


def _bwd_inputs(gen, b, s, h, d, causal, lengths):
    q, k, v, g = (_randn(gen, b, s, h, d) for _ in range(4))
    mask = torch.arange(s, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda")[:, None]
    out, lse = flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    return q, k, v, g, mask, out, lse


@pytest.mark.parametrize("b,s,h,d,causal,lengths", [
    (2, 512, 8, 128, True, (512, 317)), (2, 300, 4, 64, True, (283, 300)),
    (1, 77, 2, 32, False, (77,)), (2, 130, 4, 16, True, (125, 130)),
    (2, 96, 2, 64, False, (70, 0))])
def test_flash_bwd_kernel_matches_plain(gen, b, s, h, d, causal, lengths):
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, b, s, h, d, causal,
                                             lengths)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    ref = flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                    causal=causal)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        assert bool(torch.isfinite(a.float()).all())
        err, tol = _err_and_tol(a, r)
        assert err <= tol
    for i, n in enumerate(lengths):
        # keys past a row's length, and every key of an empty row, get 0
        assert bool((got[1][i, n:] == 0).all())
        assert bool((got[2][i, n:] == 0).all())
        if n == 0:
            assert bool((got[0][i] == 0).all())


def test_flash_bwd_kernel_that_ignored_the_mask_fails(gen):
    """The planted fault: the kernel fed an all-true mask, against the
    masked reference, must fail the check."""
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, 2, 512, 8, 128, True,
                                             (512, 317))
    ref = flash_attention_bwd_plain(q, k, v, mask, out, lse, g, causal=True)
    bad = flash_attention_bwd(q, k, v, torch.ones_like(mask), out, lse, g,
                              causal=True)
    assert max(_err_and_tol(a, r)[0] / _err_and_tol(a, r)[1]
               for a, r in zip(bad, ref)) > 1.0


def test_flash_bwd_kernel_refuses_what_it_cannot_take(gen):
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, 1, 64, 2, 64, True, (64,))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, mask, out, lse.double(), g, causal=True)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, mask, out, lse, g.float(), causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, k, v, mask, out, lse,
                            g.transpose(1, 2).contiguous().transpose(1, 2),
                            causal=True)


def test_flash_autograd_on_the_card_matches_plain_autograd(gen):
    """`FlashAttention` (K1 forward, K2 backward) against autograd of the
    plain forward, on the same bf16 inputs."""
    q, k, v, g, mask, _, _ = _bwd_inputs(gen, 2, 256, 4, 128, True,
                                         (256, 201))
    grads = []
    for fn in (FlashAttention.apply, lambda *a: flash_attention_plain(
            *a[:4], causal=a[4])):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, mask, True), leaves, g))
    for a, r in zip(*grads):
        assert a.dtype == torch.bfloat16
        err, tol = _err_and_tol(a, r)
        assert err <= tol


class _Rows:
    def __init__(self, cfg, n=4):
        rng = np.random.default_rng(0)
        tok = cfg.tokens
        span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
            [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 2 + [tok.vi_end]
        size = cfg.vision.image_size
        self.items = []
        for i in range(n):
            ids = rng.integers(5, 400, size=int(rng.integers(20, 40)))
            ids[1:1 + len(span)] = span
            labels = ids.copy()
            labels[:len(span) + 1] = -100
            self.items.append(dict(input_ids=ids, labels=labels, image=(
                rng.standard_normal((2 if i % 2 else 1, 3, size, size))
                .astype(np.float32))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_tiny_training_step_on_the_card(gen, tmp_path):
    """One stage-1 update of the tiny model in bf16 on the card: K1 runs
    twice per layer (forward and remat recompute) and K2 once; the loss
    and gradients agree with the plain attention functions."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    tc = TrainConfig(output_dir=str(tmp_path), learning_rate=2e-3,
                     freeze_backbone=True, tune_mm_mlp_adapter=True,
                     per_device_train_batch_size=4, save_steps=0)
    loader = DataLoader(_Rows(cfg), 4, DataCollatorForSupervisedDataset(
        pad_to_multiple=16), seed=0, num_workers=1)
    trainer = Trainer(cfg, tc, params, loader)
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    trainer.attention = PLAIN
    loss_p, _, grads_p = trainer.loss_and_grads(batch)
    trainer.attention = KERNELS
    k1, k2 = flash_attention.launches, flash_attention_bwd.launches
    loss_k, _, grads_k = trainer.loss_and_grads(batch)
    layers = cfg.text.num_hidden_layers
    assert flash_attention.launches - k1 == 2 * layers
    assert flash_attention_bwd.launches - k2 == layers
    assert abs(float(loss_k) - float(loss_p)) < 1e-2
    for a, r in zip(grads_k, grads_p):
        assert bool(torch.isfinite(a.float()).all())
        assert float((a.float() - r.float()).norm()) <= \
            0.05 * float(r.float().norm())
    embed = params["llama"]["embed"].detach().clone()
    head = params["llama"]["lm_head"].detach().clone()
    assert trainer.train_step(batch)["updated"]
    assert not torch.equal(params["llama"]["embed"], embed)
    assert torch.equal(params["llama"]["lm_head"], head)


def _int8_weight(gen, f, k):
    """An (F, K) int8 weight and its (F,) bf16 scale, quantized from
    N(0, 1) / sqrt(K) bf16 values as the serving tree's are."""
    w = (torch.randn((f, k), generator=gen, device="cuda") * k ** -0.5)
    return quantize_tensor(w.bfloat16())


@pytest.mark.parametrize("b,k,f", [
    (1, 4096, 12288), (8, 4096, 4096), (1, 11008, 4096), (3, 64, 33),
    (2, 16, 1), (5, 4096, 1000)])
def test_int8_matvec_kernel_matches_plain(gen, b, k, f):
    x = _randn(gen, b, k)
    w, scale = _int8_weight(gen, f, k)
    before = int8_matvec.launches
    out = int8_matvec(x, w, scale)
    torch.cuda.synchronize()
    assert int8_matvec.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, f)
    ref = int8_matvec_plain(x, w, scale)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    if f > 1:
        # planted fault: the scales shifted by one output channel
        fault, _ = _err_and_tol(int8_matvec(x, w, scale.roll(1)), ref)
        assert fault > tol


def test_int8_matvec_kernel_refuses_what_it_cannot_take(gen):
    x = _randn(gen, 1, 4096)
    w, scale = _int8_weight(gen, 64, 4096)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matvec(x[:, :24].contiguous(), w[:, :24].contiguous(), scale)
    with pytest.raises(ValueError, match="rows"):
        int8_matvec(_randn(gen, 9, 4096), w, scale)
    with pytest.raises(TypeError):
        int8_matvec(x.float(), w, scale)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matvec(x, w.t().contiguous().t(), scale)


def test_int8_matvec_kernel_takes_a_layer_of_stacked_scales(gen):
    """Layer 1 of an (L, F) scale stack with F = 1001 starts 2002 bytes in:
    the kernel reads the scale one bf16 at a time, so it takes it."""
    x = _randn(gen, 1, 64)
    w, scale = quantize_tensor(
        (torch.randn((2, 1001, 64), generator=gen, device="cuda")
         * 0.125).bfloat16())
    assert scale[1].data_ptr() % 16
    out = int8_matvec(x, w[1], scale[1])
    err, tol = _err_and_tol(out, int8_matvec_plain(x, w[1], scale[1]))
    assert err <= tol


def _int8_cache(gen, n_layers, b, smax, hkv, d):
    """An int8 cache quantized from N(0, 1) bf16 K/V, as decode writes
    it, with its (L, B, Smax, Hkv) bf16 scales."""
    out = []
    for _ in range(2):
        x = _randn(gen, n_layers * b, smax, hkv, d)
        q, s = llama._quantize_kv(x)
        out += [q.reshape(n_layers, b, smax, hkv, d),
                s.reshape(n_layers, b, smax, hkv)]
    return out


@pytest.mark.parametrize("b,smax,h,hkv,d", [
    (1, 639, 32, 32, 128), (1, 96, 4, 2, 32), (2, 640, 8, 8, 128),
    (1, 100, 8, 2, 64), (1, 200, 16, 4, 128), (1, 70, 4, 4, 16)])
def test_decode_int8_kernel_matches_plain(gen, b, smax, h, hkv, d):
    n_layers, li = 3, 2
    q = _randn(gen, b, 1, h, d)
    k, ks, v, vs = _int8_cache(gen, n_layers, b, smax, hkv, d)
    valid = torch.zeros((b, smax), dtype=torch.bool, device="cuda")
    valid[:, :3 * smax // 8] = True                 # the prompt
    valid[:, smax // 2:smax // 2 + smax // 4] = True  # decoded tokens
    before = decode_attention_stacked.launches
    out = decode_attention_stacked(q, k, v, li, valid, ks, vs)
    torch.cuda.synchronize()
    assert decode_attention_stacked.launches == before + 1
    ref = decode_attention_plain(q, k, v, li, valid, ks, vs)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    # planted faults: V scales taken as ones; the hole attended
    fault, _ = _err_and_tol(decode_attention_stacked(
        q, k, v, li, valid, ks, torch.ones_like(vs)), ref)
    assert fault > tol
    filled = valid.clone()
    filled[:, 3 * smax // 8:smax // 2] = True
    fault, _ = _err_and_tol(decode_attention_stacked(
        q, k, v, li, filled, ks, vs), ref)
    assert fault > tol


def test_decode_kernel_refuses_mismatched_cache_and_scales(gen):
    q = _randn(gen, 1, 1, 4, 32)
    k, ks, v, vs = _int8_cache(gen, 2, 1, 64, 4, 32)
    valid = torch.ones((1, 64), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="scales"):
        decode_attention_stacked(q, k, v, 0, valid)       # int8, no scales
    kb, vb = k.bfloat16(), v.bfloat16()
    with pytest.raises(TypeError, match="scales"):
        decode_attention_stacked(q, kb, vb, 0, valid, ks, vs)
    with pytest.raises(ValueError, match="v_scale"):
        decode_attention_stacked(q, k, v, 0, valid, ks, vs[:, :, :32])


def test_tiny_int8_serving_on_the_card(gen):
    """The int8a8 fused tree with an int8 cache on the card: per request
    K1 runs once per layer (prefill), K3 once per layer and decode step,
    K4 four times per layer and decode step plus once per token for
    lm_head; the prefill logits agree with the plain versions'."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    params = quantize_llama_params(llama.fuse_llama_params(params),
                                   act8=True)
    new = 6
    engines = [Engine(cfg, params, buckets=(128,), max_new_tokens=new,
                      cache_dtype=torch.int8, steps_per_call=2,
                      attention=a) for a in (KERNELS, PLAIN)]
    prompt = np.random.default_rng(0).integers(5, 400, 90).tolist()
    gcfg = GenerationConfig(max_new_tokens=new)
    counts = (flash_attention.launches, decode_attention_stacked.launches,
              int8_matvec.launches)
    toks = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    layers = cfg.text.num_hidden_layers
    assert len(toks) == new
    assert flash_attention.launches - counts[0] == layers
    assert decode_attention_stacked.launches - counts[1] == \
        layers * (new - 1)
    assert int8_matvec.launches - counts[2] == 4 * layers * (new - 1) + new
    # the tiny model's logits are O(1); the kernels round bf16 in other
    # places than the plain versions (two ulps at the largest output)
    lk, lp = (e.prefill([prompt], None, gcfg).logits for e in engines)
    assert (lk - lp).abs().max().item() <= 0.05


def _int4_weight(gen, f, k, group):
    """An (F, K/2) packed int4 weight and its (F, K/group) bf16 scales (per
    channel (F,) for group 0), quantized from N(0, 1) / sqrt(K) bf16 values
    as the serving tree's are."""
    w = (torch.randn((f, k), generator=gen, device="cuda") * k ** -0.5)
    q, scale = quantize_tensor(w.bfloat16(), bits=4, group_size=group)
    return pack_int4(q), scale


@pytest.mark.parametrize("b,k,f,group", [
    (1, 5120, 15360, 128), (8, 11008, 4096, 128), (1, 13824, 5120, 128),
    (1, 5120, 32000, 0), (3, 64, 33, 0), (2, 128, 64, 32), (5, 96, 40, 16)])
def test_int4_matvec_kernel_matches_plain(gen, b, k, f, group):
    """Valley-13B's G 40 (K 5120) and G 108 (K 13824) and 7B's G 86 (K
    11008) at group 128, the per-channel lm_head, tiny widths, and a group
    of 16 (scales per 8-weight word)."""
    x = _randn(gen, b, k)
    w, scale = _int4_weight(gen, f, k, group)
    before = int4_matvec.launches
    out = int4_matvec(x, w, scale)
    torch.cuda.synchronize()
    assert int4_matvec.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, f)
    ref = int4_matvec_plain(x, w, scale)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    # planted fault: the scales shifted by one group (per channel: by one
    # output channel)
    shifted = scale.roll(1, dims=-1) if scale.dim() == 2 else scale.roll(1)
    fault, _ = _err_and_tol(int4_matvec(x, w, shifted.contiguous()), ref)
    assert fault > tol


def test_int4_matvec_kernel_refuses_what_it_cannot_take(gen):
    k = 256
    x = _randn(gen, 1, k)
    w, scale = _int4_weight(gen, 64, k, 128)
    with pytest.raises(TypeError):
        int4_matvec(x.float(), w, scale)
    with pytest.raises(TypeError):
        int4_matvec(x, w.view(torch.int8), scale)
    buf = _randn(gen, k + 2)
    with pytest.raises(ValueError, match="aligned"):
        int4_matvec(buf[2:].view(1, k), w, scale)
    with pytest.raises(ValueError, match="rows"):
        int4_matvec(_randn(gen, 9, k), w, scale)
    with pytest.raises(ValueError, match="multiple of 32"):
        int4_matvec(x[:, :48].contiguous(), w[:, :24].contiguous(),
                    scale[:, :1].contiguous())


def test_tiny_int4gp_serving_on_the_card(gen):
    """Fused int4 weights with group-32 scales and an int8 cache on the
    card: per request K1 runs once per layer (prefill), K3 once per layer
    and decode step, K5 four times per layer and decode step plus once per
    token for lm_head, K4 never; the prefill logits agree with the plain
    versions'."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    params = quantize_llama_params(llama.fuse_llama_params(params), bits=4,
                                   group_size=32)
    new = 6
    engines = [Engine(cfg, params, buckets=(128,), max_new_tokens=new,
                      cache_dtype=torch.int8, steps_per_call=2,
                      attention=a) for a in (KERNELS, PLAIN)]
    prompt = np.random.default_rng(0).integers(5, 400, 90).tolist()
    gcfg = GenerationConfig(max_new_tokens=new)
    counts = (flash_attention.launches, decode_attention_stacked.launches,
              int4_matvec.launches, int8_matvec.launches)
    toks = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    layers = cfg.text.num_hidden_layers
    assert len(toks) == new
    assert flash_attention.launches - counts[0] == layers
    assert decode_attention_stacked.launches - counts[1] == \
        layers * (new - 1)
    assert int4_matvec.launches - counts[2] == 4 * layers * (new - 1) + new
    assert int8_matvec.launches == counts[3]
    # the tiny model's logits are O(1); the kernels round bf16 in other
    # places than the plain versions (two ulps at the largest output)
    lk, lp = (e.prefill([prompt], None, gcfg).logits for e in engines)
    assert (lk - lp).abs().max().item() <= 0.05


@pytest.mark.parametrize("b,k,f,kf", [
    (1, 4096, 12288, False), (8, 4096, 22016, False), (8, 11008, 4096, False),
    (1, 4096, 32000, True), (8, 4096, 32000, True), (3, 64, 33, False),
    (5, 64, 33, True), (2, 128, 1001, True), (7, 4096, 1001, False)]
    + [(b, 256, 200, kf) for b in range(1, 9) for kf in (False, True)])
def test_bf16_matvec_kernel_matches_plain(gen, b, k, f, kf):
    """Valley-7B's fused projections, w_down and lm_head (K, F), rows 1 to
    8 in both layouts, odd F in both; the planted fault (every row reading
    row 0's activations) must fail; each row's result is bit-equal to the
    same row alone (the summation order does not depend on B)."""
    x = _randn(gen, b, k)
    w = (_randn(gen, k, f) if kf else _randn(gen, f, k)) * k ** -0.5
    before = bf16_matvec.launches
    out = bf16_matvec(x, w, kf)
    torch.cuda.synchronize()
    assert bf16_matvec.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, f)
    ref = bf16_matvec_plain(x, w, kf)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    for r in range(b):
        assert torch.equal(bf16_matvec(x[r:r + 1].contiguous(), w, kf)[0],
                           out[r])
    if b > 1:
        fault, _ = _err_and_tol(bf16_matvec(
            x[:1].expand(b, k).contiguous(), w, kf), ref)
        assert fault > tol


@pytest.mark.parametrize("b,k,f,kf", [
    (1, 4096, 4096, False), (8, 512, 1000, True), (3, 256, 33, True)])
def test_bf16_matvec_rounded_products_match_plain(gen, b, k, f, kf):
    """The T3 variant: each product rounded to bf16, summed in fp32."""
    x = _randn(gen, b, k)
    w = (_randn(gen, k, f) if kf else _randn(gen, f, k)) * k ** -0.5
    out = bf16_matvec(x, w, kf, round_products=True)
    ref = bf16_matvec_plain(x, w, kf, round_products=True)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    assert not torch.equal(out, bf16_matvec(x, w, kf))


def test_bf16_matvec_kernel_refuses_what_it_cannot_take(gen):
    k = 256
    x = _randn(gen, 1, k)
    w = _randn(gen, 64, k)
    with pytest.raises(ValueError, match="rows"):
        bf16_matvec(_randn(gen, 9, k), w)
    buf = _randn(gen, k + 2)
    with pytest.raises(ValueError, match="aligned"):
        bf16_matvec(buf[2:].view(1, k), w)
    with pytest.raises(ValueError, match="multiple of 8"):
        bf16_matvec(x[:, :60].contiguous(), w[:, :60].contiguous())
    with pytest.raises(TypeError):
        bf16_matvec(x.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        bf16_matvec(x, _randn(gen, k, 64).t())
    with pytest.raises(ValueError, match="no backward"):
        bf16_matvec(x.requires_grad_(), w)
    with torch.no_grad():
        bf16_matvec(x, w)


@pytest.mark.parametrize("n,d", [(4096, 2048), (1000, 3), (8, 128),
                                 (65536, 128)])
def test_read_sum_kernel_matches_plain(gen, n, d):
    """Positive inputs, so the sum is far from 0: 1e-5 of it is a few fp32
    ulps per partial.  The planted fault drops the last 8 rows."""
    x = torch.rand((n, d), generator=gen, device="cuda").bfloat16()
    seed = torch.tensor([[0.5]], device="cuda")
    before = read_sum.launches
    out = read_sum(x, seed)
    torch.cuda.synchronize()
    assert read_sum.launches == before + 1
    assert out.shape == (1, 1) and out.dtype == torch.float32
    ref = read_sum_plain(x, seed)
    tol = 1e-5 * ref.abs().item()
    assert (out - ref).abs().item() <= tol
    if n > 8:
        fault = (read_sum(x[:-8], seed) - ref).abs().item()
        assert fault > tol


def test_read_sum_kernel_refuses_what_it_cannot_take(gen):
    x = torch.rand((64, 64), generator=gen, device="cuda").bfloat16()
    seed = torch.ones((1, 1), device="cuda")
    with pytest.raises(TypeError):
        read_sum(x.float(), seed)
    with pytest.raises(ValueError, match="contiguous"):
        read_sum(x.t(), seed)
    with pytest.raises(ValueError, match="aligned"):
        read_sum(x.reshape(-1)[1:4001].view(40, 100), seed)


def test_tiny_pool_on_the_card(gen):
    """A three-row pool of the fused bf16 tiny model with an int8 cache on
    the card: K1 runs once per layer per admission prefill, K3 once per
    layer per pooled step, K6 four times per layer per pooled step plus
    once per step and once per admission for lm_head; a request that joins
    mid-flight leaves the tokens of the row already decoding as they were
    when it ran alone (every kernel's rows are independent)."""
    cfg = valley_tiny()
    params = llama.fuse_llama_params(valley.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda"))
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=16,
                 cache_dtype=torch.int8, steps_per_call=2)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(5, 400, n).tolist() for n in (90, 30))
    pool = ContinuousEngine(eng, rows=3, bucket=128, extra_slots=32,
                            steps_per_call=2)
    try:
        alone = list(_drain(pool.submit(a, max_new_tokens=12, eos_id=-1),
                            timeout=120))
        counts = (flash_attention.launches, decode_attention_stacked.launches,
                  bf16_matvec.launches)
        steps, prefills = pool.steps_run, len(pool.prefill_sizes)
        qa = pool.submit(a, max_new_tokens=12, eos_id=-1)
        got_a = [qa.get(timeout=120)]
        qb = pool.submit(b, max_new_tokens=6, eos_id=-1)
        got_b = list(_drain(qb, timeout=120))
        got_a += list(_drain(qa, timeout=120))
        torch.cuda.synchronize()
        steps = pool.steps_run - steps
        prefills = len(pool.prefill_sizes) - prefills
    finally:
        pool.close()
    layers = cfg.text.num_hidden_layers
    assert got_a == alone and len(got_b) == 6
    assert prefills == 2 and steps >= 11
    assert flash_attention.launches - counts[0] == layers * prefills
    assert decode_attention_stacked.launches - counts[1] == layers * steps
    assert bf16_matvec.launches - counts[2] == \
        (4 * layers + 1) * steps + prefills
