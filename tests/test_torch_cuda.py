"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device (decided
inside the fixture, at run time).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: max abs error <= 2^-6 * max|ref|, two bf16 ulps at the largest
output.  Both sides compute in fp32 from the same bf16 inputs and round the
output to bf16; the decode kernel also rounds probabilities to bf16 per
chunk of slots rather than after the global softmax.  The backward kernel
is held to the same bar on each of dq, dk and dv, with the forward
kernel's out and lse as both sides' inputs; both at the edges of their
tiles, each with two planted faults (a K tile one swizzled box over, a
masked key tile read and attended) that must fail it.  Inputs are N(0, 1), so
logits have unit spread and attending a wrong slot moves the output by far
more than the tolerance (the decode test plants that fault and checks it
is caught).  The int8 GEMV (K4) and the int8-cache decode attention are
held to the same bar, each with a planted fault (a scale vector shifted
by one channel; the V scales replaced by ones) that must fail it, and so is
the grouped-int4 GEMV (K5), whose fault is its group scales shifted by one
group, and the bf16 GEMV (K6), whose fault is every row reading row 0's
activations.  The grouped W4A8 product (K8) must equal its plain version
bit for bit (each group's sum exact in int32 on both sides, the fp32
steps after it in the same order, each rounded); its fault is the group
scales shifted by one group.  The read-bandwidth probe (K7), a sum over an array, is held
to 1e-5 of its result on positive inputs; its fault drops the last block
of rows.  The decode-attention lab's kernels (T4-T7, ``ops/decode_lab.py``)
are held to the same bar against their plain versions, each with a planted
fault, and T7's stage 3 against K3.
"""

import numpy as np
import pytest
import torch

from valley_tpu_torch import valley_tiny
from valley_tpu_torch.data.dataset import (DataCollatorForSupervisedDataset,
                                           DataLoader)
from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
from valley_tpu_torch.inference.engine import (ChatSession, Engine,
                                               GenerationConfig)
from valley_tpu_torch.inference.speculative import SpecConfig, SpecDecoder
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops import _build, decode_lab
from valley_tpu_torch.ops.attention import KERNELS, PLAIN
from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain
from valley_tpu_torch.ops.read_bw import read_sum, read_sum_plain
from valley_tpu_torch.ops.flash_attention import (FAULTS, FlashAttention,
                                                  flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain,
                                                  planted_fault)
from valley_tpu_torch.ops.quant import (int4_matvec, int4_matvec_plain,
                                        int8_matvec, int8_matvec_plain,
                                        pack_int4, quantize_llama_params,
                                        quantize_tensor)
from valley_tpu_torch.ops.w4a8 import (quantize_tokens, w4a8_group_gemm,
                                      w4a8_group_plain)
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


def _flash_mask(b, s, lengths, hole):
    """(B, S) bool: row i attends its first lengths[i] keys, less the keys
    in [hole[0], hole[1]) of every row."""
    mask = torch.arange(s, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda")[:, None]
    if hole is not None:
        mask[:, hole[0]:hole[1]] = False
    return mask


# (b, s, h, d, causal, per-row key lengths, masked hole): every head dim;
# S not a multiple of 64 and S < 16; rows of different lengths; a hole
# that masks a whole 64-key tile inside a row (tile skipping); a hole at
# the start, so that causal rows attend nothing; fully masked rows
FLASH_CASES = [
    (1, 512, 32, 128, True, (473,), None), (2, 300, 4, 64, True, (283, 283),
                                            None),
    (1, 77, 2, 32, False, (77,), None), (2, 130, 4, 16, True, (125, 125),
                                         None),
    (3, 100, 2, 64, True, (100, 37, 64), None),
    (1, 9, 2, 128, True, (9,), None), (2, 13, 4, 16, False, (13, 5), None),
    (2, 200, 2, 32, False, (200, 150), (64, 128)),
    (2, 320, 2, 128, True, (320, 250), (70, 200)),
    (1, 200, 2, 64, True, (200,), (0, 80)),
    (2, 96, 2, 64, False, (70, 0), None),
    (3, 130, 2, 128, True, (0, 130, 0), None)]


@pytest.mark.parametrize("b,s,h,d,causal,lengths,hole", FLASH_CASES)
def test_flash_kernel_matches_plain(gen, b, s, h, d, causal, lengths, hole):
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    mask = _flash_mask(b, s, lengths, hole)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                         return_lse=True)
    assert bool(torch.isfinite(out.float()).all())
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for i, n in enumerate(lengths):
        if n == 0:
            assert bool((out[i] == 0).all())   # a row with no key is 0


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


def _bwd_inputs(gen, b, s, h, d, causal, lengths, hole=None):
    q, k, v, g = (_randn(gen, b, s, h, d) for _ in range(4))
    mask = _flash_mask(b, s, lengths, hole)
    out, lse = flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    return q, k, v, g, mask, out, lse


@pytest.mark.parametrize("b,s,h,d,causal,lengths,hole", [
    (2, 512, 8, 128, True, (512, 317), None), (2, 300, 4, 64, True,
                                               (283, 300), None),
    (1, 77, 2, 32, False, (77,), None), (2, 130, 4, 16, True, (125, 130),
                                         None),
    (2, 96, 2, 64, False, (70, 0), None)] + FLASH_CASES[4:])
def test_flash_bwd_kernel_matches_plain(gen, b, s, h, d, causal, lengths,
                                        hole):
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, b, s, h, d, causal,
                                             lengths, hole)
    from valley_tpu_torch.ops.flash_attention import _kernel_delta

    before = flash_attention_bwd.launches, _kernel_delta.launches
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before[0] + 1
    assert _kernel_delta.launches == before[1] + 1
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
    if hole is not None:
        # so do the keys of the hole
        assert bool((got[1][:, hole[0]:hole[1]] == 0).all())
        assert bool((got[2][:, hole[0]:hole[1]] == 0).all())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_bwd_delta_kernel_matches_plain(gen, d):
    """K2's delta kernel against `attention_delta`: the products of bf16
    values are exact in fp32, so only the order of the fp32 sums differs."""
    from valley_tpu_torch.ops.flash_attention import (_kernel_delta,
                                                      attention_delta)

    out, g = _randn(gen, 2, 77, 3, d), _randn(gen, 2, 77, 3, d)
    got, ref = _kernel_delta(out, g), attention_delta(out, g)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (6, 77)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_flash_bwd_kernel_is_deterministic(gen):
    """Two passes with no atomics: two calls on the same inputs give the
    same bits."""
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, 2, 512, 8, 128, True,
                                             (512, 317))
    first = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True)
    second = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


# K1 and K2 at the edges of their tiles (K1: 128 queries a block, 64 keys
# a tile; K2: 128-row blocks, 64-row tiles; the 128-byte swizzle's
# 64-column boxes): every head dim at S just under and over 64 and 128,
# causal and not; S 2047, 2048 (causal, stage 2's length) and 2049; a whole
# key tile masked mid-sequence, causal and not; rows with no key
FLASH_EDGE_CASES = [
    (2, s, 2, d, i % 2 == 0, (s, s - 5), None)
    for d in (16, 32, 64, 128) for i, s in enumerate((63, 65, 127, 129))] + [
    (1, 2047, 4, 128, True, (2047,), None),
    (1, 2048, 4, 128, True, (2048,), None),
    (2, 2049, 2, 64, True, (2049, 2000), None),
    (2, 520, 2, 128, False, (520, 520), (128, 320)),
    (2, 520, 2, 128, True, (520, 300), (128, 320)),
    (3, 130, 2, 64, True, (0, 130, 0), None)]


@pytest.mark.parametrize("b,s,h,d,causal,lengths,hole", FLASH_EDGE_CASES)
def test_flash_kernels_at_their_tile_edges(gen, b, s, h, d, causal, lengths,
                                           hole):
    """K1 (out and lse) and K2 against their plain versions; K2's rerun
    bit-equal; rows with no key 0."""
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, b, s, h, d, causal,
                                             lengths, hole)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                         return_lse=True)
    err, tol = _err_and_tol(out, ref)
    assert bool(torch.isfinite(out.float()).all()) and err <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
    again = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                     causal=causal)
    for a, r in zip(got, want):
        err, tol = _err_and_tol(a, r)
        assert bool(torch.isfinite(a.float()).all()) and err <= tol
    for i, n in enumerate(lengths):
        if n == 0:
            assert bool((out[i] == 0).all())
            assert all(bool((x[i] == 0).all()) for x in got)
    if hole is not None:
        assert bool((got[1][:, hole[0]:hole[1]] == 0).all())
        assert bool((got[2][:, hole[0]:hole[1]] == 0).all())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_flash_kernels_with_a_planted_fault_fail(gen, fault):
    """The planted faults (``csrc/flash_common.cuh``): a K tile loaded one
    64-column box over, and a key tile the mask says to skip read and
    attended.  Both kernels must then fail the check, at D 128 with a whole
    key tile masked mid-sequence."""
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, 2, 520, 2, 128, True,
                                             (520, 520), (128, 320))
    ref = flash_attention_plain(q, k, v, mask, causal=True)
    want = flash_attention_bwd_plain(q, k, v, mask, out, lse, g, causal=True)
    with planted_fault(fault):
        bad = flash_attention(q, k, v, mask, causal=True)
        bad_grads = flash_attention_bwd(q, k, v, mask, out, lse, g,
                                        causal=True)
    torch.cuda.synchronize()
    err, tol = _err_and_tol(bad, ref)
    assert err > tol
    assert max(_err_and_tol(a, r)[0] / _err_and_tol(a, r)[1]
               for a, r in zip(bad_grads, want)) > 1.0
    # and the next call, with no fault, is right again
    err, tol = _err_and_tol(flash_attention(q, k, v, mask, causal=True), ref)
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


def _tiny_trainer(tmp_path, name, mesh=None, **kw):
    """A tiny bf16 model's `Trainer` on the card over `_Rows`, seed 0 (on
    ``mesh``, sharded over it)."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    tc = TrainConfig(output_dir=str(tmp_path / name), learning_rate=2e-3,
                     per_device_train_batch_size=4, save_steps=0, **kw)
    loader = DataLoader(_Rows(cfg), 4, DataCollatorForSupervisedDataset(
        pad_to_multiple=16), seed=0, num_workers=1)
    trainer = Trainer(cfg, tc, params, loader, total_steps=8, mesh=mesh)
    return trainer, trainer.device_batch(next(iter(loader.epoch(0))))


def test_dots_remat_matches_full_on_the_card(gen, tmp_path):
    """A stage-1 step of the tiny bf16 model through K1 and K2 with the
    ``"dots"`` policy and with full remat: K1 twice a layer under both (its
    recompute: a call into its own library, which no policy saves), K2
    once, and the loss and gradients within the stage-1 bars of each other
    (loss 1e-4, relative L2 0.05; the recompute runs the same kernels on
    the same inputs)."""
    trainer, batch = _tiny_trainer(tmp_path, "dots", freeze_backbone=True,
                                   tune_mm_mlp_adapter=True)
    layers = trainer.cfg.text.num_hidden_layers
    out = {}
    for policy in (True, "dots"):
        trainer.tc.gradient_checkpointing = policy
        k1, k2 = flash_attention.launches, flash_attention_bwd.launches
        out[policy] = trainer.loss_and_grads(batch)
        assert flash_attention.launches - k1 == 2 * layers
        assert flash_attention_bwd.launches - k2 == layers
    (lf, _, gf), (ld, _, gd) = out[True], out["dots"]
    assert abs(float(lf) - float(ld)) <= 1e-4
    for a, b in zip(gd, gf):
        assert float((a.float() - b.float()).norm()) <= \
            0.05 * float(b.float().norm())


def test_offloaded_update_matches_on_device_on_the_card(gen, tmp_path):
    """Three full-stage-2 updates of the tiny bf16 model with the AdamW
    moments in pinned host memory, streamed in chunks of 4096 elements on
    the side streams, against the same updates with the moments on the
    card: the parameters and moments bit-equal, the moments pinned host
    tensors between updates."""
    runs = {}
    for offload in (False, True):
        trainer, batch = _tiny_trainer(tmp_path, f"off{int(offload)}",
                                       offload_optimizer=offload,
                                       weight_decay=0.1)
        trainer.offload_chunk = 4096
        for _ in range(3):
            assert trainer.train_step(batch)["updated"]
        runs[offload] = trainer
    dev, off = runs[False], runs[True]
    for t in off.adam_moments():
        assert t.device.type == "cpu" and t.is_pinned()
    for a, b in zip(off.adam_moments(), dev.adam_moments()):
        assert b.is_cuda and torch.equal(a, b.cpu())
    for (n, a), (_, b) in zip(off.params.named_parameters(),
                              dev.params.named_parameters()):
        assert torch.equal(a, b), n


def test_sharded_update_at_world_1_over_nccl_is_bit_equal(gen, tmp_path):
    """Three full-stage-2 updates of the tiny bf16 model through the
    sharded path (`parallel.sharding`) at world 1 over NCCL, a process
    group of one on a file store in ``tmp_path``: K1 twice a layer and K2
    once an update inside it, and every parameter bit-equal to the same
    updates unsharded (the gather is a copy, the reduce-scatter sums one
    input, the global count is the local one)."""
    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import create_mesh

    plain, batch = _tiny_trainer(tmp_path, "plain")
    for _ in range(3):
        assert plain.train_step(batch)["updated"]
    assert distributed.initialize(f"file://{tmp_path}/store", 1, 0,
                                  device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        sharded, batch = _tiny_trainer(tmp_path, "sharded",
                                       mesh=create_mesh(1, -1, 1, "cuda"))
        layers = sharded.cfg.text.num_hidden_layers
        k1, k2 = flash_attention.launches, flash_attention_bwd.launches
        for _ in range(3):
            assert sharded.train_step(batch)["updated"]
        assert flash_attention.launches - k1 == 3 * 2 * layers
        assert flash_attention_bwd.launches - k2 == 3 * layers
        for (n, a), (_, b) in zip(sharded.params.named_parameters(),
                                  plain.params.named_parameters()):
            assert torch.equal(a, b), n
    finally:
        distributed.shutdown()


# One rank of the gloo probe: each collective the port's sharding uses (and
# two more) on CUDA tensors of the one card, its result held to the sum it
# must make; rank 0 prints {collective/dtype: "ok" or the error}
GLOO_PROBE = r"""
import json, sys
import torch
import torch.distributed as dist
from valley_tpu_torch.parallel import distributed

rank, store = int(sys.argv[1]), sys.argv[2]
distributed.initialize(f"file://{store}", 2, rank, device="cuda:0",
                       backend="gloo")
got = {}
for dtype in (torch.float32, torch.bfloat16):
    def x(r):
        return (torch.arange(8, device="cuda") + 10 * r).reshape(4, 2).to(
            dtype)
    full = x(0) + x(1)

    def gather():
        out = torch.empty((8, 2), device="cuda", dtype=dtype)
        dist.all_gather_into_tensor(out, x(rank))
        return torch.equal(out, torch.cat([x(0), x(1)]))

    def scatter():
        out = torch.empty((2, 2), device="cuda", dtype=dtype)
        dist.reduce_scatter_tensor(out, x(rank))
        return torch.equal(out, full[2 * rank:2 * rank + 2])

    def reduce():
        t = x(rank)
        dist.all_reduce(t)
        return torch.equal(t, full)

    def count():
        t = torch.full((1,), 3 + rank, device="cuda", dtype=torch.int64)
        dist.all_reduce(t)
        return int(t) == 7

    def broadcast():
        t = x(rank)
        dist.broadcast(t, 0)
        return torch.equal(t, x(0))

    for name, fn in (("all_gather_into_tensor", gather),
                     ("reduce_scatter_tensor", scatter),
                     ("all_reduce", reduce), ("all_reduce_int64", count),
                     ("broadcast", broadcast)):
        try:
            got[f"{name}/{dtype}"] = "ok" if fn() else "wrong values"
        except Exception as e:
            got[f"{name}/{dtype}"] = f"{type(e).__name__}: {e}"[:200]
distributed.shutdown()
if rank == 0:
    print(json.dumps(got))
"""


def test_gloo_takes_the_sharding_collectives_on_cuda(gen, tmp_path):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): which collectives gloo takes for CUDA tensors, recorded in
    the test's output; the port's sharding needs all_gather_into_tensor,
    reduce_scatter_tensor and all_reduce (fp32, bf16, int64)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_PROBE, str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root)})
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    print("gloo over CUDA tensors:", got)
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                 "all_reduce"):
        for dtype in ("torch.float32", "torch.bfloat16"):
            assert got[f"{name}/{dtype}"] == "ok", (name, dtype)
    assert got["all_reduce_int64/torch.float32"] == "ok"


def test_quantizers_on_the_card_equal_the_cpu(gen):
    """The int8 KV cache's quantizer: its scale, the absmax times
    fl32(1/127), equals the quotient the port wrote before (``/ 127.0``,
    which torch takes on the card as the product with the reciprocal), and
    the values and scales equal the CPU's, bit for bit, at the 7B cache's
    width in bf16 and fp32.  The weight quantizer's two forms (a decoder
    stack's reciprocal product, the loader's quotient) equal the CPU's."""
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn((4, 512, 32, 128), generator=gen, device="cuda")
             * 3).to(dtype)
        q, s = llama._quantize_kv(x)
        xf = x.float()
        old = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
        assert torch.equal(q, torch.round(xf / old[..., None]).to(torch.int8))
        assert torch.equal(s, old.bfloat16())
        qc, sc = llama._quantize_kv(x.cpu())
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    w = (torch.randn((4, 512, 1024), generator=gen, device="cuda") * 0.02)
    for bits, group in ((8, 0), (4, 128), (8, 64)):
        for args in ((w,), (w[0],)):
            got = quantize_tensor(*args, bits=bits, group_size=group)
            want = quantize_tensor(args[0].cpu(), bits=bits,
                                   group_size=group)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (bits, group, args[0].dim())


def _int8_weight(gen, f, k):
    """An (F, K) int8 weight and its (F,) bf16 scale, quantized from
    N(0, 1) / sqrt(K) bf16 values as the serving tree's are."""
    w = (torch.randn((f, k), generator=gen, device="cuda") * k ** -0.5)
    return quantize_tensor(w.bfloat16())


# Every row count of the tensor-core GEMVs' one path (one n8 tile of rows up
# to 8, two from 9)
MMA_ROWS = (1, 2, 7, 8, 9, 12, 16)


@pytest.mark.parametrize("b,k,f", [
    (1, 4096, 12288), (8, 4096, 4096), (1, 11008, 4096), (3, 64, 33),
    (2, 16, 1), (5, 4096, 1000)]
    # K not a multiple of a unit (64) nor of a block's step of 8 units, F
    # not a multiple of 16
    + [(b, k, f) for b in MMA_ROWS for k, f in ((4112, 1000), (80, 33))])
def test_int8_matvec_kernel_matches_plain(gen, b, k, f):
    """K4 at Valley-7B's widths and at edges of its tiling, every row count
    of its one path: one launch, the plain version within the bar, each
    row bit-equal to the same row alone, the shifted scales caught."""
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
    _alone_equal(int8_matvec, x, w, scale)
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
        int8_matvec(_randn(gen, 17, 4096), w, scale)
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


def _decode_inputs(gen, b, smax, h, hkv, d, quant, n_layers=3):
    """q and a bf16 cache, or an int8 cache with its (K, V) scales."""
    q = _randn(gen, b, 1, h, d)
    if quant:
        k, ks, v, vs = _int8_cache(gen, n_layers, b, smax, hkv, d)
        return q, k, v, (ks, vs)
    return (q, _randn(gen, n_layers, b, smax, hkv, d),
            _randn(gen, n_layers, b, smax, hkv, d), ())


def _decode_against_plain(q, k, v, scales, valid, li=1):
    """K3 once (one counted launch) against its plain version; returns
    (out, ref, tol)."""
    before = decode_attention_stacked.launches
    out = decode_attention_stacked(q, k, v, li, valid, *scales)
    torch.cuda.synchronize()
    assert decode_attention_stacked.launches == before + 1
    ref = decode_attention_plain(q, k, v, li, valid, *scales)
    assert bool(torch.isfinite(out.float()).all())
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    return out, ref, tol


def _skip_pattern(name, smax):
    """(B, Smax) masks for K3's chunk skipping (chunks of 64 or 128 slots:
    the patterns hold for both); Smax is a multiple of neither."""
    if name == "row_with_no_valid_slot":
        valid = torch.zeros((2, smax), dtype=torch.bool, device="cuda")
        valid[0, :smax // 3] = True
    elif name == "empty_chunks_start_middle_tail":
        valid = torch.zeros((1, smax), dtype=torch.bool, device="cuda")
        for a, e in ((140, 200), (400, 420), (500, 510)):
            valid[:, a:e] = True        # 128-slot chunks 0, 2, 4, 5 empty;
                                        # 64-slot 0, 1, 4, 5, 8-10
    elif name == "only_the_last_slot":  # a parked pool row
        valid = torch.zeros((2, smax), dtype=torch.bool, device="cuda")
        valid[:, smax - 1] = True
    elif name == "a_chunk_whose_only_valid_slot_is_its_last":
        valid = torch.zeros((1, smax), dtype=torch.bool, device="cuda")
        valid[:, :10] = True
        valid[:, 255] = True
    else:                               # ragged rows of a pool of 8
        lens = torch.tensor([smax, 1, 63, 64, 65, 129, 300, 2],
                            device="cuda")
        valid = torch.arange(smax, device="cuda")[None, :] < lens[:, None]
        valid[6, 100:200] = False       # and a hole
    return valid


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pattern", [
    "row_with_no_valid_slot", "empty_chunks_start_middle_tail",
    "only_the_last_slot", "a_chunk_whose_only_valid_slot_is_its_last",
    "ragged_rows_B8"])
def test_decode_kernel_skips_masked_chunks_exactly(gen, quant, pattern):
    """Chunks with no valid slot are skipped and partly valid ones load
    only their valid rows; a row with no valid slot gives the plain
    version's result, V's mean (times bf16 1/Smax and the V scale)."""
    smax = 128 * 5 + 13
    valid = _skip_pattern(pattern, smax)
    b = valid.shape[0]
    q, k, v, scales = _decode_inputs(gen, b, smax, 8, 4, 128, quant)
    out, ref, tol = _decode_against_plain(q, k, v, scales, valid)
    if pattern == "row_with_no_valid_slot" and not quant:
        mean = v[1, 1].float().mean(dim=0)                  # (Hkv, D)
        got = out[1, 0].float().reshape(4, 2, 128)
        assert (got - mean[:, None, :]).abs().max().item() <= tol


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 8])
def test_decode_kernel_every_rep_and_head_dim(gen, quant, d, n_rep):
    """The REP paths (1, 2, 4, 8; 3 takes 4 with a head masked) at every
    head dim, with the decode mask's hole and a ragged second row."""
    smax, hkv = 200, 2
    valid = torch.zeros((2, smax), dtype=torch.bool, device="cuda")
    valid[:, :70] = True
    valid[0, 96:150] = True
    q, k, v, scales = _decode_inputs(gen, 2, smax, hkv * n_rep, hkv, d,
                                     quant)
    _decode_against_plain(q, k, v, scales, valid)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_is_deterministic(gen, quant):
    """The chunks of each (row, kv head) are merged in chunk order: two
    calls give the same bits, at the pool's row lengths."""
    smax = 2304
    lens = torch.tensor([505] * 6 + [72, 1532], device="cuda")
    valid = torch.arange(smax, device="cuda")[None, :] < lens[:, None]
    q, k, v, scales = _decode_inputs(gen, 8, smax, 32, 32, 128, quant)
    out, _, _ = _decode_against_plain(q, k, v, scales, valid)
    again = decode_attention_stacked(q, k, v, 1, valid, *scales)
    assert torch.equal(out, again)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_that_dropped_a_lone_slot_fails(gen, quant):
    """Planted fault: a kernel that dropped a chunk holding one valid slot
    (the same as that slot masked) must fail the bar.  The lone slot's key
    follows its query head, so it carries most of the probability."""
    smax, li = 461, 1
    valid = torch.zeros((1, smax), dtype=torch.bool, device="cuda")
    valid[:, :100] = True
    valid[:, 200] = True      # the one valid slot of its chunk (64 or 128)
    q, k, v, scales = _decode_inputs(gen, 1, smax, 4, 4, 64, quant)
    if quant:
        k[li, 0, 200] = 127
        q[0, 0] = 1.0
    else:
        k[li, 0, 200] = q[0, 0] * 3
    _, ref, tol = _decode_against_plain(q, k, v, scales, valid, li)
    dropped = valid.clone()
    dropped[:, 200] = False
    fault, _ = _err_and_tol(decode_attention_stacked(q, k, v, li, dropped,
                                                     *scales), ref)
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
    (after a first one that captured the graphs) K1 runs once per layer
    (prefill), K3 once per layer and decode step, K4 four times per layer
    and decode step plus once per step and once for the prefill for
    lm_head, the steps those of the padded schedule (2, 2, then 1 padded
    to 2); the prefill logits agree with the plain versions'."""
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
    first = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    counts = (flash_attention.launches, decode_attention_stacked.launches,
              int8_matvec.launches)
    steps0 = engines[0].steps_run
    toks = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    steps = engines[0].steps_run - steps0
    layers = cfg.text.num_hidden_layers
    assert len(toks) == new and toks == first and steps == 6
    assert flash_attention.launches - counts[0] == layers
    assert decode_attention_stacked.launches - counts[1] == layers * steps
    assert int8_matvec.launches - counts[2] == (4 * layers + 1) * steps + 1
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
    (1, 5120, 32000, 0), (3, 64, 33, 0), (2, 128, 64, 32), (5, 96, 40, 16)]
    # groups of 8, 16 and 32 (a k16 step split by its four chunks' groups)
    # and per channel at a K that is not a multiple of a unit (128), group
    # 128 at 41 units (not a multiple of a block's step of 8 units); F not
    # a multiple of 16
    + [(b, k, f, group) for b in MMA_ROWS
       for k, f, group in ((160, 40, 8), (160, 40, 16), (160, 40, 32),
                           (4128, 1000, 0), (5248, 1000, 128))])
def test_int4_matvec_kernel_matches_plain(gen, b, k, f, group):
    """Valley-13B's G 40 (K 5120) and G 108 (K 13824) and 7B's G 86 (K
    11008) at group 128, the per-channel lm_head, tiny widths, groups of 8,
    16 and 32, and edges of the tiling at every row count of K5's one path:
    one launch, the plain version within the bar, each row bit-equal to the
    same row alone, the shifted group scales caught."""
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
    _alone_equal(int4_matvec, x, w, scale)
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
        int4_matvec(_randn(gen, 17, k), w, scale)
    with pytest.raises(ValueError, match="multiple of 32"):
        int4_matvec(x[:, :48].contiguous(), w[:, :24].contiguous(),
                    scale[:, :1].contiguous())


def test_tiny_int4gp_serving_on_the_card(gen):
    """Fused int4 weights with group-32 scales and an int8 cache on the
    card: per request (after a first one that captured the graphs) K1 runs
    once per layer (prefill), K3 once per layer and decode step, K5 four
    times per layer and decode step plus once per step and once for the
    prefill for lm_head, K4 never; the prefill logits agree with the plain
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
    first = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    counts = (flash_attention.launches, decode_attention_stacked.launches,
              int4_matvec.launches, int8_matvec.launches)
    steps0 = engines[0].steps_run
    toks = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], None, gcfg, eos_ids=[-1])]
    steps = engines[0].steps_run - steps0
    layers = cfg.text.num_hidden_layers
    assert len(toks) == new and toks == first and steps == 6
    assert flash_attention.launches - counts[0] == layers
    assert decode_attention_stacked.launches - counts[1] == layers * steps
    assert int4_matvec.launches - counts[2] == (4 * layers + 1) * steps + 1
    assert int8_matvec.launches == counts[3]
    # the tiny model's logits are O(1); the kernels round bf16 in other
    # places than the plain versions (two ulps at the largest output)
    lk, lp = (e.prefill([prompt], None, gcfg).logits for e in engines)
    assert (lk - lp).abs().max().item() <= 0.05


@pytest.mark.parametrize("b,k,f,kf", [
    (1, 4096, 12288, False), (8, 4096, 22016, False), (8, 11008, 4096, False),
    (1, 4096, 32000, True), (8, 4096, 32000, True), (3, 64, 33, False),
    (5, 64, 33, True), (2, 128, 1001, True), (7, 4096, 1001, False),
    (8, 4096, 1000, False), (1, 4096, 1000, False), (8, 512, 1000, True)]
    + [(b, k, 1000, kf) for b in (1, 8) for k in (72, 4104)
       for kf in (False, True)]
    + [(b, 256, 200, kf) for b in range(1, 9) for kf in (False, True)])
def test_bf16_matvec_kernel_matches_plain(gen, b, k, f, kf):
    """Valley-7B's fused projections, w_down and lm_head (K, F), rows 1 to
    8 in both layouts, odd F and F not a multiple of 16 in both, K not a
    multiple of 32 (72, 4104) at 1 and 8 rows; the planted fault (every
    row reading row 0's activations) must fail; each row's result is
    bit-equal to the same row alone (the summation order does not depend
    on B)."""
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


@pytest.mark.parametrize("k,f", [(4096, 12288), (4096, 4096),
                                 (4096, 22016), (11008, 4096)])
def test_bf16_matvec_rows_are_independent_at_fused_shapes(gen, k, f):
    """Valley-7B's fused (F, K) weights at every B from 1 to 8: each row's
    result is bit-equal to the same row alone, whatever rows join it."""
    x = _randn(gen, 8, k)
    w = _randn(gen, f, k) * k ** -0.5
    alone = [bf16_matvec(x[r:r + 1].contiguous(), w)[0] for r in range(8)]
    err, tol = _err_and_tol(torch.stack(alone), bf16_matvec_plain(x, w))
    assert err <= tol
    for b in range(1, 9):
        out = bf16_matvec(x[:b].contiguous(), w)
        for r in range(b):
            assert torch.equal(out[r], alone[r])


def _w4a8_inputs(gen, t, k, f, group=128):
    """Per-token int8 activations with their scales, and a packed int4
    weight with scales of ``group`` inputs, as `llama._w4a8_group_dot`
    gives K8."""
    xq = torch.randint(-127, 128, (t, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    a = torch.rand((t,), generator=gen, device="cuda") * 0.02 + 1e-3
    w, scale = _int4_weight(gen, f, k, group)
    return xq, a, w, scale


@pytest.mark.parametrize("t,k,f", [
    (128, 5120, 15360), (512, 5120, 5120), (128, 13824, 5120),
    (512, 5120, 27648), (200, 256, 130), (130, 1024, 8), (1000, 384, 200)])
def test_w4a8_group_gemm_kernel_matches_plain(gen, t, k, f):
    """Valley-13B's fused projections at the gate (128 rows) and bench's
    bucket (512), ragged rows and outputs (T and F not multiples of the
    128-output by 64- or 128-token tile): one launch, fp32 and bf16 out
    bit-equal to the plain version, the shifted group scales caught."""
    xq, a, w, scale = _w4a8_inputs(gen, t, k, f)
    before = w4a8_group_gemm.launches
    out = w4a8_group_gemm(xq, a, w, scale, torch.float32)
    out16 = w4a8_group_gemm(xq, a, w, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert w4a8_group_gemm.launches == before + 2
    assert out.shape == (t, f) and out.dtype == torch.float32
    ref = w4a8_group_plain(xq, a, w, scale, torch.float32)
    assert torch.equal(out, ref)
    assert torch.equal(out16, ref.bfloat16())
    _, tol = _err_and_tol(out, ref)
    if k > 128:
        fault, _ = _err_and_tol(w4a8_group_gemm(
            xq, a, w, scale.roll(1, dims=-1).contiguous()), ref)
        assert fault > tol


# (T, K, F, group): ragged rows and outputs at every group size; the last
# three fill a 132-SM card with K8's 128-token tiles, the others take its
# 64-token tiles (`_k8_tile`)
K8_GROUP_SHAPES = [
    (130, 1024, 130, 32), (200, 512, 130, 64), (513, 1024, 130, 256),
    (130, 1536, 384, 32), (200, 2048, 256, 64), (513, 2048, 130, 256),
    (256, 224, 130, 32), (128, 8192, 72, 4096), (130, 1024, 6398, 32),
    (200, 2048, 8192, 64), (513, 512, 4096, 256)]


def _k8_tile(t, f):
    """The token tile K8 takes for T rows and F outputs on this card: 64
    where its 128-token tiles leave SMs idle (`choose_bn`,
    csrc/w4a8_group_gemm.cu)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_f = -(-f // 128)
    r128 = -(-n_f * -(-t // 128) // sms)
    r64 = -(-n_f * -(-t // 64) // sms)
    return 64 if 70 * r64 < 100 * r128 else 128


@pytest.mark.parametrize("t,k,f,group", K8_GROUP_SHAPES)
def test_w4a8_group_gemm_kernel_takes_every_group_size(gen, t, k, f, group):
    """Ragged rows (T 130, 200, 513) and outputs (F 130), groups of 32,
    64 and 256 (and one of 4096; a K of 224, not a multiple of 128): fp32
    and bf16 out bit-equal to the plain version."""
    xq, a, w, scale = _w4a8_inputs(gen, t, k, f, group)
    for dtype in (torch.float32, torch.bfloat16):
        ref = w4a8_group_plain(xq, a, w, scale, dtype)
        assert torch.equal(w4a8_group_gemm(xq, a, w, scale, dtype), ref)


def test_w4a8_group_shapes_take_both_token_tiles(gen):
    """The shapes above reach both of K8's token tiles on this card."""
    assert {_k8_tile(t, f) for t, _, f, _ in K8_GROUP_SHAPES} == {64, 128}


def test_w4a8_group_gemm_kernel_refuses_what_it_cannot_take(gen):
    """Fewer than 128 rows, wrong dtypes, scales that do not group K, and
    groups that are not a multiple of 32 (16 here) raise; groups of 64,
    refused until K8 took every multiple of 32, are bit-equal."""
    xq, a, w, scale = _w4a8_inputs(gen, 128, 256, 64)
    with pytest.raises(ValueError, match="at least 128 rows"):
        w4a8_group_gemm(xq[:127].contiguous(), a[:127].contiguous(), w,
                        scale)
    with pytest.raises(TypeError):
        w4a8_group_gemm(xq, a.bfloat16(), w, scale)
    with pytest.raises(TypeError):
        w4a8_group_gemm(xq, a, w, scale, torch.float16)
    with pytest.raises(ValueError, match="not a grouped W4A8 product"):
        w4a8_group_gemm(xq, a, w, scale[:, :1].expand(64, 3).contiguous())
    _, s64 = quantize_tensor(torch.randn((64, 256), generator=gen,
                                         device="cuda").bfloat16(), bits=4,
                             group_size=64)
    assert torch.equal(w4a8_group_gemm(xq, a, w, s64),
                       w4a8_group_plain(xq, a, w, s64))
    _, s16 = quantize_tensor(torch.randn((64, 256), generator=gen,
                                         device="cuda").bfloat16(), bits=4,
                             group_size=16)
    with pytest.raises(ValueError, match="multiple of 32"):
        w4a8_group_gemm(xq, a, w, s16)


def _quantize_cases(gen):
    """Rows for K8q: bf16 and fp32 at a 13B width, exact .5 ties (a row
    whose absmax is 127 has the scale 1.0), all-zero rows (the 1e-6
    clamp) and rows whose absmax is subnormal."""
    ties = torch.zeros((4, 256), device="cuda")
    ties[:, 0] = 127.0
    ties[:, 1:] = (torch.arange(255, device="cuda") % 254 - 126.5)[None]
    ties[1] *= -1
    sub = torch.full((2, 256), 1e-40, device="cuda")
    sub[1, 3] = -2e-39
    return [torch.randn((130, 5120), generator=gen, device="cuda"),
            torch.randn((3, 1, 200, 512), generator=gen,
                        device="cuda").bfloat16(),
            ties, ties.bfloat16(), torch.zeros((2, 256), device="cuda"),
            sub]


def test_quantize_tokens_kernel_matches_plain(gen):
    """K8q bit-equal to `llama._quantize_tokens` (xq and the scales) on
    the card and on the CPU: one launch a call, (T, K) int8 and (T, 1)
    fp32 out."""
    for x in _quantize_cases(gen):
        before = quantize_tokens.launches
        xq, a = quantize_tokens(x)
        torch.cuda.synchronize()
        assert quantize_tokens.launches == before + 1
        t = x.numel() // x.shape[-1]
        assert xq.shape == (t, x.shape[-1]) and xq.dtype == torch.int8
        assert a.shape == (t, 1) and a.dtype == torch.float32
        for rq, ra in (llama._quantize_tokens(x),
                       llama._quantize_tokens(x.cpu())):
            assert torch.equal(xq.cpu(), rq.cpu())
            assert torch.equal(a.cpu(), ra.cpu())
    with pytest.raises(TypeError):
        quantize_tokens(torch.zeros((4, 256), device="cuda").half())
    with pytest.raises(ValueError, match="multiple of 8"):
        quantize_tokens(torch.zeros((4, 100), device="cuda"))


@pytest.mark.parametrize("group", [128, 64])
def test_tiny_w4a8_serving_on_the_card(gen, group):
    """int4gpa8 weights (hidden 128, so the projections group by 128 or
    64), an int8a8 tower, transformer pooling and an int8 cache on the
    card: per request (after a first one that captured the graphs) K8 and
    K8q run four times a layer (the 128-bucket prefill), K5 as int4gp's
    decode does, K4 never; the prefill logits agree with the plain
    versions'."""
    import dataclasses

    from valley_tpu_torch.ops.quant import quantize_vision_params

    cfg = valley_tiny(patch_pooling_method="temporal_transformer")
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, hidden_size=128,
                                               intermediate_size=256))
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    params = quantize_llama_params(llama.fuse_llama_params(params), bits=4,
                                   group_size=group, act8=True)
    params = quantize_vision_params(params, act8=True)
    new = 6
    engines = [Engine(cfg, params, buckets=(128,), max_new_tokens=new,
                      cache_dtype=torch.int8, steps_per_call=2,
                      attention=a) for a in (KERNELS, PLAIN)]
    rng = np.random.default_rng(0)
    tk = cfg.tokens
    prompt = [1, tk.im_start] + [tk.im_patch] * cfg.num_patches + [
        tk.im_end, tk.vi_start] + [tk.vi_frame] * 4 + [tk.vi_end] + \
        rng.integers(5, 400, 90).tolist()
    size = cfg.vision.image_size
    frames = rng.integers(0, 256, (1, 4, 3, size, size)).astype(np.uint8)
    gcfg = GenerationConfig(max_new_tokens=new)
    first = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], frames, gcfg, eos_ids=[-1])]
    counts = (w4a8_group_gemm.launches, int4_matvec.launches,
              int8_matvec.launches, quantize_tokens.launches)
    steps0 = engines[0].steps_run
    toks = [int(t[0]) for t in engines[0].generate_tokens(
        [prompt], frames, gcfg, eos_ids=[-1])]
    steps = engines[0].steps_run - steps0
    layers = cfg.text.num_hidden_layers
    assert len(toks) == new and toks == first and steps == 6
    assert w4a8_group_gemm.launches - counts[0] == 4 * layers
    assert quantize_tokens.launches - counts[3] == 4 * layers
    assert int4_matvec.launches - counts[1] == (4 * layers + 1) * steps + 1
    assert int8_matvec.launches == counts[2]
    lk, lp = (e.prefill([prompt], frames, gcfg).logits for e in engines)
    assert (lk - lp).abs().max().item() <= 0.05


def test_w4a8_group_16_is_refused_where_the_tree_is_quantized(gen):
    """A W4A8 tree whose groups K8 cannot take (16 inputs) is refused by
    the quantizer on the card, before the tree is touched; the same tree
    quantizes on the CPU (the plain version takes any group)."""
    import dataclasses

    cfg = valley_tiny()
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, hidden_size=128,
                                               intermediate_size=256))
    params = llama.fuse_llama_params(valley.init_params(
        cfg, gen, torch.bfloat16, "cuda"))
    names = sorted(n for n, _ in params.named_parameters())
    with pytest.raises(ValueError, match="multiple of 32"):
        quantize_llama_params(params, bits=4, group_size=16, act8=True)
    assert sorted(n for n, _ in params.named_parameters()) == names
    cpu = valley.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    quantize_llama_params(cpu, bits=4, group_size=16, act8=True)
    assert cpu["llama"]["layers"]["wq_scale_a8"].shape[-1] == 128 // 16


@pytest.mark.parametrize("rows", [5, 40])
def test_w8a8_tower_dot_on_the_card_matches_the_cpu(gen, rows):
    """The tower's W8A8 product of 5 rows (one tiny frame, padded to 17
    rows for torch._int_mm on the card) and of 40, fp32 activations,
    against the same product on the CPU within 1e-6 of the largest (both
    quantize by the same fp32 operations and sum exactly in int32)."""
    from valley_tpu_torch.models import clip_vit
    from valley_tpu_torch.ops.quant import quantize_vision_params

    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                torch.float32, "cuda")
    lay = quantize_vision_params(params, act8=True)["vision"]["layers"]
    cpu = clip_vit.ClipLayers({n: p.data.cpu()
                               for n, p in lay.named_parameters()})
    x = torch.randn((1, rows, cfg.vision.hidden_size), generator=gen,
                    device="cuda")
    for name in ("wq", "fc1", "fc2"):
        xi = x if name != "fc2" else torch.randn(
            (1, rows, cfg.vision.intermediate_size), generator=gen,
            device="cuda")
        got = clip_vit._dot(lay, 0, name, xi).cpu()
        want = clip_vit._dot(cpu, 0, name, xi.cpu())
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= \
            1e-6 * want.abs().max().item()


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
        bf16_matvec(_randn(gen, 17, k), w)
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


def _lab_inputs(gen, n_layers, b, s, h, d, hole=True):
    """q (B, 1, H, D) and a slot-major (L, B, S, H, D) cache of N(0, 1)
    values, its head-major copy, and a mask with a hole (valid prompt,
    invalid padding, valid decoded slots) as the -1e9 bias."""
    q = _randn(gen, b, 1, h, d)
    k = _randn(gen, n_layers, b, s, h, d)
    v = _randn(gen, n_layers, b, s, h, d)
    valid = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    valid[:, :3 * s // 8] = True
    valid[:, s // 2:s // 2 + (s // 4 if hole else s // 2)] = True
    bias = torch.where(valid, 0.0, -1e9).float()
    hm = [x.permute(0, 1, 3, 2, 4).contiguous() for x in (k, v)]
    return q, k, v, hm[0], hm[1], valid, bias


@pytest.mark.parametrize("b,s,h,d", [(1, 640, 32, 128), (2, 300, 8, 64),
                                     (1, 2052, 40, 128)])
def test_head_major_lab_kernels_match_plain(gen, b, s, h, d):
    """T4 (hc 8 and 16, the last block ragged where hc does not divide H),
    T5 and T6 (layer 1 of 3) against `attn_head_major_plain`; the planted
    fault, every masked slot attended, must fail."""
    q, _, _, k, v, _, bias = _lab_inputs(gen, 3, b, s, h, d)
    ref = decode_lab.attn_head_major_plain(q, k[1], v[1], bias)
    bad = torch.zeros_like(bias)
    runs = [(decode_lab.attn_per_head, lambda bb: decode_lab.attn_per_head(
        q, k[1], v[1], bb))]
    for hc in (8, 16):
        runs += [(decode_lab.attn_head_chunked,
                  lambda bb, hc=hc: decode_lab.attn_head_chunked(
                      q, k[1], v[1], bb, hc)),
                 (decode_lab.attn_stacked_head_major,
                  lambda bb, hc=hc: decode_lab.attn_stacked_head_major(
                      q, k, v, bb, 1, hc))]
    for wrapper, run in runs:
        before = wrapper.launches
        out = run(bias)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == ref.shape
        err, tol = _err_and_tol(out, ref)
        assert err <= tol
        assert _err_and_tol(run(bad), ref)[0] > tol


@pytest.mark.parametrize("b,s,h,d", [(1, 640, 32, 128), (2, 300, 8, 64),
                                     (1, 2052, 40, 128)])
@pytest.mark.parametrize("stage", decode_lab.STAGES)
def test_stage_lab_kernel_matches_plain(gen, b, s, h, d, stage):
    """T7 at each stage on layer 1 of 3 against `attn_stage_plain`, with its
    planted fault: the next layer read (stage 0), the D^-1/2 scale lost
    (stage 1), every masked slot attended (stages 2-4)."""
    q, k, v, _, _, _, bias = _lab_inputs(gen, 3, b, s, h, d)
    q3 = q[:, 0].contiguous()
    before = decode_lab.attn_stage.launches
    out = decode_lab.attn_stage(q3, k, v, bias, 1, stage)
    torch.cuda.synchronize()
    assert decode_lab.attn_stage.launches == before + 1
    ref = decode_lab.attn_stage_plain(q3, k, v, bias, 1, stage)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    if stage == 0:
        assert torch.equal(out, ref)
        bad = decode_lab.attn_stage(q3, k, v, bias, 2, 0)
    elif stage == 1:
        bad = decode_lab.attn_stage(q3 * d ** 0.5, k, v, bias, 1, 1)
    else:
        bad = decode_lab.attn_stage(q3, k, v, torch.zeros_like(bias), 1,
                                    stage)
    assert _err_and_tol(bad, ref)[0] > tol


def test_stage3_lab_kernel_is_k3_with_a_bias(gen):
    """T7 stage 3 computes K3's bf16 function: against K3 and its plain
    version with the matching boolean mask."""
    q, k, v, _, _, valid, bias = _lab_inputs(gen, 3, 1, 2052, 40, 128)
    got = decode_lab.attn_stage(q[:, 0].contiguous(), k, v, bias, 1, 3)
    ref = decode_attention_plain(q, k, v, 1, valid)[:, 0]
    err, tol = _err_and_tol(got, ref)
    assert err <= tol
    assert _err_and_tol(got, decode_attention_stacked(q, k, v, 1,
                                                      valid)[:, 0])[0] <= tol


def test_lab_kernels_give_the_mean_of_v_on_a_fully_masked_row(gen):
    """Row 1's every slot carries the -1e9 bias: the tools' softmax is
    uniform, so T4-T6 and T7 stage 3 return V's mean over the slots."""
    q, k, v, khm, vhm, _, bias = _lab_inputs(gen, 2, 2, 300, 8, 128)
    bias[1] = -1e9
    mean = v[1, 1].float().mean(dim=0)                     # (H, D)
    outs = [decode_lab.attn_head_chunked(q, khm[1], vhm[1], bias, 8),
            decode_lab.attn_per_head(q, khm[1], vhm[1], bias),
            decode_lab.attn_stacked_head_major(q, khm, vhm, bias, 1, 16)]
    for out in outs:
        err, tol = _err_and_tol(out[1, 0], mean)
        assert err <= tol
    staged = decode_lab.attn_stage(q[:, 0].contiguous(), k, v, bias, 1, 3)
    err, tol = _err_and_tol(staged[1], mean)
    assert err <= tol


def test_lab_kernels_refuse_what_they_cannot_take(gen):
    q, k, v, khm, vhm, _, bias = _lab_inputs(gen, 2, 1, 64, 4, 128)
    with pytest.raises(ValueError, match="slots"):
        big = _randn(gen, 1, 4, 13000, 128)
        decode_lab.attn_per_head(q, big, big, torch.zeros((1, 13000),
                                                          device="cuda"))
    with pytest.raises(ValueError, match="S >= H"):
        decode_lab.attn_stage(_randn(gen, 1, 80, 128), _randn(
            gen, 1, 1, 64, 80, 128), _randn(gen, 1, 1, 64, 80, 128),
            torch.zeros((1, 64), device="cuda"), 0, 3)
    with pytest.raises(TypeError):
        decode_lab.attn_per_head(q, khm[0], vhm[0], bias.bfloat16())
    with pytest.raises(IndexError):
        decode_lab.attn_stage(q[:, 0].contiguous(), k, v, bias, 2, 3)


def test_tiny_chat_session_on_the_card(gen):
    """Two turns of a `ChatSession` on the tiny bf16 model with a bf16
    cache on the card: K1 once per layer for the prefill, K3 once per layer
    per decode step, K6 seven times per layer per decode step plus one
    lm_head row per step, prefill and extend, and seven times per layer for
    the extend's 16-row chunk (up to 16 rows take the GEMV; the extend's
    attention is the plain one)."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=8,
                 steps_per_call=3)
    gcfg = GenerationConfig(max_new_tokens=6)
    sess = ChatSession(eng, gcfg)
    counts = (flash_attention.launches, decode_attention_stacked.launches,
              bf16_matvec.launches)
    prompt = np.random.default_rng(0).integers(5, 400, 40).tolist()
    r1 = sess.chat(prompt, eos_ids=[-1])
    r2 = sess.chat([70, 71, 72], eos_ids=[-1])
    layers = cfg.text.num_hidden_layers
    assert len(r1) == len(r2) == 6
    assert (sess.prefills, sess.extends, sess.decode_steps) == (1, 1, 10)
    assert flash_attention.launches - counts[0] == layers
    assert decode_attention_stacked.launches - counts[1] == layers * 10
    assert bf16_matvec.launches - counts[2] == \
        (7 * layers + 1) * 10 + 2 + 7 * layers


# -- decode by CUDA graph -----------------------------------------------------


def _tiny_tree(kind):
    """The tiny model's bf16 tree as served: bf16 unfused, fused int8a8, or
    fused int4gp with group-32 scales."""
    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    if kind == "int8a8":
        params = quantize_llama_params(llama.fuse_llama_params(params),
                                       act8=True)
    elif kind == "int4gp":
        params = quantize_llama_params(llama.fuse_llama_params(params),
                                       bits=4, group_size=32)
    return cfg, params


GRAPH_TREES = {"bf16": torch.bfloat16, "int8a8": torch.int8,
               "int4gp": torch.int8}
COUNTED = (flash_attention, decode_attention_stacked, bf16_matvec,
           int8_matvec, int4_matvec)


def _counted(fn):
    """(fn(), the launches of every counted wrapper during it)."""
    before = [w.launches for w in COUNTED]
    out = fn()
    torch.cuda.synchronize()
    return out, [w.launches - b for w, b in zip(COUNTED, before)]


@pytest.mark.parametrize("kind", list(GRAPH_TREES))
def test_graph_decode_matches_eager_decode(gen, kind):
    """`generate_tokens` on the card decodes by graph replay: at B = 1 and
    ragged B = 3, two different requests in a row replay the same graphs
    (no new capture) and each gives the tokens of a fresh eager run, with
    the eager run's launches and decode steps (ramp 2, then 4, the
    10-token request's last chunk of 3 padded to 4)."""
    cfg, params = _tiny_tree(kind)
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=12,
                 cache_dtype=GRAPH_TREES[kind], steps_per_call=4,
                 decode_ramp=(2,))
    gcfg = GenerationConfig(max_new_tokens=10)
    rng = np.random.default_rng(1)
    # both requests of a batch size in the 128 bucket: one cache length
    batches = {1: [[rng.integers(5, 400, 90).tolist()],
                   [rng.integers(5, 400, 110).tolist()]],
               3: [[rng.integers(5, 400, n).tolist() for n in (9, 70, 40)],
                   [rng.integers(5, 400, n).tolist() for n in (100, 3, 21)]]}

    def run(prompts, eager):
        return np.stack(list(eng.generate_tokens(prompts, None, gcfg,
                                                 eos_ids=[-1], eager=eager)))

    for b, (first, second) in batches.items():
        run(first, False)                               # captures
        keys = {k: set(g.keys()) for k, g in eng.graph_sets.items()}
        for prompts in (first, second):
            steps0 = eng.steps_run
            graph, graph_n = _counted(lambda: run(prompts, False))
            graph_steps = eng.steps_run - steps0
            eager, eager_n = _counted(lambda: run(prompts, True))
            assert graph.shape == (10, b)
            np.testing.assert_array_equal(graph, eager)
            assert graph_n == eager_n and graph_steps == 10
            assert eng.steps_run - steps0 == 2 * graph_steps
        assert {k: set(g.keys()) for k, g in eng.graph_sets.items()} == keys
    assert {k[0] for k in eng.graph_sets} == {1, 3}
    # one static state per key: a second live request on it raises
    live = eng.generate_tokens(batches[1][0], None, gcfg, eos_ids=[-1])
    next(live)
    with pytest.raises(RuntimeError, match="bound to one state"):
        next(eng.generate_tokens(batches[1][1], None, gcfg, eos_ids=[-1]))
    assert len(list(live)) == 9


def test_sampled_graph_draws_fresh_numbers_and_repeats_by_seed(gen):
    """A sampled graph replayed on the same state draws other tokens each
    replay, and the same tokens after its generator is seeded again."""
    cfg, params = _tiny_tree("bf16")
    eng = Engine(cfg, params, buckets=(64,), max_new_tokens=8,
                 steps_per_call=8)
    gcfg = GenerationConfig(max_new_tokens=8, do_sample=True,
                            temperature=3.0, seed=7)
    prompt = np.random.default_rng(2).integers(5, 400, 30).tolist()
    a = [int(t[0]) for t in eng.generate_tokens([prompt], None, gcfg,
                                                eos_ids=[-1])]
    b = [int(t[0]) for t in eng.generate_tokens([prompt], None, gcfg,
                                                eos_ids=[-1])]
    assert a == b                                   # same seed, same draw
    graphs = eng.graph_sets[(1, 64 + 8 + 8)]
    state = graphs.state
    saved = state.snapshot()
    outs = []
    for seed in (None, None, 123, 123):
        if seed is not None:
            graphs.generator.manual_seed(seed)
        state.restore(saved)
        outs.append(graphs.run(8, True).clone())
    assert not torch.equal(outs[0], outs[1])        # fresh numbers
    assert torch.equal(outs[2], outs[3])            # repeated by seed


def test_graph_pool_matches_the_eager_pool(gen):
    """The pool's graphs give every greedy request the tokens of the same
    traffic through the eager pool, with the same launches per step."""
    cfg, params = _tiny_tree("bf16")
    params = llama.fuse_llama_params(params)
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=16,
                 cache_dtype=torch.int8, steps_per_call=4)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(5, 400, n).tolist(), t)
            for n, t in ((90, 0.0), (30, 0.0), (50, 0.9), (12, 0.0))]
    results = []
    for eager in (False, True):
        pool = ContinuousEngine(eng, rows=3, bucket=128, extra_slots=32,
                                steps_per_call=4, decode_ramp=(2,),
                                eager=eager)
        try:
            assert pool.graphs_on == (not eager)
            pool.warmup()
            steps0 = pool.steps_run
            before = decode_attention_stacked.launches
            queues = [pool.submit(p, temperature=t, max_new_tokens=10,
                                  eos_id=-1) for p, t in reqs]
            toks = [list(_drain(q, timeout=120)) for q in queues]
            torch.cuda.synchronize()
            steps = pool.steps_run - steps0
            assert decode_attention_stacked.launches - before == \
                cfg.text.num_hidden_layers * steps
            if not eager:
                assert set(pool._graphs.keys()) == {(2, True), (4, True)}
        finally:
            pool.close()
        results.append(toks)
    for (_, t), g, e in zip(reqs, *results):
        assert len(g) == len(e) == 10
        if t == 0.0:
            assert g == e


def test_a_synchronising_step_makes_capture_raise(gen):
    """A decode wrapper that synchronises with the host inside the step
    cannot be captured: `generate_tokens` raises and does not decode
    eagerly instead."""
    cfg, params = _tiny_tree("bf16")

    def syncing_decode(*a, **k):
        torch.cuda.synchronize()
        return decode_attention_stacked(*a, **k)

    eng = Engine(cfg, params, buckets=(64,), max_new_tokens=4,
                 steps_per_call=2,
                 attention=KERNELS._replace(decode=syncing_decode))
    prompt = np.random.default_rng(4).integers(5, 400, 20).tolist()
    with pytest.raises(RuntimeError):
        list(eng.generate_tokens([prompt], None,
                                 GenerationConfig(max_new_tokens=4),
                                 eos_ids=[-1]))
    assert not any(g.keys() for g in eng.graph_sets.values())
    # the same engine decodes eagerly when asked by name
    toks = list(eng.generate_tokens([prompt], None,
                                    GenerationConfig(max_new_tokens=4),
                                    eos_ids=[-1], eager=True))
    assert len(toks) == 4


# -- speculative verify rounds ------------------------------------------------

VERIFY_ROWS = (9, 12, 16)


def _alone_equal(fn, x, *args):
    """Each row of fn(x, ...) is bit-equal to the same row alone."""
    out = fn(x, *args)
    for r in range(x.shape[0]):
        assert torch.equal(fn(x[r:r + 1].contiguous(), *args)[0], out[r])
    return out


@pytest.mark.parametrize("b", VERIFY_ROWS)
@pytest.mark.parametrize("k,f,kf", [
    (4096, 12288, False), (11008, 4096, False), (4096, 32000, True),
    (4096, 1000, False), (72, 1000, True), (64, 33, True)])
def test_bf16_matvec_verify_rows_match_plain(gen, b, k, f, kf):
    """K6 at a verify round's 9 rows, 12 and 16 (two n8 tiles; an F not a
    multiple of 8 in (K, F) takes two CUDA-core launches): the plain
    version's result within the bar, each row bit-equal to the same row
    alone, and the planted fault (every row reading row 0's activations)
    caught."""
    x = _randn(gen, b, k)
    w = (_randn(gen, k, f) if kf else _randn(gen, f, k)) * k ** -0.5
    before = bf16_matvec.launches
    out = bf16_matvec(x, w, kf)
    torch.cuda.synchronize()
    assert bf16_matvec.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, f)
    err, tol = _err_and_tol(out, bf16_matvec_plain(x, w, kf))
    assert err <= tol
    _alone_equal(lambda xx, ww: bf16_matvec(xx, ww, kf), x, w)
    fault, _ = _err_and_tol(bf16_matvec(x[:1].expand(b, k).contiguous(), w,
                                        kf), bf16_matvec_plain(x, w, kf))
    assert fault > tol


@pytest.mark.parametrize("b", VERIFY_ROWS)
@pytest.mark.parametrize("k,f", [(4096, 12288), (11008, 4096),
                                 (4096, 32000), (64, 33), (4096, 22016),
                                 (4112, 1000), (11008, 1001)])
def test_int8_matvec_verify_rows_match_plain(gen, b, k, f):
    """K4 at a verify round's 9 rows, 12 and 16 (its second n8 tile), at
    the fused 7B widths and at K and F off its tiling: one launch, the
    plain version within the bar, each row bit-equal to the same row alone,
    the shifted scales caught."""
    x = _randn(gen, b, k)
    w, scale = _int8_weight(gen, f, k)
    ref = int8_matvec_plain(x, w, scale)
    before = int8_matvec.launches
    int8_matvec(x, w, scale)
    assert int8_matvec.launches == before + 1
    err, tol = _err_and_tol(_alone_equal(int8_matvec, x, w, scale), ref)
    assert err <= tol
    fault, _ = _err_and_tol(int8_matvec(x, w, scale.roll(1)), ref)
    assert fault > tol


@pytest.mark.parametrize("b", VERIFY_ROWS)
@pytest.mark.parametrize("k,f,group", [
    (5120, 15360, 128), (13824, 5120, 128), (5120, 32000, 0),
    (11008, 4096, 128), (96, 40, 16), (5120, 27648, 128),
    (11008, 1001, 128), (160, 40, 8), (4128, 1000, 32), (4128, 1000, 0)])
def test_int4_matvec_verify_rows_match_plain(gen, b, k, f, group):
    """K5 at a verify round's 9 rows, 12 and 16 (its second n8 tile), at
    Valley-13B's and 7B's widths, per channel and with groups of 8, 16, 32
    and 128, at K and F off its tiling: one launch, the plain version
    within the bar, each row bit-equal to the same row alone, the shifted
    group scales caught."""
    x = _randn(gen, b, k)
    w, scale = _int4_weight(gen, f, k, group)
    ref = int4_matvec_plain(x, w, scale)
    before = int4_matvec.launches
    int4_matvec(x, w, scale)
    assert int4_matvec.launches == before + 1
    err, tol = _err_and_tol(_alone_equal(int4_matvec, x, w, scale), ref)
    assert err <= tol
    shifted = scale.roll(1, dims=-1) if scale.dim() == 2 else scale.roll(1)
    fault, _ = _err_and_tol(int4_matvec(x, w, shifted.contiguous()), ref)
    assert fault > tol


@pytest.mark.parametrize("which", ["int8", "int4"])
@pytest.mark.parametrize("b", [1, 9, 16])
def test_quantized_matvec_graph_replay_is_its_eager_call(gen, which, b):
    """K4 and K5 captured in a CUDA graph as `DecodeGraphs.capture` captures
    a step (an eager call on a side stream first, the launches recorded,
    not counted): each replay equals the eager call bit for bit and counts
    one launch."""
    k, f = 4096, 1000
    x = _randn(gen, b, k)
    if which == "int8":
        fn, args = int8_matvec, _int8_weight(gen, f, k)
    else:
        fn, args = int4_matvec, _int4_weight(gen, f, k, 128)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.recording_launches() as rec:
        with torch.cuda.graph(graph):
            out = fn(x, *args)
    assert rec == {fn: 1}
    want = fn(x, *args)
    x.copy_(_randn(gen, b, k))
    want2 = fn(x, *args)
    before = fn.launches
    graph.replay()
    _build.add_launches(rec)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(out, want2) and not torch.equal(out, want)


@pytest.mark.parametrize("kind", list(GRAPH_TREES))
def test_speculative_graph_rounds_match_eager_rounds(gen, kind):
    """`SpecDecoder` on the card replays one graph per (R, do_sample): two
    requests in a row give the tokens and launches of the same rounds run
    eagerly, greedy with every round kept (threshold 0) and with the
    adaptive fallback to the engine's decode graph (threshold 10); a
    sampled request repeats under its seed."""
    cfg, params = _tiny_tree(kind)
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=24,
                 cache_dtype=GRAPH_TREES[kind], steps_per_call=4)
    rng = np.random.default_rng(5)
    prompts = [[1] + [7, 8, 9, 7, 8, 9, 7, 8] * 10,
               rng.integers(5, 400, 100).tolist()]
    for threshold in (0.0, 10.0):
        dec = SpecDecoder(eng, SpecConfig(draft_len=4, rounds_per_call=3,
                                          probe_rounds=2,
                                          disable_below=threshold))

        def run(prompt, eager, **kw):
            return list(dec.generate_tokens(
                prompt, None, GenerationConfig(max_new_tokens=24, **kw),
                eos_ids=[-1], eager=eager))

        run(prompts[0], False)                      # captures
        for prompt in prompts:
            graph, graph_n = _counted(lambda: run(prompt, False))
            eager, eager_n = _counted(lambda: run(prompt, True))
            assert len(graph) == 24 and graph == eager
            assert graph_n == eager_n
        sampled = [run(prompts[1], False, do_sample=True, temperature=0.9,
                       seed=s) for s in (3, 3, 4)]
        assert sampled[0] == sampled[1] != sampled[2]
    keys = {k: set(g.keys()) for k, g in dec.graph_sets.items()}
    assert set(keys) == {(128, 128 + 24 + 3 * 5)}
    assert keys[(128, 152 + 15)] == {(2, False), (3, False), (2, True),
                                     (3, True)}


def test_speculative_graph_pool_matches_the_eager_pool(gen):
    """The speculative pool's round graphs give every greedy request the
    tokens of the same traffic through the eager speculative pool."""
    cfg, params = _tiny_tree("bf16")
    params = llama.fuse_llama_params(params)
    eng = Engine(cfg, params, buckets=(64, 128), max_new_tokens=16,
                 cache_dtype=torch.int8, steps_per_call=4)
    rng = np.random.default_rng(3)
    reqs = [([1] + [7, 8, 9] * 20, 0.0), (rng.integers(5, 400, 30).tolist(),
                                          0.0),
            (rng.integers(5, 400, 50).tolist(), 0.9)]
    results = []
    for eager in (False, True):
        pool = ContinuousEngine(eng, rows=3, bucket=128, extra_slots=48,
                                steps_per_call=4, decode_ramp=(2,),
                                speculative=True, eager=eager,
                                spec=SpecConfig(draft_len=4,
                                                rounds_per_call=2,
                                                disable_below=0.0))
        try:
            pool.warmup()
            queues = [pool.submit(p, temperature=t, max_new_tokens=12,
                                  eos_id=-1) for p, t in reqs]
            toks = [list(_drain(q, timeout=120)) for q in queues]
            assert pool.rounds_run > 0
            if not eager:
                assert {(2, True), (4, True)} <= set(
                    pool._spec_graphs.keys())
        finally:
            pool.close()
        results.append(toks)
    for (_, t), g, e in zip(reqs, *results):
        assert len(g) == len(e) == 12
        if t == 0.0:
            assert g == e
