"""Smoke test of the PyTorch port (``valley_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the CUDA kernels from ``valley_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the Valley-7B paths
give it (K1 and K3 before serving, K2 before training, each with a planted
fault that must fail the check), and drives the port's two paths at full
width and depth with random bf16 weights from a seed, one after the other
(the serving model is freed before training):

- serving: one 8-frame video question with Valley-7B through
  ``Engine.generate_tokens``; checks that the path went through K1 and K3
  and compares its logits at the prefill and at three decode steps with
  the same path run on the plain attention functions;
- training: Valley-7B stage 1 (frozen backbone, projector and input
  embeddings trained, the stage-1 recipe's optimizer settings) through
  ``Trainer.train_step`` on 16 synthetic rows from the port's collator and
  loader; checks a falling loss, untouched frozen weights, K1 and K2
  launches per step, and the first step's loss and gradients against the
  same step on the plain attention functions.

TF32 is off for matmuls and cuDNN, so fp32 references are fp32.  Every
phase prints its lines; a failed check raises and the script exits
non-zero.  The line before the last is a JSON object with one entry for
each kernel on each path: its launches on that path, error, device time
beside its plain version's, its bound and the library's time, at the shape
that path gives it; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel tolerance, relative to the reference output: max abs error <=
# REL_TOL * max|ref|, two bf16 ulps at the largest output.  Both sides
# compute in fp32 from the same bf16 inputs and round the output to bf16;
# they differ in summation order and, for decode, in where probabilities are
# rounded to bf16 (per 64-slot chunk in the kernel, after the global softmax
# in the plain version).  A CPU emulation of the kernel's rounding at the 7B
# decode shape differs from the plain version by up to 0.65% of max|ref|.
# Inputs are N(0, 1), so logits have unit spread and the output depends on
# which slots are attended: attending the hole in the 7B decode mask moves
# it by 12-47% of max|ref| in that emulation, and the planted fault below
# must fail the check.
REL_TOL = 2 ** -6
# Kernels vs plain logits of the full-size slice, at the prefill and at
# three teacher-forced decode steps: the kernels' one-ulp differences in
# the attention outputs propagate through 32 bf16 layers.  H100 readings of
# this script: 0.0703 at the prefill (largest logit 4.06); the bar is about
# twice that.
LOGIT_TOL = 0.15
# The training slice's first step through the kernels against the same
# step on the plain attention functions (bf16 model, fp32 loss): the
# kernels' one-ulp differences in the attention outputs and gradients
# propagate through 32 layers forward and back.  Loss as an absolute
# difference, gradients as relative L2 (|g_k - g_p| / |g_p|).  H100
# readings of this script: loss 4.86e-5 (loss 10.92), gradients 2.26e-2
# (input embeddings) and 1.89e-2 (projector); the bars are about twice
# that.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.05
DECODE_CHECK_STEPS = 3
NEW_TOKENS = 64
BENCH_TOKENS = dict(im_patch=31996, im_start=31997, im_end=31998,
                    vi_frame=31999, vi_start=31994, vi_end=31995)
# Profiler kernel names by kind, for the training step's breakdown
KERNEL_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd", ("flash_bwd_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    ("elementwise and reductions", ("elementwise", "reduce_kernel",
                                    "softmax", "index", "scatter", "gather",
                                    "cat", "copy", "Memcpy", "Memset")),
)
# The H100 SXM's published peaks (NVIDIA's datasheet): HBM bytes/s
# and dense bf16 tensor-core FLOP/s, for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over a loop of ``iters`` calls, by
    CUDA events around the whole loop (host launch cost included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The torch ops whose FLOPs the profiler counts and whose kernels are
# cuBLAS/cuDNN matrix products (the "matmul" kind below)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::conv2d")


def profile_device(fn, iters: int = 1, with_flops: bool = False):
    """Run ``fn()`` ``iters`` times under the profiler's CUDA trace.
    Returns (device ms per call summed over every kernel and copy, the
    kernels by total device ms, the FLOPs per call of `MATMUL_OPS` as the
    profiler counts them from the recorded shapes, or 0 without
    ``with_flops``).  A trace that holds no device time is taken again,
    up to three times in all, and then raises: on an H100 with torch 2.11
    one trace of this script came back without device events while the
    same call traced alone did not."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=with_flops,
                     with_flops=with_flops) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [(e.key, e.self_device_time_total / 1e3) for e in events
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
        total = sum(ms for _, ms in rows)
        if total > 0:
            break
        print(f"profiler: trace {attempt} recorded no device time")
    check(total > 0, "the profiler recorded no device time")
    flops = sum(e.flops or 0 for e in events if e.key in MATMUL_OPS)
    return total / iters, sorted(rows, key=lambda r: -r[1]), flops / iters


def kernel_times(fn, plain_fn, iters: int) -> dict:
    """Per-call times of a kernel's wrapper and its plain version: ``ms``
    and ``plain_ms`` are device time from the profiler trace; ``loop_ms``
    and ``plain_loop_ms`` are a loop of calls timed by CUDA events."""
    fn()
    plain_fn()
    return {"ms": profile_device(fn, iters)[0],
            "plain_ms": profile_device(plain_fn, iters)[0],
            "loop_ms": time_ms(fn, iters), "plain_loop_ms": time_ms(
                plain_fn, iters)}


def fmt_times(t: dict) -> str:
    return (f"device {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms; loop "
            f"{t['loop_ms']:.4f} ms vs plain {t['plain_loop_ms']:.4f} ms")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def tolerance(ref: torch.Tensor) -> float:
    return REL_TOL * ref.float().abs().max().item()


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the bf16 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attended_pairs(kv_mask: torch.Tensor, sq: int, causal: bool) -> int:
    """(query, key) pairs this data attends, summed over the batch: what
    the work needs, whatever the kernel computes and masks."""
    m = kv_mask.to(torch.int64)
    if not causal:
        return int(m.sum()) * sq
    # query i attends the valid keys at or before i (Sq == Sk)
    return int(m.cumsum(dim=1).sum())


def attention_bound(q, k, kv_mask, causal, products: int,
                    extra_bytes: int) -> dict:
    """Bound of an attention call: ``products`` matrix products of 2*D
    operations per attended pair and head; bytes are q/k/v/out (plus
    ``extra_bytes``) read or written once, and the mask."""
    b, sq, h, d = q.shape
    pairs = attended_pairs(kv_mask, sq, causal) * h
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + \
        kv_mask.numel() + extra_bytes
    return bound(n_bytes, products * 2 * d * pairs)


def library_attention_ms(q, k, v, kv_mask, causal: bool, dout=None,
                         iters: int = 10) -> float:
    """Device ms of one call of torch's scaled_dot_product_attention on
    the same inputs and boolean mask: its forward or, given ``dout``, its
    backward.  A yardstick only: the port never calls it."""
    f = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, D)
    mask = kv_mask[:, None, None, :]
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = mask & torch.ones((sq, sk), dtype=torch.bool,
                                 device=q.device).tril(sk - sq)
    if dout is None:
        fn = lambda: f(qt, kt, vt, attn_mask=mask)  # noqa: E731
    else:
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        out = f(*leaves, attn_mask=mask)
        g = dout.transpose(1, 2)
        fn = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, g, retain_graph=True)
    fn()
    return profile_device(fn, iters)[0]


def flash_cases(gen):
    """(name, q, k, v, kv_mask, causal): the 7B prefill shape first."""
    def qkv(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(3)]

    cases = []
    q, k, v = qkv(1, 512, 32, 128)
    mask = torch.ones((1, 512), dtype=torch.bool, device="cuda")
    mask[:, 473:] = False                      # a prompt padded to 512
    cases.append(("7b_prefill_S512_D128", q, k, v, mask, True))
    q, k, v = qkv(2, 300, 4, 64)
    mask = torch.ones((2, 300), dtype=torch.bool, device="cuda")
    mask[0, 283:] = False
    cases.append(("ragged_S300_D64", q, k, v, mask, True))
    q, k, v = qkv(2, 96, 2, 64)
    mask = torch.ones((2, 96), dtype=torch.bool, device="cuda")
    mask[1] = False                            # every row of batch 1 masked
    cases.append(("fully_masked_rows_D64", q, k, v, mask, False))
    return cases


def flash_bwd_cases(gen):
    """(name, q, k, v, dout, kv_mask, causal): the 7B training shape
    first, with each row's length drawn in 300-512."""
    def make(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(4)]

    cases = []
    q, k, v, g = make(16, 512, 32, 128)
    lengths = torch.randint(300, 513, (16,), generator=gen, device="cuda")
    mask = torch.arange(512, device="cuda")[None, :] < lengths[:, None]
    cases.append(("7b_train_B16_S512_D128", q, k, v, g, mask, True))
    q, k, v, g = make(2, 300, 4, 64)
    mask = torch.ones((2, 300), dtype=torch.bool, device="cuda")
    mask[0, 283:] = False
    cases.append(("ragged_S300_D64", q, k, v, g, mask, True))
    q, k, v, g = make(2, 96, 2, 64)
    mask = torch.ones((2, 96), dtype=torch.bool, device="cuda")
    mask[0, 70:] = False                       # a masked tail of keys
    mask[1] = False                            # every row of batch 1 masked
    cases.append(("fully_masked_rows_D64", q, k, v, g, mask, False))
    return cases


def k2_phase(gen) -> tuple:
    """K2 against its plain version on the cases of `flash_bwd_cases`,
    with the forward's out and lse from K1; a planted fault; times at the
    7B training shape, where K1 is also checked and timed.  Returns (K2's
    max error, K2's times, K1's error and times at the training shape)."""
    from valley_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    k2_err, k2_t, k1 = 0.0, None, None
    for name, q, k, v, g, mask, causal in flash_bwd_cases(gen):
        out, lse = flash_attention(q, k, v, mask, causal=causal,
                                   return_lse=True)
        if k1 is None:
            # K1 at the shape the training path gives it
            ref = flash_attention_plain(q, k, v, mask, causal=causal)
            err, tol = max_err(out, ref), tolerance(ref)
            check(bool(torch.isfinite(out.float()).all()) and err <= tol,
                  f"K1 {name}: max abs err {err} > {tol}")
            k1 = {"max_abs_err": err, **kernel_times(
                lambda: flash_attention(q, k, v, mask, causal=causal),
                lambda: flash_attention_plain(q, k, v, mask, causal=causal),
                iters=5)}
            k1.update(attention_bound(q, k, mask, causal, 2,
                                      lse.numel() * 4))
            k1["library_ms"] = library_attention_ms(q, k, v, mask, causal,
                                                    iters=5)
            print(f"K1 flash_fwd {name}: max_abs_err {err:.3e} (tol "
                  f"{tol:.3e}) {fmt_times(k1)}; bound {k1['bound_ms']:.4f} "
                  f"ms ({k1['bound_by']}), library {k1['library_ms']:.4f} ms")
            del ref
        got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                        causal=causal)
        parts = []
        for what, a, r in zip(("dq", "dk", "dv"), got, ref):
            err, tol = max_err(a, r), tolerance(r)
            check(a.dtype == torch.bfloat16 and a.shape == r.shape,
                  f"K2 {name} {what}: dtype or shape")
            check(bool(torch.isfinite(a.float()).all()),
                  f"K2 {name} {what}: not finite")
            check(err <= tol, f"K2 {name} {what}: max abs err {err} > {tol}")
            k2_err = max(k2_err, err)
            parts.append(f"{what} {err:.3e} (tol {tol:.3e})")
        if name.startswith("fully_masked"):
            dq, dk, dv = got
            check(all(t[1].abs().max().item() == 0.0 for t in got),
                  "K2: a batch whose every key is masked must get 0")
            check(dk[0, 70:].abs().max().item() == 0.0
                  and dv[0, 70:].abs().max().item() == 0.0,
                  "K2: masked keys must get 0")
        line = f"K2 flash_bwd {name}: max_abs_err " + ", ".join(parts)
        if k2_t is None:
            # planted fault: a kernel that ignored the kv mask (fed an
            # all-true one) must fail the check against the masked
            # reference
            full = torch.ones_like(mask)
            bad = flash_attention_bwd(q, k, v, full, out, lse, g,
                                      causal=causal)
            fault = max(max_err(a, r) / tolerance(r)
                        for a, r in zip(bad, ref))
            check(fault > 1.0, f"K2 {name}: ignoring the mask moved the "
                  f"gradients by {fault:.3f} of the tolerance only")
            line += (f"; ignoring the mask instead: {fault:.1f}x the "
                     f"tolerance (must fail)")
            k2_t = kernel_times(
                lambda: flash_attention_bwd(q, k, v, mask, out, lse, g,
                                            causal=causal),
                lambda: flash_attention_bwd_plain(q, k, v, mask, out, lse,
                                                  g, causal=causal),
                iters=5)
            # inputs q/k/v/out/dout and the lse, outputs dq/dk/dv
            k2_t.update(attention_bound(
                q, k, mask, causal, 5,
                (g.numel() + q.numel() + 2 * k.numel()) * g.element_size()
                + lse.numel() * 4))
            k2_t["library_ms"] = library_attention_ms(q, k, v, mask, causal,
                                                      dout=g, iters=5)
            line += (f" {fmt_times(k2_t)}; bound {k2_t['bound_ms']:.4f} ms "
                     f"({k2_t['bound_by']}), library {k2_t['library_ms']:.4f}"
                     f" ms")
        print(line)
        del q, k, v, g, out, lse, got, ref
    return k2_err, k2_t, k1


class TrainRows:
    """The training slice's synthetic rows, made with numpy from a seed:
    ``n`` rows of 300-512 tokens (the first exactly 512), a masked prompt
    holding the media span, the first half videos of ``frames`` frames and
    the second half single images (the collator pads their frame axis)."""

    def __init__(self, cfg, n: int = 16, seq: int = 512, frames: int = 8):
        rng = np.random.default_rng(0)
        tok = cfg.tokens
        span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
            [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
            [tok.vi_end]
        size = cfg.vision.image_size
        lengths = rng.integers(300, seq + 1, n)
        lengths[0] = seq
        self.items = []
        for i, length in enumerate(lengths):
            ids = rng.integers(5, 30000, size=int(length))
            ids[0] = 1
            ids[1:1 + len(span)] = span
            labels = ids.copy()
            labels[:1 + len(span) + int(rng.integers(4, 24))] = -100
            t = frames if i < n // 2 else 1
            self.items.append(dict(
                input_ids=ids, labels=labels,
                image=rng.standard_normal((t, 3, size, size)).astype(
                    np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def train_phase(smi: str) -> tuple:
    """Valley-7B stage 1 on the card through `Trainer`: the first step's
    loss and gradients against the plain attention functions, one warm-up
    update, then three timed updates on the same batch with the launch
    counts read around them, then one profiled update.  Returns the K1 and
    K2 launches of the three timed updates."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.dataset import (
        DataCollatorForSupervisedDataset, DataLoader)
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.attention import KERNELS, PLAIN
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers = cfg.text.num_hidden_layers
    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"train: valley_7b random bf16 weights in "
          f"{time.perf_counter() - t0:.1f} s")
    loader = DataLoader(TrainRows(cfg), 16, DataCollatorForSupervisedDataset(
        pad_token_id=0, pad_to_multiple=64), seed=0, num_workers=1)
    # the stage-1 recipe (valley_tpu/configs/experiment/valley_stage1.yaml)
    # over the five updates this phase takes
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    tc = TrainConfig(output_dir=out_dir, learning_rate=2e-3,
                     lr_scheduler_type="cosine", warmup_ratio=0.03,
                     adam_beta1=0.9, adam_beta2=0.95, max_grad_norm=1.0,
                     weight_decay=0.0, gradient_checkpointing=True,
                     freeze_backbone=True, tune_mm_mlp_adapter=True,
                     per_device_train_batch_size=16, save_steps=0)
    trainer = Trainer(cfg, tc, params, loader, total_steps=5)
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    b, s = batch["input_ids"].shape
    tokens = int(batch["attention_mask"].sum())
    check((b, s) == (16, 512), f"train batch {b}x{s}, want 16x512")
    check(tuple(batch["images"].shape[:2]) == (16, 8)
          and int(batch["frame_mask"].sum()) == 8 * 8 + 8,
          "train batch: 8 videos of 8 frames and 8 single images")
    trainable = dict(trainer.labels)
    names = [n for n, lab in trainable.items() if lab != "frozen"]
    check(sorted(names) == ["llama.embed", "projector.b", "projector.w"],
          f"stage-1 trainable parameters: {names}")
    n_train = sum(p.numel() for p in params.parameters() if p.requires_grad)
    print(f"train: batch {b}x{s}, {tokens} non-pad tokens, 8 videos x 8 "
          f"frames + 8 images; trainable {n_train / 1e6:.2f} M of "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B")
    before = {n: p.detach().cpu().clone()
              for n, p in params.named_parameters()}

    # the first step's loss and gradients: kernels against plain attention
    loss_k, gn_k, grads_k = trainer.loss_and_grads(batch)
    trainer.attention = PLAIN
    loss_p, gn_p, grads_p = trainer.loss_and_grads(batch)
    trainer.attention = KERNELS
    loss_diff = abs(float(loss_k) - float(loss_p))
    parts = [f"loss {float(loss_k):.5f} vs {float(loss_p):.5f} (diff "
             f"{loss_diff:.2e}, tol {TRAIN_LOSS_TOL})"]
    check(loss_diff <= TRAIN_LOSS_TOL, f"train: first-step loss differs by "
          f"{loss_diff}")
    for name, gk, gp in zip(names, grads_k, grads_p):
        err = rel_l2(gk, gp)
        parts.append(f"{name} grad rel L2 {err:.2e}")
        check(bool(torch.isfinite(gk.float()).all()), f"train: {name} grad "
              "not finite")
        check(err <= TRAIN_GRAD_TOL, f"train: {name} grad rel L2 {err} > "
              f"{TRAIN_GRAD_TOL}")
    print("train: first step, kernels vs plain: " + "; ".join(parts) +
          f" (tol {TRAIN_GRAD_TOL}); grad norm {float(gn_k):.4f} vs "
          f"{float(gn_p):.4f}")
    del grads_k, grads_p

    losses = [trainer.train_step(batch)["loss"]]     # warm-up update
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):                                # the main path
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        check(m["updated"], "train: a step did not update")
    n_k1, n_k2 = flash_attention.launches, flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"train: losses {[round(x, 5) for x in losses]} (warm-up, then 3 "
          f"updates); launches over 3 updates K1 {n_k1} K2 {n_k2}")
    check(all(np.isfinite(losses)), "train: loss not finite")
    check(losses[-1] < losses[0], "train: the loss did not fall")
    check(n_k1 == 3 * 2 * layers,
          f"K1 launched {n_k1} times in 3 updates, want {3 * 2 * layers}")
    check(n_k2 == 3 * layers,
          f"K2 launched {n_k2} times in 3 updates, want {3 * layers}")
    for name, p in params.named_parameters():
        same = torch.equal(p.detach().cpu(), before[name])
        check(same == (name not in names),
              f"train: {name} {'unchanged' if same else 'changed'}")
    del before

    step_s = sorted(walls)[1]
    step_dev, top, mm_flops = profile_device(
        lambda: trainer.train_step(batch), with_flops=True)
    shares = ", ".join(f"{name[:48]} {100 * ms / step_dev:.1f}%"
                       for name, ms in top[:8])
    kinds: dict = {}
    for name, ms in top:
        kind = next((k for k, keys in KERNEL_KINDS if any(
            key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print("train: device time by kind: " + ", ".join(
        f"{k} {ms:.1f} ms ({100 * ms / step_dev:.1f}%)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])))
    mm_ms = kinds.get("matmul (cuBLAS)", 0.0)
    check(mm_flops > 0 and mm_ms > 0, "train: no matmul FLOPs or time")
    mm_rate = mm_flops / (mm_ms / 1e3)
    print(f"train: matmul ops {mm_flops / 1e12:.1f} TFLOP (the profiler's "
          f"count from the recorded shapes of {', '.join(MATMUL_OPS)}) in "
          f"{mm_ms:.1f} ms of matmul kernels: {mm_rate / 1e12:.1f} TFLOP/s, "
          f"{100 * mm_rate / BF16_FLOP_PER_S:.1f}% of the bf16 peak")
    print(f"train: step wall {step_s * 1e3:.1f} ms (median of 3: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
          f"{tokens / step_s:.0f} non-pad tokens/s, device busy "
          f"{step_dev:.1f} ms (idle share {1 - step_dev / (step_s * 1e3):.3f}"
          f"), peak memory {peak / 2 ** 30:.2f} GiB, on {smi}; top kernels: "
          f"{shares}")
    del trainer, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return n_k1, n_k2


def decode_cases(gen, smax_7b: int, prompt_len: int, bucket: int):
    """(name, q, k_all, v_all, li, valid, hole): the 7B decode shape first,
    with the hole [prompt_len, bucket) that decode leaves in the mask."""
    def make(n_layers, b, smax, h, hkv, d):
        q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
        kv = [torch.randn((n_layers, b, smax, hkv, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
        return q, kv[0], kv[1]

    cases = []
    q, k, v = make(32, 1, smax_7b, 32, 32, 128)
    valid = torch.zeros((1, smax_7b), dtype=torch.bool, device="cuda")
    valid[:, :prompt_len] = True               # the prompt
    valid[:, bucket:bucket + 40] = True        # 40 decoded tokens
    cases.append(("7b_decode_L32_S%d_D128_hole" % smax_7b, q, k, v, 17,
                  valid, (prompt_len, bucket)))
    q, k, v = make(3, 1, 96, 4, 2, 32)
    valid = torch.rand((1, 96), generator=gen, device="cuda") < 0.8
    valid[:, :4] = True
    cases.append(("gqa_rep2_D32", q, k, v, 1, valid, None))
    q, k, v = make(3, 2, 640, 8, 8, 128)
    valid = torch.rand((2, 640), generator=gen, device="cuda") < 0.8
    valid[:, :4] = True
    cases.append(("batch2_S640_D128", q, k, v, 1, valid, None))
    q, k, v = make(3, 1, 3000, 4, 4, 128)
    valid = torch.rand((1, 3000), generator=gen, device="cuda") < 0.8
    cases.append(("S3000_D128", q, k, v, 2, valid, None))
    return cases


def decode_logits(engine, state, prompt_len: int, tokens):
    """fp32 logits of teacher-forced decode steps after ``state``'s
    prefill: step i feeds ``tokens[i]`` at slot bucket + i and rotary
    position prompt_len + i, as ``Engine._decode`` does."""
    from valley_tpu_torch.models import llama

    p, text, dev = engine.params["llama"], engine.cfg.text, engine.device
    valid = state.valid.clone()
    out = []
    with torch.inference_mode():
        for i, t in enumerate(tokens):
            slot = state.bucket + i
            valid[:, slot] = True
            hidden, _ = llama.forward_hidden(
                p, text, llama.embed(p, torch.tensor([[t]], device=dev)),
                positions=torch.tensor([[prompt_len + i]], device=dev),
                cache=state.cache, cache_index=slot, kv_valid=valid,
                attention=engine.attention)
            out.append(llama.logits_from_hidden(p, hidden)[0, 0])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from valley_tpu_torch import SpecialTokens, valley_7b
        from valley_tpu_torch.inference.engine import Engine, GenerationConfig
        from valley_tpu_torch.models import valley
        from valley_tpu_torch.ops import _build
        from valley_tpu_torch.ops.attention import PLAIN
        from valley_tpu_torch.ops.decode_attention import (
            decode_attention_plain, decode_attention_stacked)
        from valley_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_plain)
    except ImportError as e:
        print(f"chip_smoke: run from the root of a valley-tpu checkout "
              f"({e})", file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    print(f"build: {_build.build_all():.2f} s for {list(_build.SOURCES)}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    bucket, new = 512, NEW_TOKENS
    steps = new - 1
    # the engine's cache: bucket + max_new_tokens + steps_per_call slots
    smax = bucket + new + steps

    # 3. K1 against its plain version
    k1_err, k1_t = 0.0, None
    for name, q, k, v, mask, causal in flash_cases(gen):
        out, lse = flash_attention(q, k, v, mask, causal=causal,
                                   return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                             return_lse=True)
        err, tol = max_err(out, ref), tolerance(ref)
        lse_err = max_err(lse, ref_lse)
        check(bool(torch.isfinite(out.float()).all()),
              f"K1 {name}: not finite")
        check(err <= tol, f"K1 {name}: max abs err {err} > {tol}")
        check(lse_err <= 1e-3, f"K1 {name}: lse err {lse_err}")
        if name.startswith("fully_masked"):
            check(out[1].abs().max().item() == 0.0,
                  "K1: fully masked rows must be 0")
        k1_err = max(k1_err, err)
        line = (f"K1 flash_fwd {name}: max_abs_err {err:.3e} (tol {tol:.3e}"
                f"), lse err {lse_err:.3e} (tol 1e-3)")
        if k1_t is None:
            k1_t = kernel_times(
                lambda: flash_attention(q, k, v, mask, causal=causal),
                lambda: flash_attention_plain(q, k, v, mask, causal=causal),
                iters=20)
            k1_t.update(attention_bound(q, k, mask, causal, 2,
                                        lse.numel() * 4))
            k1_t["library_ms"] = library_attention_ms(q, k, v, mask, causal,
                                                      iters=20)
            line += (f" {fmt_times(k1_t)}; bound {k1_t['bound_ms']:.4f} ms "
                     f"({k1_t['bound_by']}), library {k1_t['library_ms']:.4f}"
                     f" ms")
        print(line)

    # 4. K3 against its plain version
    k3_err, k3_t = 0.0, None
    for name, q, k, v, li, valid, hole in decode_cases(gen, smax, 473,
                                                       bucket):
        out = decode_attention_stacked(q, k, v, li, valid)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k, v, li, valid)
        err, tol = max_err(out, ref), tolerance(ref)
        check(bool(torch.isfinite(out.float()).all()),
              f"K3 {name}: not finite")
        check(err <= tol, f"K3 {name}: max abs err {err} > {tol}")
        k3_err = max(k3_err, err)
        line = f"K3 decode_attn {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
        if hole is not None:
            # planted fault: a kernel that attended the hole (as one that
            # took a length instead of the mask would) must fail the check
            filled = valid.clone()
            filled[:, hole[0]:hole[1]] = True
            fault = max_err(decode_attention_stacked(q, k, v, li, filled),
                            ref)
            check(fault > tol, f"K3 {name}: attending the hole moved the "
                  f"output by {fault} only, within the tolerance {tol}")
            line += f"; attending the hole instead: {fault:.3e} (must fail)"
        if k3_t is None:
            # walk the layers, as decode does, so each call reads its K/V
            # from device memory rather than from L2
            n_layers = k.shape[0]
            it = iter(range(10 ** 9))
            k3_t = kernel_times(
                lambda: decode_attention_stacked(
                    q, k, v, next(it) % n_layers, valid),
                lambda: decode_attention_plain(
                    q, k, v, next(it) % n_layers, valid), iters=64)
            kv_bytes = 2 * k[0].numel() * k.element_size()
            # the data's need: the valid slots' K and V, q, out, the mask
            b_, smax_, hkv_, d_ = k.shape[1:]
            need = (2 * int(valid.sum()) * hkv_ * d_ * k.element_size()
                    + 2 * q.numel() * q.element_size() + valid.numel())
            k3_t.update(bound(need, 4 * d_ * int(valid.sum()) * q.shape[2]))
            k3_t["library_ms"] = library_attention_ms(
                q, k[li], v[li], valid, False, iters=64)
            line += (f" {fmt_times(k3_t)} ({kv_bytes / 1e6:.2f} MB of K/V "
                     f"per call: {kv_bytes / k3_t['ms'] / 1e6:.1f} GB/s of "
                     f"the card's 3350); bound {k3_t['bound_ms']:.4f} ms "
                     f"({k3_t['bound_by']}, {need / 1e6:.2f} MB of valid "
                     f"slots), library {k3_t['library_ms']:.4f} ms")
        print(line)
        del k, v

    # 5. the slice: Valley-7B, 8 uint8 frames, a 512-bucket prompt
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"valley_7b random bf16 weights: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params in {time.perf_counter() - t0:.1f} s")
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    rng = np.random.default_rng(0)
    prompt = [1] + span + rng.integers(
        5, 30000, size=bucket - len(span) - 40).tolist()
    size = cfg.vision.image_size
    frames = rng.integers(0, 256, (1, 8, 3, size, size)).astype(np.uint8)
    gcfg = GenerationConfig(max_new_tokens=new, do_sample=False)
    engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                    steps_per_call=steps)

    def run():
        t0 = time.perf_counter()
        t_first, toks = None, []
        for t in engine.generate_tokens([prompt], frames, gcfg,
                                        eos_ids=[-1]):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(int(t[0]))
        return t_first, time.perf_counter() - t0, toks

    run()   # warm-up: lazy CUDA / cuBLAS initialisation
    flash_attention.launches = 0
    decode_attention_stacked.launches = 0
    t_first, total, toks = run()           # the main path
    n_k1 = flash_attention.launches
    n_k3 = decode_attention_stacked.launches
    layers = cfg.text.num_hidden_layers
    check(len(toks) == new, f"generated {len(toks)} tokens, want {new}")
    check(all(0 <= t < cfg.text.vocab_size for t in toks), "token ids")
    check(n_k1 == layers, f"K1 launched {n_k1} times, want {layers}")
    check(n_k3 == layers * (new - 1),
          f"K3 launched {n_k3} times, want {layers * (new - 1)}")
    decode_tps = (new - 1) / (total - t_first)
    print(f"slice: prompt {len(prompt)} tokens in bucket {bucket}, 8 frames "
          f"{size}px uint8, {new} greedy tokens; launches K1 {n_k1} "
          f"K3 {n_k3}")
    print(f"slice: video->first-token {t_first:.4f} s, decode "
          f"{decode_tps:.2f} tok/s ({1e3 / decode_tps:.3f} ms/token) on "
          f"{smi}")

    # where the time goes: device busy time of the prefill and of a whole
    # request, against the unprofiled wall times above
    frames_dev = torch.from_numpy(frames).cuda()
    vision_ms = time_ms(lambda: valley.encode_images(params, cfg, frames_dev),
                        iters=3, warmup=1)
    vision_dev, _, _ = profile_device(
        lambda: valley.encode_images(params, cfg, frames_dev))
    prefill_dev, _, _ = profile_device(
        lambda: engine.prefill([prompt], frames, gcfg))
    run_dev, top, _ = profile_device(run)
    decode_dev = (run_dev - prefill_dev) / (new - 1)
    wall_tok = (total - t_first) / (new - 1) * 1e3
    shares = ", ".join(f"{name[:48]} {100 * ms / run_dev:.1f}%"
                       for name, ms in top[:6])
    print(f"breakdown: video->first-token wall {t_first * 1e3:.2f} ms, "
          f"prefill device {prefill_dev:.2f} ms (vision tower device "
          f"{vision_dev:.2f} ms, wall {vision_ms:.2f} ms); decode wall "
          f"{wall_tok:.3f} ms/token, device busy {decode_dev:.3f} ms/token "
          f"(idle share {1 - decode_dev / wall_tok:.3f}); request device "
          f"busy {run_dev:.2f} ms of {total * 1e3:.2f} ms wall; top kernels: "
          f"{shares}")

    # the slice's logits through the kernels against the same path with
    # the plain attention functions: the prefill, then decode steps fed the
    # generated tokens
    plain_engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                          steps_per_call=steps, attention=PLAIN)
    states = [e.prefill([prompt], frames, gcfg)
              for e in (engine, plain_engine)]
    check(int(states[0].token[0]) == toks[0], "prefill is not repeatable")
    forced = toks[:DECODE_CHECK_STEPS]
    logits = [[s.logits[0]] + decode_logits(e, s, len(prompt), forced)
              for e, s in zip((engine, plain_engine), states)]
    for i, (lk, lp) in enumerate(zip(*logits)):
        where = "prefill" if i == 0 else f"decode step {i}"
        check(bool(torch.isfinite(lk).all())
              and lk.shape == (cfg.text.vocab_size,),
              f"{where} logits not finite or misshapen")
        diff = max_err(lk, lp)
        top2 = torch.topk(lp, 2).values
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"slice: {where} logits kernels vs plain max abs diff "
              f"{diff:.4e} (tol {LOGIT_TOL}; max |logit| "
              f"{lp.abs().max().item():.3f}), greedy token "
              f"{'agrees' if same else 'differs'} (plain top-2 margin "
              f"{(top2[0] - top2[1]).item():.4f})")
        check(diff <= LOGIT_TOL, f"{where} logits beyond tolerance")
        check(same, f"{where}: kernels and plain pick different tokens")

    # free the serving model: two 7B trees never share the card
    del engine, plain_engine, states, logits, params, frames_dev
    gc.collect()
    torch.cuda.empty_cache()

    # 6. K2 against its plain version
    k2_err, k2_t, k1_train = k2_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the training slice: Valley-7B stage 1
    train_k1, train_k2 = train_phase(smi)

    # one entry per kernel and path: ``launches`` is that path's count
    # (serving: one request; training: the three timed updates), the times
    # and bound are at the shape that path gives the kernel
    k1_src = dict(name="flash_fwd", route="cuda",
                  source="valley_tpu_torch/csrc/flash_fwd.cu",
                  replaces="valley_tpu/ops/flash_attention.py:54")
    kernels = [
        {**k1_src, "path": "serve", "launches": n_k1,
         "max_abs_err": k1_err, **k1_t},
        {"name": "decode_attn", "route": "cuda",
         "source": "valley_tpu_torch/csrc/decode_attn.cu",
         "replaces": "valley_tpu/ops/decode_pallas.py:68",
         "path": "serve", "launches": n_k3, "max_abs_err": k3_err, **k3_t},
        {**k1_src, "name": "flash_fwd_train", "path": "train",
         "launches": train_k1, **k1_train},
        {"name": "flash_bwd", "route": "cuda",
         "source": "valley_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "valley_tpu/ops/flash_attention.py:183",
         "path": "train", "launches": train_k2, "max_abs_err": k2_err,
         **k2_t},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
