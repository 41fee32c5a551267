"""Smoke test of the PyTorch port (``valley_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the CUDA kernels from ``valley_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the Valley-7B and
Valley-13B paths give it (K1 and K3 before serving, K4 and K3's int8-cache
branch before int8 serving, K5 with K1 and K3-int8 at 13B shapes before
int4 serving, K2 before training, each with a planted fault that must fail
the check; K6, the bf16 decode GEMV, at the shapes of both bf16 serving
paths and K7, the read-bandwidth probe, on 2 GB before batched serving),
and drives the port's five paths at full width and depth with random bf16
weights from a seed, each path in a process of its own, one after the
other:

- serving: one 8-frame video question with Valley-7B through
  ``Engine.generate_tokens``; checks that the path went through K1, K3 and
  K6 (every bf16 decode product, lm_head included) and compares its logits
  at the prefill and at three decode steps with the same path run on the
  plain versions;
- batched serving, ``batch_infer``'s configuration: Valley-7B bf16 weights
  fused, an int8 KV cache, a ``ContinuousEngine`` of 8 rows taking 12
  requests at once (8 video questions, 4 text prompts of 40 to 1500
  tokens, two of them sampled); checks the launches of K1, K3's int8
  branch and K6 against the pool's own count of prefills and pooled steps,
  the pooled logits at three teacher-forced steps against the plain
  versions, and each greedy request's tokens against the same request
  alone through ``Engine.generate_tokens``;
- int8 serving, the serving flagship of the JAX package: the same weights
  fused (``wqkv``, ``w_gateup``) and quantized to int8a8 on the card, an
  int8 KV cache, the same question; checks that the path went through K1,
  K3's int8 branch and K4 (the int8 decode GEMV, lm_head included) and
  compares its logits with the same path on the plain versions;
- int4 serving, the JAX package's one-card Valley-13B setup: random
  Valley-13B weights fused and quantized to int4gp on the card (group-128
  scales, nibble-packed), an int8 KV cache, the same question; checks that
  the path went through K1, K3's int8 branch and K5 (the grouped-int4
  decode GEMV, lm_head included) and compares its logits with the same path
  on the plain versions;
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
that path gives it (each decode GEMV also with the bound at the read rate
K7 measured); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
# The int8 slice's logits through the kernels (K1, K3-int8, K4) against the
# same path on their plain versions, at the prefill and three
# teacher-forced decode steps: the kernels' summation order and bf16
# roundings, through 32 layers of int8 weights, an int8 cache (a value
# moved across a rounding edge moves one int8 step) and W8A8 prefill.
# H100 readings of this script: 0.155 at the prefill (largest logit 4.16),
# 0.062 at the decode steps; the bar is about twice that.  The same greedy
# token is not checked on this slice: at decode step 2 the plain path's top
# two logits lie 0.0154 apart, under the 0.062 the paths differ by, and the
# kernels pick the other one (the token line still prints).
INT8_LOGIT_TOL = 0.3
# The int4 slice's logits through the kernels (K1, K3-int8, K5) against the
# same path on their plain versions, at the prefill and three
# teacher-forced decode steps: both prefill through the same dequantized
# products, so they differ by the attention kernels' roundings and, in
# decode, K5's summation order, through 40 layers and an int8 cache.  H100
# readings of this script: 0.0678 at the prefill (largest logit 4.96),
# 0.0743-0.0816 at the decode steps; the bar is about twice that.
INT4_LOGIT_TOL = 0.16
# The training slice's first step through the kernels against the same
# step on the plain attention functions (bf16 model, fp32 loss): the
# kernels' one-ulp differences in the attention outputs and gradients
# propagate through 32 layers forward and back.  Loss as an absolute
# difference, gradients as relative L2 (|g_k - g_p| / |g_p|).  H100
# readings of this script: loss 4.86e-5 (loss 10.92), gradients 2.26e-2
# (input embeddings) and 1.89e-2 (projector); the bars are about twice
# that.
# The batched slice's pooled logits (8 rows, per-row slots) through the
# kernels (K1, K3-int8, K6) against the same pooled steps on their plain
# versions, at three teacher-forced steps after a batched prefill: the
# kernels' summation order and bf16 roundings through 32 layers and an int8
# cache, as on the int8 slice.  Readings of this script on an H100 80GB
# HBM3 at 700 W: 0.0765 at the batched prefill (largest logit 4.58),
# 0.0770-0.0830 at the pooled steps; the bar is about twice that.
BATCH_LOGIT_TOL = 0.17
# A greedy request served in the pool may part from the same request
# served alone only where the alone run's top-2 logits lie closer than
# this: the two paths differ in summation order (batched prefill products,
# the decode slots' chunks), by about what the kernels and the plain
# versions differ on the serving slice (LOGIT_TOL's readings).
BATCH_MARGIN_BAR = 0.15
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.05
DECODE_CHECK_STEPS = 3
NEW_TOKENS = 64
# bench.py's request: a 473-token prompt in the 512 bucket; the engine's
# cache holds bucket + max_new_tokens + steps_per_call slots
PROMPT_LEN, BUCKET = 473, 512
SMAX = BUCKET + NEW_TOKENS + NEW_TOKENS - 1
BENCH_TOKENS = dict(im_patch=31996, im_start=31997, im_end=31998,
                    vi_frame=31999, vi_start=31994, vi_end=31995)
# Profiler kernel names of each kernel of the serving paths
KERNEL_NAMES = {"K1": ("flash_fwd_kernel",),
                "K3": ("decode_split_kernel", "decode_combine_kernel"),
                "K3-int8": ("decode_split_kernel", "decode_combine_kernel"),
                "K4": ("int8_matvec_kernel",),
                "K5": ("int4_matvec_kernel",),
                "K6": ("bf16_matvec_fk_kernel", "bf16_matvec_kf_kernel")}
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
# fp32 FMAs on the CUDA cores (K6 and K7 multiply and add in fp32 there)
FP32_FLOP_PER_S = 67e12


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


def add_bound(times: dict, b: dict, what: str) -> None:
    """Put a kernel's bound beside its times; a device time under the
    bound is a measurement that lost events, and fails."""
    times.update(b)
    check(times["ms"] >= times["bound_ms"], f"{what}: device time "
          f"{times['ms']} ms under the bound {times['bound_ms']} ms: the "
          "profiler lost events")


def bound(n_bytes: float, flops: float,
          peak: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` (the bf16 tensor-core
    peak unless given)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


def flash_cases(gen, heads: int = 32, model: str = "7b"):
    """(name, q, k, v, kv_mask, causal): the prefill shape of a model with
    ``heads`` heads of 128 first."""
    def qkv(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(3)]

    cases = []
    q, k, v = qkv(1, 512, heads, 128)
    mask = torch.ones((1, 512), dtype=torch.bool, device="cuda")
    mask[:, 473:] = False                      # a prompt padded to 512
    cases.append((f"{model}_prefill_S512_H{heads}_D128", q, k, v, mask,
                  True))
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
            add_bound(k1, attention_bound(q, k, mask, causal, 2,
                                          lse.numel() * 4), f"K1 {name}")
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
            add_bound(k2_t, attention_bound(
                q, k, mask, causal, 5,
                (g.numel() + q.numel() + 2 * k.numel()) * g.element_size()
                + lse.numel() * 4), f"K2 {name}")
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


def int8_weight(gen, f: int, k: int):
    """An (F, K) int8 weight and its (F,) bf16 scale, quantized by the
    port's quantizer from N(0, 1) / sqrt(K) bf16 values, as the serving
    tree's random weights are."""
    from valley_tpu_torch.ops.quant import quantize_tensor

    w = torch.randn((f, k), generator=gen, device="cuda") * k ** -0.5
    return quantize_tensor(w.bfloat16())


def library_matvec_ms(x, ws, scale, iters: int) -> tuple:
    """Device ms of one library call on K4's inputs, walking the weight
    copies ``ws`` as the kernel's timing does, and its label.  A yardstick
    only: the port never calls it.  torch's int8 weight-only product where
    this torch runs it on CUDA; otherwise a bf16 GEMV over the same weight
    dequantized (twice the bytes)."""
    it = iter(range(10 ** 9))
    try:
        torch._weight_int8pack_mm(x, ws[0], scale)
        fn = lambda: torch._weight_int8pack_mm(  # noqa: E731
            x, ws[next(it) % len(ws)], scale)
        label = "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError) as e:
        print(f"K4 yardstick: torch._weight_int8pack_mm does not run on "
              f"CUDA here ({str(e).splitlines()[0][:80]}); timing a bf16 "
              f"GEMV instead")
        wb = [(w.float() * scale.float()[:, None]).bfloat16() for w in ws]
        fn = lambda: torch.nn.functional.linear(  # noqa: E731
            x, wb[next(it) % len(wb)])
        label = "F.linear over the bf16 weight (bf16 GEMV, twice the bytes)"
    fn()
    return profile_device(fn, iters)[0], label


# Valley-7B's fused int8 serving weights, (name, K, F): the decode GEMVs of
# one layer, then lm_head
K4_SHAPES_7B = (("wqkv", 4096, 12288), ("wo", 4096, 4096),
                ("w_gateup", 4096, 22016), ("w_down", 11008, 4096),
                ("lm_head", 4096, 32000))
# Bytes of weight copies a GEMV's timing walks: decode walks 6.6 GB of
# weights per token, so a call finds none of its weight in L2
TIMING_BYTES = 2_500_000_000
TIME_KEYS = ("ms", "plain_ms", "loop_ms", "plain_loop_ms", "bound_ms",
             "library_ms")


def k4_phase(gen, layers: int) -> tuple:
    """K4 against its plain version on the five Valley-7B weights at B = 1,
    at the row limit with K = 11008 and at an odd F; a planted fault (the
    scales shifted by one output channel); each 7B weight timed walking
    copies of it past the 50 MB L2.  Returns (max error, times per call
    averaged over one decode token's GEMVs: ``layers`` x the four layer
    weights, then lm_head)."""
    from valley_tpu_torch.ops.quant import (MAX_ROWS, int8_matvec,
                                            int8_matvec_plain)

    cases = [(f"7b_{n}_B1", 1, k, f) for n, k, f in K4_SHAPES_7B] + [
        ("rows8_K11008", MAX_ROWS, 11008, 4096), ("B3_odd_F1001", 3, 4096,
                                                  1001)]
    err_max, per_weight, label = 0.0, {}, None
    for name, b, k, f in cases:
        x = torch.randn((b, k), generator=gen, device="cuda").bfloat16()
        w, scale = int8_weight(gen, f, k)
        out = int8_matvec(x, w, scale)
        torch.cuda.synchronize()
        ref = int8_matvec_plain(x, w, scale)
        err, tol = max_err(out, ref), tolerance(ref)
        check(out.dtype == torch.float32 and tuple(out.shape) == (b, f)
              and bool(torch.isfinite(out).all()),
              f"K4 {name}: dtype, shape or not finite")
        check(err <= tol, f"K4 {name}: max abs err {err} > {tol}")
        err_max = max(err_max, err)
        line = f"K4 int8_matvec {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
        if name == "7b_wqkv_B1":
            # planted fault: a kernel that read each row's scale from the
            # channel before must fail the check
            fault = max_err(int8_matvec(x, w, scale.roll(1)), ref)
            check(fault > tol, f"K4 {name}: shifted scales moved the output "
                  f"by {fault} only, within the tolerance {tol}")
            line += f"; scales shifted by one channel instead: {fault:.3e} "\
                "(must fail)"
        if name.startswith("7b_"):
            # copies of the weight, walked in turn, far past what the 50 MB
            # L2 keeps of a cyclic walk (on an H100, a walk of a few
            # hundred MB read faster than the HBM's 3.35 TB/s)
            ws = [w] + [w.clone() for _ in range(
                -(-TIMING_BYTES // w.numel()) - 1)]
            it = iter(range(10 ** 9))
            t = kernel_times(
                lambda: int8_matvec(x, ws[next(it) % len(ws)], scale),
                lambda: int8_matvec_plain(x, ws[next(it) % len(ws)], scale),
                iters=20)
            # bytes: the weight, x, the scale and the fp32 output once
            n_bytes = f * k + 2 * b * k + 2 * f + 4 * b * f
            add_bound(t, bound(n_bytes, 2 * b * k * f), f"K4 {name}")
            t["library_ms"], label = library_matvec_ms(x, ws, scale, 20)
            per_weight[name.split("_B1")[0][3:]] = t
            line += (f" {fmt_times(t)} ({f * k / t['ms'] / 1e6:.1f} GB/s of "
                     f"weights); bound {t['bound_ms']:.4f} ms ("
                     f"{t['bound_by']}, {n_bytes / 1e6:.2f} MB), library "
                     f"{t['library_ms']:.4f} ms ({label})")
            del ws
        print(line)
        del x, w, scale, out, ref
    calls = 4 * layers + 1
    token = {key: layers * sum(per_weight[n][key] for n, _, _ in
                               K4_SHAPES_7B[:4]) + per_weight["lm_head"][key]
             for key in TIME_KEYS}
    avg = {key: token[key] / calls for key in TIME_KEYS}
    avg["bound_by"] = "bytes"
    avg["library_call"] = label
    print(f"K4 int8_matvec per decode token ({calls} calls: {layers} x "
          f"wqkv, wo, w_gateup, w_down, then lm_head): device "
          f"{token['ms']:.4f} ms vs plain {token['plain_ms']:.4f} ms; bound "
          f"{token['bound_ms']:.4f} ms; library {token['library_ms']:.4f} ms "
          f"({label})")
    return err_max, avg


def decode_int8_cases(gen, smax_7b: int, prompt_len: int, bucket: int,
                      layers: int = 32, heads: int = 32, model: str = "7b"):
    """(name, q, k, k_scale, v, v_scale, li, valid, hole): int8 caches
    quantized by the port's `_quantize_kv` from N(0, 1) bf16 K/V, as decode
    writes them; the decode shape of a model with ``layers`` layers and
    ``heads`` heads of 128 first, with the hole [prompt_len, bucket) that
    decode leaves in the mask."""
    from valley_tpu_torch.models.llama import _quantize_kv

    def make(n_layers, b, smax, h, hkv, d):
        q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
        out = [q]
        for _ in range(2):
            x = torch.randn((n_layers * b, smax, hkv, d), generator=gen,
                            device="cuda").bfloat16()
            xq, xs = _quantize_kv(x)
            out += [xq.reshape(n_layers, b, smax, hkv, d),
                    xs.reshape(n_layers, b, smax, hkv)]
        return out

    cases = []
    t = make(layers, 1, smax_7b, heads, heads, 128)
    valid = torch.zeros((1, smax_7b), dtype=torch.bool, device="cuda")
    valid[:, :prompt_len] = True               # the prompt
    valid[:, bucket:bucket + 40] = True        # 40 decoded tokens
    cases.append((f"{model}_decode_L{layers}_H{heads}_S{smax_7b}_D128_hole",
                  *t, 17, valid, (prompt_len, bucket)))
    for name, geo in (("gqa_rep2_D64", (3, 1, 200, 8, 4, 64)),
                      ("gqa_rep4_D128", (3, 1, 300, 16, 4, 128)),
                      ("batch2_S640_D128", (3, 2, 640, 8, 8, 128))):
        t = make(*geo)
        valid = torch.rand((geo[1], geo[2]), generator=gen,
                           device="cuda") < 0.8
        valid[:, :4] = True
        cases.append((name, *t, 1, valid, None))
    return cases


def k3_int8_phase(cases) -> tuple:
    """K3's int8-cache branch against its plain version on ``cases``
    (`decode_int8_cases`); planted faults (the V scales taken as ones, and
    the hole attended) on the first case, a model's decode shape, which is
    timed walking its layers.  Returns (max error, times)."""
    from valley_tpu_torch.ops.decode_attention import (
        decode_attention_plain, decode_attention_stacked)

    err_max, times = 0.0, None
    for name, q, k, ks, v, vs, li, valid, hole in cases:
        out = decode_attention_stacked(q, k, v, li, valid, ks, vs)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k, v, li, valid, ks, vs)
        err, tol = max_err(out, ref), tolerance(ref)
        check(bool(torch.isfinite(out.float()).all()),
              f"K3-int8 {name}: not finite")
        check(err <= tol, f"K3-int8 {name}: max abs err {err} > {tol}")
        err_max = max(err_max, err)
        line = (f"K3-int8 decode_attn_int8 {name}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
        if hole is not None:
            # planted faults: a kernel that ignored the V scales, or one
            # that attended the hole, must fail the check
            fault = max_err(decode_attention_stacked(
                q, k, v, li, valid, ks, torch.ones_like(vs)), ref)
            check(fault > tol, f"K3-int8 {name}: V scales of one moved the "
                  f"output by {fault} only, within the tolerance {tol}")
            filled = valid.clone()
            filled[:, hole[0]:hole[1]] = True
            hole_fault = max_err(decode_attention_stacked(
                q, k, v, li, filled, ks, vs), ref)
            check(hole_fault > tol, f"K3-int8 {name}: attending the hole "
                  f"moved the output by {hole_fault} only")
            line += (f"; V scales of one instead: {fault:.3e}, attending "
                     f"the hole instead: {hole_fault:.3e} (must fail)")
            n_layers = k.shape[0]
            it = iter(range(10 ** 9))
            times = kernel_times(
                lambda: decode_attention_stacked(
                    q, k, v, next(it) % n_layers, valid, ks, vs),
                lambda: decode_attention_plain(
                    q, k, v, next(it) % n_layers, valid, ks, vs), iters=64)
            _, b_, _, hkv_, d_ = k.shape
            n_valid = int(valid.sum())
            # the data's need: the valid slots' int8 K and V and their bf16
            # scales, q, out, the mask
            need = (2 * n_valid * hkv_ * d_ + 2 * n_valid * hkv_ * 2
                    + 2 * q.numel() * q.element_size() + valid.numel())
            add_bound(times, bound(need, 4 * d_ * n_valid * q.shape[2]),
                      f"K3-int8 {name}")
            # yardstick: SDPA over the same layer dequantized to bf16
            kd, vd = ((c[li].float() * s[li].float()[..., None]).bfloat16()
                      for c, s in ((k, ks), (v, vs)))
            times["library_ms"] = library_attention_ms(q, kd, vd, valid,
                                                       False, iters=64)
            times["library_call"] = "SDPA over the layer in bf16"
            layer_bytes = 2 * k[0].numel() + 2 * ks[0].numel() * 2
            line += (f" {fmt_times(times)} ({layer_bytes / 1e6:.2f} MB of "
                     f"K/V and scales per call: "
                     f"{layer_bytes / times['ms'] / 1e6:.1f} GB/s); bound "
                     f"{times['bound_ms']:.4f} ms ({times['bound_by']}, "
                     f"{need / 1e6:.2f} MB of valid slots), library "
                     f"{times['library_ms']:.4f} ms (SDPA over the layer in "
                     f"bf16)")
            del kd, vd
        print(line)
        del q, k, v, ks, vs, out, ref
    return err_max, times


def bench_request(cfg, bucket: int):
    """bench.py's request: 8 raw uint8 frames and a 473-token prompt (the
    media span, then random text) in the ``bucket``."""
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    rng = np.random.default_rng(0)
    prompt = [1] + span + rng.integers(
        5, 30000, size=bucket - len(span) - 40).tolist()
    size = cfg.vision.image_size
    frames = rng.integers(0, 256, (1, 8, 3, size, size)).astype(np.uint8)
    return prompt, frames


def serve_slice(tag: str, cfg, params, smi: str, cache_dtype,
                kernels: dict, logit_tol: float, same_token: bool) -> dict:
    """One `bench_request` through ``Engine.generate_tokens`` (64 greedy
    tokens, one stream), after a warm-up request.  ``kernels`` maps a
    label to (wrapper, launches the request must make): every count is set
    to 0 just before the request and read just after.  Then the breakdown
    (profiled prefill and request) and the logits through the kernels
    against the same path on the plain versions, at the prefill and three
    teacher-forced decode steps, within ``logit_tol`` and, with
    ``same_token``, picking the same greedy token.  Returns the counts."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.attention import PLAIN

    bucket, new = 512, NEW_TOKENS
    steps = new - 1
    prompt, frames = bench_request(cfg, bucket)
    size = cfg.vision.image_size
    gcfg = GenerationConfig(max_new_tokens=new, do_sample=False)
    engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                    steps_per_call=steps, cache_dtype=cache_dtype)

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
    for fn, _ in kernels.values():
        fn.launches = 0
    t_first, total, toks = run()           # the main path
    counts = {k: fn.launches for k, (fn, _) in kernels.items()}
    check(len(toks) == new, f"{tag}: generated {len(toks)} tokens, want "
          f"{new}")
    check(all(0 <= t < cfg.text.vocab_size for t in toks),
          f"{tag}: token ids")
    for k, (_, want) in kernels.items():
        check(counts[k] == want, f"{tag}: {k} launched {counts[k]} times, "
              f"want {want}")
    decode_tps = (new - 1) / (total - t_first)
    print(f"{tag}: prompt {len(prompt)} tokens in bucket {bucket}, 8 frames "
          f"{size}px uint8, {new} greedy tokens, {cache_dtype} KV cache; "
          f"launches " + " ".join(f"{k} {n}" for k, n in counts.items()))
    print(f"{tag}: video->first-token {t_first:.4f} s, decode "
          f"{decode_tps:.2f} tok/s ({1e3 / decode_tps:.3f} ms/token) on "
          f"{smi}")

    # where the time goes: device busy time of the prefill and of a whole
    # request, against the unprofiled wall times above
    frames_dev = torch.from_numpy(frames).cuda()
    vision_ms = time_ms(lambda: valley.encode_images(params, cfg, frames_dev),
                        iters=3, warmup=1)
    vision_dev, _, _ = profile_device(
        lambda: valley.encode_images(params, cfg, frames_dev))
    prefill_dev, prefill_top, _ = profile_device(
        lambda: engine.prefill([prompt], frames, gcfg))
    run_dev, top, _ = profile_device(run)
    decode_dev = (run_dev - prefill_dev) / (new - 1)
    wall_tok = (total - t_first) / (new - 1) * 1e3
    shares = ", ".join(f"{name[:48]} {100 * ms / run_dev:.1f}%"
                       for name, ms in top[:8])
    print(f"{tag} breakdown: video->first-token wall {t_first * 1e3:.2f} ms, "
          f"prefill device {prefill_dev:.2f} ms (vision tower device "
          f"{vision_dev:.2f} ms, wall {vision_ms:.2f} ms); decode wall "
          f"{wall_tok:.3f} ms/token, device busy {decode_dev:.3f} ms/token "
          f"(idle share {1 - decode_dev / wall_tok:.3f}); request device "
          f"busy {run_dev:.2f} ms of {total * 1e3:.2f} ms wall; top kernels: "
          f"{shares}")
    print(f"{tag} breakdown: prefill top kernels: " + ", ".join(
        f"{name[:48]} {ms:.2f} ms" for name, ms in prefill_top[:8]))
    inside = []
    for k in kernels:
        ms = sum(t for name, t in top
                 if any(key in name for key in KERNEL_NAMES[k]))
        inside.append(f"{k} {ms:.2f} ms ({100 * ms / run_dev:.1f}%, "
                      f"{1e3 * ms / max(counts[k], 1):.2f} us per launch)")
    print(f"{tag} breakdown: the kernels inside the request: "
          + ", ".join(inside))

    # the slice's logits through the kernels against the same path on the
    # plain versions: the prefill, then decode steps fed the generated
    # tokens
    plain_engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                          steps_per_call=steps, cache_dtype=cache_dtype,
                          attention=PLAIN)
    states = [e.prefill([prompt], frames, gcfg)
              for e in (engine, plain_engine)]
    check(int(states[0].token[0]) == toks[0], f"{tag}: prefill is not "
          "repeatable")
    forced = toks[:DECODE_CHECK_STEPS]
    logits = [[s.logits[0]] + decode_logits(e, s, len(prompt), forced)
              for e, s in zip((engine, plain_engine), states)]
    for i, (lk, lp) in enumerate(zip(*logits)):
        where = "prefill" if i == 0 else f"decode step {i}"
        check(bool(torch.isfinite(lk).all())
              and lk.shape == (cfg.text.vocab_size,),
              f"{tag}: {where} logits not finite or misshapen")
        diff = max_err(lk, lp)
        top2 = torch.topk(lp, 2).values
        margin = (top2[0] - top2[1]).item()
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"{tag}: {where} logits kernels vs plain max abs diff "
              f"{diff:.4e} (tol {logit_tol}; max |logit| "
              f"{lp.abs().max().item():.3f}), greedy token "
              f"{'agrees' if same else 'differs'} (plain top-2 margin "
              f"{margin:.4f}){'' if same_token else ', not checked'}")
        check(diff <= logit_tol, f"{tag}: {where} logits beyond tolerance")
        if same_token:
            check(same, f"{tag}: {where}: kernels and plain pick different "
                  f"tokens")
    del engine, plain_engine, states, logits, frames_dev
    return counts


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
            out.append(llama.logits_from_hidden(p, hidden,
                                                engine.attention)[0, 0])
    return out


def k1_phase(cases) -> tuple:
    """K1 against its plain version on ``cases`` (`flash_cases`), the
    first timed.  Returns (max error, times)."""
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)

    k1_err, k1_t = 0.0, None
    for name, q, k, v, mask, causal in cases:
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
            add_bound(k1_t, attention_bound(q, k, mask, causal, 2,
                                            lse.numel() * 4), f"K1 {name}")
            k1_t["library_ms"] = library_attention_ms(q, k, v, mask, causal,
                                                      iters=20)
            line += (f" {fmt_times(k1_t)}; bound {k1_t['bound_ms']:.4f} ms "
                     f"({k1_t['bound_by']}), library {k1_t['library_ms']:.4f}"
                     f" ms")
        print(line)
    return k1_err, k1_t


def k3_phase(gen, smax: int, prompt_len: int, bucket: int) -> tuple:
    """K3 (bf16 cache) against its plain version on `decode_cases`, with
    the planted fault; the 7B case timed walking its layers.  Returns (max
    error, times)."""
    from valley_tpu_torch.ops.decode_attention import (
        decode_attention_plain, decode_attention_stacked)

    k3_err, k3_t = 0.0, None
    for name, q, k, v, li, valid, hole in decode_cases(gen, smax, prompt_len,
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
            add_bound(k3_t, bound(need, 4 * d_ * int(valid.sum())
                                  * q.shape[2]), f"K3 {name}")
            k3_t["library_ms"] = library_attention_ms(
                q, k[li], v[li], valid, False, iters=64)
            line += (f" {fmt_times(k3_t)} ({kv_bytes / 1e6:.2f} MB of K/V "
                     f"per call: {kv_bytes / k3_t['ms'] / 1e6:.1f} GB/s of "
                     f"the card's 3350); bound {k3_t['bound_ms']:.4f} ms "
                     f"({k3_t['bound_by']}, {need / 1e6:.2f} MB of valid "
                     f"slots), library {k3_t['library_ms']:.4f} ms")
        print(line)
        del k, v
    return k3_err, k3_t


def random_weights(cfg, model: str = "valley_7b"):
    """The model's random bf16 weights on the card, from seed 0."""
    from valley_tpu_torch.models import valley

    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"{model} random bf16 weights: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params in {time.perf_counter() - t0:.1f} s")
    return params


K1_SRC = dict(name="flash_fwd", route="cuda",
              source="valley_tpu_torch/csrc/flash_fwd.cu",
              replaces="valley_tpu/ops/flash_attention.py:54")
K3_SRC = dict(route="cuda", source="valley_tpu_torch/csrc/decode_attn.cu",
              replaces="valley_tpu/ops/decode_pallas.py:68")


def serve_path(smi: str, gen) -> list:
    """The bf16 serving path: K1 and K3 against their plain versions, then
    the slice.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec

    k1_err, k1_t = k1_phase(flash_cases(gen))
    k3_err, k3_t = k3_phase(gen, SMAX, PROMPT_LEN, BUCKET)
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers, steps = cfg.text.num_hidden_layers, NEW_TOKENS - 1
    k6_err, k6_t, _ = k6_phase(gen, K6_SHAPES_SERVE, 1, layers)
    counts = serve_slice("slice", cfg, random_weights(cfg), smi,
                         torch.bfloat16, {
                             "K1": (flash_attention, layers),
                             "K3": (decode_attention_stacked, layers * steps),
                             "K6": (bf16_matvec, 7 * layers * steps
                                    + NEW_TOKENS),
                             "K4": (int8_matvec, 0)}, LOGIT_TOL,
                         same_token=True)
    return [{**K1_SRC, "path": "serve", "launches": counts["K1"],
             "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn", "path": "serve",
             "launches": counts["K3"], "max_abs_err": k3_err, **k3_t},
            {**K6_SRC, "name": "bf16_matvec_serve", "path": "serve",
             "launches": counts["K6"], "max_abs_err": k6_err, **k6_t}]


def serve_int8_path(smi: str, gen) -> list:
    """The int8 serving flagship: K1 at the prefill shape, K4 and K3's
    int8-cache branch against their plain versions, then the slice on the
    same random weights fused and quantized to int8a8 on the card, with an
    int8 KV cache.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec, quantize_llama_params

    k1_err, k1_t = k1_phase(flash_cases(gen)[:1])
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers, steps = cfg.text.num_hidden_layers, NEW_TOKENS - 1
    k4_err, k4_t = k4_phase(gen, layers)
    k3q_err, k3q_t = k3_int8_phase(decode_int8_cases(gen, SMAX, PROMPT_LEN,
                                                     BUCKET))
    gc.collect()
    torch.cuda.empty_cache()
    params = random_weights(cfg)
    t0 = time.perf_counter()
    params = quantize_llama_params(fuse_llama_params(params), act8=True)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for n, p in
                       params["llama"].named_parameters() if n != "embed")
    print(f"int8 slice: fused and quantized (int8a8) in "
          f"{time.perf_counter() - t0:.1f} s; decoder and lm_head weights "
          f"{weight_bytes / 1e9:.3f} GB (a decode token reads them once: "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)")
    counts = serve_slice("int8 slice", cfg, params, smi, torch.int8, {
        "K1": (flash_attention, layers),
        "K3-int8": (decode_attention_stacked, layers * steps),
        "K4": (int8_matvec, 4 * layers * steps + NEW_TOKENS),
        "K6": (bf16_matvec, 0)}, INT8_LOGIT_TOL, same_token=False)
    return [{**K1_SRC, "name": "flash_fwd_int8", "path": "serve_int8",
             "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn_int8", "path": "serve_int8",
             "launches": counts["K3-int8"], "max_abs_err": k3q_err,
             **k3q_t},
            {"name": "int8_matvec", "route": "cuda",
             "source": "valley_tpu_torch/csrc/int8_matvec.cu",
             "replaces": "valley_tpu/ops/quant.py:455", "path": "serve_int8",
             "launches": counts["K4"], "max_abs_err": k4_err, **k4_t}]


def int4_weight(gen, f: int, k: int, group: int):
    """An (F, K/2) packed int4 weight and its (F, K/group) bf16 scales (per
    channel (F,) for group 0), quantized by the port's quantizer from
    N(0, 1) / sqrt(K) bf16 values, as the serving tree's random weights
    are."""
    from valley_tpu_torch.ops.quant import pack_int4, quantize_tensor

    w = torch.randn((f, k), generator=gen, device="cuda") * k ** -0.5
    q, scale = quantize_tensor(w.bfloat16(), bits=4, group_size=group)
    return pack_int4(q), scale


def library_int4_matvec_ms(x, w, scale, copies: int, iters: int,
                           ref) -> tuple:
    """Device ms of one library call on K5's inputs, walking ``copies``
    copies of the weight as the kernel's timing does, and its label: torch's
    int4 weight-only product (``_weight_int4pack_mm``, group 128, zero
    points 0, a per-channel scale repeated over the groups) on the same
    values in its own packing.  A yardstick only: the port never calls it.
    Returns (None, why) where this torch does not run it on the card."""
    from valley_tpu_torch.ops.quant import unpack_int4

    f, k = w.shape[0], x.shape[1]
    try:
        u = unpack_int4(w).to(torch.int32) + 8       # [0, 15], zero point 8
        packed = torch._convert_weight_to_int4pack(
            (u[:, 0::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
        s = scale.reshape(f, -1).repeat_interleave(
            k // 128 // scale.reshape(f, -1).shape[1], dim=1)
        sz = torch.stack((s.t(), torch.zeros_like(s.t())), dim=-1)
        out = torch._weight_int4pack_mm(x, packed, 128, sz.contiguous())
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        why = str(e).splitlines()[0][:100]
        print(f"K5 yardstick: torch._weight_int4pack_mm does not run here "
              f"({why}): library time none")
        return None, f"none: {why}"
    ps = [packed] + [packed.clone() for _ in range(copies - 1)]
    it = iter(range(10 ** 9))
    fn = lambda: torch._weight_int4pack_mm(  # noqa: E731
        x, ps[next(it) % len(ps)], 128, sz)
    ms = profile_device(fn, iters)[0]
    label = (f"torch._weight_int4pack_mm, max abs diff from the plain "
             f"version {max_err(out, ref):.3e}")
    return ms, label


# Valley-13B's fused int4gp serving weights, (name, K, F, group): the decode
# GEMVs of one layer at group 128, then the per-channel lm_head
K5_SHAPES_13B = (("wqkv", 5120, 15360, 128), ("wo", 5120, 5120, 128),
                 ("w_gateup", 5120, 27648, 128), ("w_down", 13824, 5120, 128),
                 ("lm_head", 5120, 32000, 0))


def k5_phase(gen, layers: int) -> tuple:
    """K5 against its plain version on the five Valley-13B weights at B =
    1, at the row limit with G = 108 and on 7B's G = 86 at an odd F; a
    planted fault (the group scales shifted by one group); each 13B weight
    timed walking copies of it past the 50 MB L2.  Returns (max error,
    times per call averaged over one decode token's GEMVs: ``layers`` x the
    four layer weights, then lm_head)."""
    from valley_tpu_torch.ops.quant import (MAX_ROWS, int4_matvec,
                                            int4_matvec_plain)

    cases = [(f"13b_{n}_B1", 1, k, f, g) for n, k, f, g in K5_SHAPES_13B] + [
        ("rows8_K13824_G108", MAX_ROWS, 13824, 5120, 128),
        ("B3_K11008_G86_F1001", 3, 11008, 1001, 128)]
    err_max, per_weight, label = 0.0, {}, None
    for name, b, k, f, group in cases:
        x = torch.randn((b, k), generator=gen, device="cuda").bfloat16()
        w, scale = int4_weight(gen, f, k, group)
        out = int4_matvec(x, w, scale)
        torch.cuda.synchronize()
        ref = int4_matvec_plain(x, w, scale)
        err, tol = max_err(out, ref), tolerance(ref)
        check(out.dtype == torch.float32 and tuple(out.shape) == (b, f)
              and bool(torch.isfinite(out).all()),
              f"K5 {name}: dtype, shape or not finite")
        check(err <= tol, f"K5 {name}: max abs err {err} > {tol}")
        err_max = max(err_max, err)
        line = f"K5 int4_matvec {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
        if name == "13b_wqkv_B1":
            # planted fault: a kernel that read each group's scale from the
            # group before must fail the check
            fault = max_err(int4_matvec(x, w, scale.roll(1, dims=1)
                                        .contiguous()), ref)
            check(fault > tol, f"K5 {name}: shifted group scales moved the "
                  f"output by {fault} only, within the tolerance {tol}")
            line += f"; scales shifted by one group instead: {fault:.3e} "\
                "(must fail)"
        if name.startswith("13b_"):
            # copies of the weight, walked in turn, far past the 50 MB L2
            n = -(-TIMING_BYTES // w.numel())
            ws = [w] + [w.clone() for _ in range(n - 1)]
            it = iter(range(10 ** 9))
            t = kernel_times(
                lambda: int4_matvec(x, ws[next(it) % len(ws)], scale),
                lambda: int4_matvec_plain(x, ws[next(it) % len(ws)], scale),
                iters=20)
            del ws
            # bytes: the packed weight, x, the scales and the fp32 output
            # once
            n_bytes = w.numel() + 2 * b * k + 2 * scale.numel() + 4 * b * f
            add_bound(t, bound(n_bytes, 2 * b * k * f), f"K5 {name}")
            t["library_ms"], label = library_int4_matvec_ms(x, w, scale, n,
                                                            20, ref)
            per_weight[name.split("_B1")[0][4:]] = t
            lib = "none" if t["library_ms"] is None else \
                f"{t['library_ms']:.4f} ms"
            line += (f" {fmt_times(t)} ({w.numel() / t['ms'] / 1e6:.1f} GB/s "
                     f"of packed weights); bound {t['bound_ms']:.4f} ms ("
                     f"{t['bound_by']}, {n_bytes / 1e6:.2f} MB), library "
                     f"{lib} ({label})")
        print(line)
        del x, w, scale, out, ref
    calls = 4 * layers + 1
    token = {key: None if any(t[key] is None for t in per_weight.values())
             else layers * sum(per_weight[n][key] for n, *_ in
                               K5_SHAPES_13B[:4]) + per_weight["lm_head"][key]
             for key in TIME_KEYS}
    avg = {key: None if v is None else v / calls for key, v in token.items()}
    avg["bound_by"] = "bytes"
    avg["library_call"] = label
    lib = "none" if token["library_ms"] is None else \
        f"{token['library_ms']:.4f} ms"
    print(f"K5 int4_matvec per decode token ({calls} calls: {layers} x "
          f"wqkv, wo, w_gateup, w_down, then lm_head): device "
          f"{token['ms']:.4f} ms vs plain {token['plain_ms']:.4f} ms; bound "
          f"{token['bound_ms']:.4f} ms; library {lib}")
    return err_max, avg


def serve_int4_path(smi: str, gen) -> list:
    """Valley-13B served int4gp, the JAX package's one-card 13B setup
    (bench.py:216-231,272-274; worker --quantize int4gp --fused --kv-cache
    int8): K5, and K1 and K3-int8 at the 13B shapes, against their plain
    versions, then the slice on random weights fused and quantized on the
    card (group-128 scales, nibble-packed), with an int8 KV cache.  Returns
    its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_13b
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import (int4_matvec, int8_matvec,
                                            parse_quant_mode,
                                            quantize_llama_params)

    cfg = valley_13b(tokens=SpecialTokens(**BENCH_TOKENS))
    text = cfg.text
    layers, steps = text.num_hidden_layers, NEW_TOKENS - 1
    k5_err, k5_t = k5_phase(gen, layers)
    k1_err, k1_t = k1_phase(flash_cases(gen, text.num_attention_heads,
                                        "13b")[:1])
    k3q_err, k3q_t = k3_int8_phase(decode_int8_cases(
        gen, SMAX, PROMPT_LEN, BUCKET, layers, text.kv_heads, "13b")[:1])
    gc.collect()
    torch.cuda.empty_cache()
    params = random_weights(cfg, "valley_13b")
    t0 = time.perf_counter()
    knobs = parse_quant_mode("int4gp")
    params = quantize_llama_params(fuse_llama_params(params),
                                   bits=knobs["bits"],
                                   group_size=knobs["group_size"])
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for n, p in
                       params["llama"].named_parameters() if n != "embed")
    print(f"int4 slice: fused and quantized (int4gp) in "
          f"{time.perf_counter() - t0:.1f} s; decoder and lm_head weights "
          f"{weight_bytes / 1e9:.3f} GB (a decode token reads them once: "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)")
    counts = serve_slice("int4 slice", cfg, params, smi, torch.int8, {
        "K1": (flash_attention, layers),
        "K3-int8": (decode_attention_stacked, layers * steps),
        "K5": (int4_matvec, 4 * layers * steps + NEW_TOKENS),
        "K4": (int8_matvec, 0), "K6": (bf16_matvec, 0)}, INT4_LOGIT_TOL,
        same_token=True)
    return [{**K1_SRC, "name": "flash_fwd_int4", "path": "serve_int4",
             "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn_int4", "path": "serve_int4",
             "launches": counts["K3-int8"], "max_abs_err": k3q_err,
             **k3q_t},
            {"name": "int4_matvec", "route": "cuda",
             "source": "valley_tpu_torch/csrc/int4_matvec.cu",
             "replaces": "tools/exp_int4_group.py:91", "path": "serve_int4",
             "launches": counts["K5"], "max_abs_err": k5_err, **k5_t}]


K6_SRC = dict(name="bf16_matvec", route="cuda",
              source="valley_tpu_torch/csrc/bf16_matvec.cu",
              replaces="tools/exp_pallas_gemv.py:37")
# Valley-7B's bf16 decode GEMVs, (name, K, F, (K, F) layout, calls per
# layer, 0 for lm_head's one call per step): the unfused serving path's and
# the fused batched path's
K6_SHAPES_SERVE = (("wq_wk_wv_wo", 4096, 4096, False, 4),
                   ("w_gate_w_up", 4096, 11008, False, 2),
                   ("w_down", 11008, 4096, False, 1),
                   ("lm_head", 4096, 32000, True, 0))
K6_SHAPES_FUSED = (("wqkv", 4096, 12288, False, 1),
                   ("wo", 4096, 4096, False, 1),
                   ("w_gateup", 4096, 22016, False, 1),
                   ("w_down", 11008, 4096, False, 1),
                   ("lm_head", 4096, 32000, True, 0))
GEMV_NAMES = ("int8_matvec", "int4_matvec", "bf16_matvec",
              "bf16_matvec_serve", "bf16_matvec_round")


def bf16_weight(gen, k: int, f: int, kf: bool) -> torch.Tensor:
    """A bf16 weight of N(0, 1) / sqrt(K) values, (K, F) with ``kf``, else
    (F, K), as the serving tree's random weights are."""
    w = torch.randn((k, f) if kf else (f, k), generator=gen, device="cuda")
    return (w * k ** -0.5).bfloat16()


def library_linear_ms(x, ws, kf: bool, iters: int) -> float:
    """Device ms of one library bf16 product (cuBLAS) on K6's inputs,
    walking the weight copies ``ws`` as the kernel's timing does: ``x @ w``
    for a (K, F) weight, ``F.linear`` for an (F, K) one.  A yardstick
    only: the port takes it for more rows than K6 does."""
    it = iter(range(10 ** 9))
    if kf:
        fn = lambda: x @ ws[next(it) % len(ws)]  # noqa: E731
    else:
        fn = lambda: torch.nn.functional.linear(  # noqa: E731
            x, ws[next(it) % len(ws)])
    fn()
    return profile_device(fn, iters)[0]


def k6_phase(gen, shapes, rows: int, layers: int,
             round_products: bool = False) -> tuple:
    """K6 (``round_products``: its T3 variant) against its plain version on
    the weights ``shapes`` at ``rows`` rows, each timed walking copies of
    it past the 50 MB L2, with the library's bf16 product beside it.
    Returns (max error, times per call averaged over one decode step's
    GEMVs: ``layers`` x the layer weights, then lm_head, and the step's
    total times)."""
    from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain

    tag = f"K6 bf16_matvec{'_round' if round_products else ''}"
    err_max, per_weight = 0.0, {}
    for name, k, f, kf, _ in shapes:
        x = torch.randn((rows, k), generator=gen, device="cuda").bfloat16()
        w = bf16_weight(gen, k, f, kf)
        out = bf16_matvec(x, w, kf, round_products)
        torch.cuda.synchronize()
        ref = bf16_matvec_plain(x, w, kf, round_products)
        err, tol = max_err(out, ref), tolerance(ref)
        check(out.dtype == torch.float32 and tuple(out.shape) == (rows, f)
              and bool(torch.isfinite(out).all()),
              f"{tag} {name}: dtype, shape or not finite")
        check(err <= tol, f"{tag} {name} B{rows}: max abs err {err} > {tol}")
        err_max = max(err_max, err)
        ws = [w] + [w.clone() for _ in range(
            -(-TIMING_BYTES // (2 * w.numel())) - 1)]
        it = iter(range(10 ** 9))
        t = kernel_times(
            lambda: bf16_matvec(x, ws[next(it) % len(ws)], kf,
                                round_products),
            lambda: bf16_matvec_plain(x, ws[next(it) % len(ws)], kf,
                                      round_products), iters=10)
        # bytes: the weight, x and the fp32 output once; fp32 FMAs
        n_bytes = 2 * w.numel() + 2 * rows * k + 4 * rows * f
        add_bound(t, bound(n_bytes, 2 * rows * k * f, FP32_FLOP_PER_S),
                  f"{tag} {name}")
        t["library_ms"] = library_linear_ms(x, ws, kf, 10)
        per_weight[name] = t
        print(f"{tag} {name} B{rows} ({'(K, F)' if kf else '(F, K)'} "
              f"{k}x{f}): max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{fmt_times(t)} ({2 * w.numel() / t['ms'] / 1e6:.1f} GB/s of "
              f"weights); bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{n_bytes / 1e6:.2f} MB), library {t['library_ms']:.4f} ms "
              f"(cuBLAS bf16)")
        del ws, x, w, out, ref
    calls = sum(layers * c if c else 1 for *_, c in shapes)
    step = {key: sum(per_weight[n][key] * (layers * c if c else 1)
                     for n, *_, c in shapes) for key in TIME_KEYS}
    avg = {key: step[key] / calls for key in TIME_KEYS}
    avg["bound_by"] = "bytes"
    avg["library_call"] = "cuBLAS bf16 (F.linear, x @ w for (K, F))"
    avg["rows"] = rows
    print(f"{tag} per decode step at B{rows} ({calls} calls: {layers} x "
          f"{', '.join(sh[0] for sh in shapes if sh[-1])}, then lm_head): device "
          f"{step['ms']:.4f} ms vs plain {step['plain_ms']:.4f} ms; bound "
          f"{step['bound_ms']:.4f} ms; library {step['library_ms']:.4f} ms")
    return err_max, avg, step


def k6_checks(gen) -> float:
    """K6's planted fault at the fused wqkv shape and 8 rows (every row
    reading row 0's activations), its row independence (each row bit-equal
    to the same row alone) and odd F in both layouts.  Returns the max
    error of the odd-F cases."""
    from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain

    x = torch.randn((8, 4096), generator=gen, device="cuda").bfloat16()
    w = bf16_weight(gen, 4096, 12288, False)
    out = bf16_matvec(x, w)
    ref = bf16_matvec_plain(x, w)
    tol = tolerance(ref)
    fault = max_err(bf16_matvec(x[:1].expand(8, 4096).contiguous(), w), ref)
    check(fault > tol, f"K6: every row reading row 0's x moved the output by "
          f"{fault} only, within the tolerance {tol}")
    same = all(torch.equal(bf16_matvec(x[r:r + 1].contiguous(), w)[0],
                           out[r]) for r in range(8))
    check(same, "K6: a row's result depends on the other rows")
    err_max = 0.0
    for b, f, kf in ((3, 1001, False), (5, 1001, True)):
        xo = torch.randn((b, 4096), generator=gen, device="cuda").bfloat16()
        wo = bf16_weight(gen, 4096, f, kf)
        ro = bf16_matvec_plain(xo, wo, kf)
        err, tol_o = max_err(bf16_matvec(xo, wo, kf), ro), tolerance(ro)
        check(err <= tol_o, f"K6 odd F B{b} kf={kf}: max abs err {err}")
        err_max = max(err_max, err)
    print(f"K6 bf16_matvec checks: every row reading row 0's x instead: "
          f"{fault:.3e} (tol {tol:.3e}, must fail); rows 1-8 bit-equal to "
          f"each row alone; odd F 1001 at B3 (F, K) and B5 (K, F): max abs "
          f"err {err_max:.3e}")
    return err_max


# The probe's array: 2.15 GB of bf16, 43 times the 50 MB L2
READ_SHAPE = (2 ** 19, 2048)


def k7_phase(gen) -> dict:
    """K7 against its plain version on a 2.15 GB bf16 array of positive
    values, a planted fault (the last block of 2048 rows skipped, T8's
    default row block) that must fail, and the card's read rate: the
    array's bytes over K7's device time, beside torch.sum's.  Returns its
    entry's numbers."""
    from valley_tpu_torch.ops.read_bw import read_sum, read_sum_plain

    x = torch.empty(READ_SHAPE, dtype=torch.bfloat16, device="cuda")
    x.uniform_(0.0, 1.0, generator=gen)
    seed = torch.tensor([[0.5]], device="cuda")
    read_sum.launches = 0
    out = read_sum(x, seed)
    torch.cuda.synchronize()
    ref = read_sum_plain(x, seed)
    err = max_err(out, ref)
    tol = 1e-5 * ref.abs().item()
    check(bool(torch.isfinite(out).all()) and err <= tol,
          f"K7 read_sum: abs err {err} > {tol}")
    fault = max_err(read_sum(x[:-2048], seed), ref)
    check(fault > tol, f"K7: skipping the last block moved the sum by {fault} "
          f"only, within the tolerance {tol}")
    t = kernel_times(lambda: read_sum(x, seed),
                     lambda: read_sum_plain(x, seed), iters=10)
    n_bytes = 2 * x.numel()
    add_bound(t, bound(n_bytes, x.numel(), FP32_FLOP_PER_S), "K7 read_sum")
    t["library_ms"] = profile_device(
        lambda: torch.sum(x, dtype=torch.float32), 10)[0]
    t["library_call"] = "torch.sum(x, dtype=torch.float32)"
    t["read_gb_per_s"] = n_bytes / t["ms"] / 1e6
    t["library_read_gb_per_s"] = n_bytes / t["library_ms"] / 1e6
    t["max_abs_err"] = err
    t["launches"] = read_sum.launches
    print(f"K7 read_sum {READ_SHAPE[0]}x{READ_SHAPE[1]} bf16 "
          f"({n_bytes / 1e9:.3f} GB): abs err {err:.3e} (tol {tol:.3e}, sum "
          f"{ref.item():.6e}); the last block skipped instead: {fault:.3e} "
          f"(must fail); {fmt_times(t)}; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); library {t['library_ms']:.4f} ms")
    print(f"K7 read rate: {t['read_gb_per_s']:.1f} GB/s (torch.sum "
          f"{t['library_read_gb_per_s']:.1f} GB/s; datasheet 3350 GB/s)")
    del x
    return t


def flash_batch_case(gen):
    """K1 at the batched slice's admission prefill: four 473-token video
    prompts in the 512 bucket."""
    q, k, v = [torch.randn((4, 512, 32, 128), generator=gen, device="cuda")
               .bfloat16() for _ in range(3)]
    mask = torch.ones((4, 512), dtype=torch.bool, device="cuda")
    mask[:, PROMPT_LEN:] = False
    return ("7b_batch_prefill_B4_S512_H32_D128", q, k, v, mask, True)


def pool_decode_int8_case(gen, smax: int, layers: int = 32):
    """K3-int8 at the pool's shape: 8 rows of an int8 cache of ``smax``
    slots, quantized by `_quantize_kv` from N(0, 1) bf16 K/V, each row with
    its own valid length (6 video rows of 473 + 32 tokens, text rows of 40
    and 1500 + 32: decode writes right after the prompt, so no row has a
    hole); the 'hole' planted as a fault is [505, 1532), valid only in the
    last row."""
    from valley_tpu_torch.models.llama import _quantize_kv

    b, h, d = 8, 32, 128
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
    out = [q]
    for _ in range(2):
        c = torch.empty((layers, b, smax, h, d), dtype=torch.int8,
                        device="cuda")
        sc = torch.empty((layers, b, smax, h), dtype=torch.bfloat16,
                         device="cuda")
        for li in range(layers):
            c[li], sc[li] = _quantize_kv(torch.randn(
                (b, smax, h, d), generator=gen, device="cuda").bfloat16())
        out += [c, sc]
    lens = torch.tensor([505] * 6 + [72, 1532], device="cuda")
    valid = torch.arange(smax, device="cuda")[None, :] < lens[:, None]
    return (f"7b_pool_decode_L{layers}_B8_S{smax}_D128", *out, 17, valid,
            (505, 1532))


# batch_infer's defaults (valley_tpu/inference/batch_infer.py:272-287) at the
# kernels' 8 rows: buckets, the engine's max_new_tokens (the pool's extra
# slots), steps per decode chunk
BATCH_BUCKETS = (512, 1024, 2048)
BATCH_MAX_NEW = 256
BATCH_STEPS = 16
BATCH_ROWS = 8


def batch_requests(cfg) -> list:
    """The batched slice's traffic, made with numpy from seed 1: 8 video
    questions shaped as bench.py's (8 raw uint8 224-px frames of their own,
    a 473-token prompt: the media span, then random text) and 4 text
    prompts of 40, 200, 700 and 1500 tokens, those of 200 and 1500 sampled
    at temperature 0.7.  Returns [(prompt, frames or None, temperature)]."""
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    size = cfg.vision.image_size
    rng = np.random.default_rng(1)
    reqs = []
    for _ in range(8):
        prompt = [1] + span + rng.integers(
            5, 30000, size=PROMPT_LEN - 1 - len(span)).tolist()
        frames = rng.integers(0, 256, (1, 8, 3, size, size)).astype(np.uint8)
        reqs.append((prompt, frames, 0.0))
    for n, temp in ((40, 0.0), (200, 0.7), (700, 0.0), (1500, 0.7)):
        reqs.append(([1] + rng.integers(5, 30000, size=n - 1).tolist(), None,
                     temp))
    return reqs


def run_traffic(pool, reqs, new: int) -> tuple:
    """Submit every request at once and drain each queue in a thread of its
    own.  Returns ([(tokens, first-token s, last-token s)], wall s)."""
    import threading

    from valley_tpu_torch.inference.continuous import _drain

    results: list = [None] * len(reqs)
    t0 = time.perf_counter()
    queues = [pool.submit(p, f, temperature=t, max_new_tokens=new, eos_id=-1)
              for p, f, t in reqs]

    def consume(i, q):
        toks, first = [], None
        try:
            for tkn in _drain(q, timeout=600):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(tkn)
        except Exception as e:  # noqa: BLE001 -- reported by the check below
            results[i] = e
            return
        results[i] = (toks, first, time.perf_counter() - t0)

    threads = [threading.Thread(target=consume, args=(i, q), daemon=True)
               for i, q in enumerate(queues)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    for i, r in enumerate(results):
        check(isinstance(r, tuple), f"batch slice: request {i} failed: {r!r}")
    return results, wall


def pooled_logits(engine, pool, ids, frames, lens, feed=None) -> tuple:
    """The pool's fp32 logits (8, V) after a batched prefill of the 8 video
    prompts into a cache of the pool's ``smax`` slots, then at three
    teacher-forced pooled steps (per-row slots and positions at each row's
    length, as the pool decodes after compaction), fed ``feed`` or the
    greedy tokens of each step.  Returns (logits, the tokens fed)."""
    from valley_tpu_torch.models import llama

    dev = engine.device
    p, text = engine.params["llama"], engine.cfg.text
    with torch.inference_mode():
        zeros = torch.zeros(8, device=dev)
        tok, lg, cache, valid = engine._prefill(
            ids, engine._prepare_images(frames, 8), lens,
            torch.Generator(dev).manual_seed(0), zeros, zeros + 1, False,
            pool.smax)
        out, fed = [lg], []
        seq = lens.clone()
        rows = torch.arange(8, device=dev)
        for i in range(DECODE_CHECK_STEPS):
            t = feed[i] if feed is not None else out[-1].argmax(-1)
            fed.append(t)
            valid[rows, seq] = True
            hidden, _ = llama.forward_hidden(
                p, text, llama.embed(p, t[:, None]), positions=seq[:, None],
                cache=cache, cache_index=seq, kv_valid=valid,
                attention=engine.attention)
            out.append(llama.logits_from_hidden(p, hidden,
                                                engine.attention)[:, 0])
            seq = seq + 1
        del cache
    return out, fed


def batch_slice(cfg, params, smi: str) -> dict:
    """``batch_infer``'s configuration on Valley-7B: 12 requests at once
    through a `ContinuousEngine` of 8 rows (after a warm-up pair); the
    launches of K1, K3-int8 and K6 against the pool's count of prefills
    and pooled steps; aggregate tokens/s; the pooled step's device time and
    its kernels; the pooled logits against the plain versions; each greedy
    request's tokens against the same request alone.  Returns the
    counts."""
    from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.ops.attention import PLAIN
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int4_matvec, int8_matvec

    layers = cfg.text.num_hidden_layers
    engine = Engine(cfg, params, buckets=BATCH_BUCKETS,
                    max_new_tokens=BATCH_MAX_NEW, cache_dtype=torch.int8,
                    steps_per_call=BATCH_STEPS)
    pool = ContinuousEngine(engine, rows=BATCH_ROWS, admit_batch=4)
    check(pool.smax == 2048 + BATCH_MAX_NEW, f"pool smax {pool.smax}")
    reqs = batch_requests(cfg)
    # warm-up: lazy CUDA / cuBLAS initialisation at two admission buckets
    for q in (pool.submit(reqs[0][0], reqs[0][1], max_new_tokens=4,
                          eos_id=-1),
              pool.submit(reqs[10][0], max_new_tokens=4, eos_id=-1)):
        list(_drain(q, timeout=600))
    torch.cuda.synchronize()
    kernels = {"K1": flash_attention, "K3-int8": decode_attention_stacked,
               "K6": bf16_matvec, "K4": int8_matvec, "K5": int4_matvec}
    steps0, groups0 = pool.steps_run, len(pool.prefill_sizes)
    for fn in kernels.values():
        fn.launches = 0
    results, wall = run_traffic(pool, reqs, NEW_TOKENS)    # the main path
    counts = {k: fn.launches for k, fn in kernels.items()}
    steps = pool.steps_run - steps0
    groups = pool.prefill_sizes[groups0:]
    pool.close()
    for (toks, _, _), (p, f, t) in zip(results, reqs):
        check(len(toks) == NEW_TOKENS and all(
            0 <= x < cfg.text.vocab_size for x in toks),
            f"batch slice: a request gave {len(toks)} tokens or bad ids")
    check(sum(groups) == len(reqs), f"batch slice: admissions {groups}")
    want = {"K1": layers * len(groups), "K3-int8": layers * steps,
            "K6": (4 * layers + 1) * steps + len(groups), "K4": 0, "K5": 0}
    for k, n in want.items():
        check(counts[k] == n, f"batch slice: {k} launched {counts[k]} "
              f"times, want {n}")
    firsts = sorted(r[1] for r in results)
    n_tok = sum(len(r[0]) for r in results)
    print(f"batch slice: {len(reqs)} requests (8 video x 473 tokens + 8 "
          f"frames, text of 40/200/700/1500 tokens, 2 sampled), "
          f"{NEW_TOKENS} new tokens each, pool of {BATCH_ROWS} rows x "
          f"{pool.smax} slots (int8 cache); {len(groups)} admission prefills "
          f"of {groups} rows, {steps} pooled steps; launches " + " ".join(
              f"{k} {n}" for k, n in counts.items()))
    print(f"batch slice: aggregate {n_tok / wall:.2f} tok/s ({n_tok} tokens "
          f"in {wall:.3f} s wall), first tokens at {firsts[0]:.3f}-"
          f"{firsts[-1]:.3f} s, on {smi}")

    # the pooled step: 8 rows after a batched prefill of the video prompts
    video = reqs[:8]
    ids = torch.zeros((8, 512), dtype=torch.int64)
    for i, (p, _, _) in enumerate(video):
        ids[i, :len(p)] = torch.tensor(p)
    ids = ids.cuda()
    lens = torch.tensor([len(p) for p, _, _ in video], device="cuda")
    frames = np.concatenate([f for _, f, _ in video])
    with torch.inference_mode():
        tok, _, cache, valid = engine._prefill(
            ids, engine._prepare_images(frames, 8), lens,
            torch.Generator("cuda").manual_seed(0), torch.zeros(8,
                                                                device="cuda"),
            torch.ones(8, device="cuda"), False, pool.smax)
        pool._cache, pool._valid, pool._token = cache, valid, tok
        pool._slot, pool._seq = lens.clone(), lens.clone()
        pool._temps[:] = 0.0
        pool._decode_chunk(BATCH_STEPS)                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool._decode_chunk(BATCH_STEPS)
        torch.cuda.synchronize()
        wall_step = (time.perf_counter() - t0) / BATCH_STEPS * 1e3
        dev, top, _ = profile_device(lambda: pool._decode_chunk(BATCH_STEPS))
    dev_step = dev / BATCH_STEPS
    inside = []
    for k in ("K3-int8", "K6"):
        ms = sum(t for name, t in top
                 if any(key in name for key in KERNEL_NAMES[k]))
        inside.append(f"{k} {ms / BATCH_STEPS:.3f} ms ({100 * ms / dev:.1f}%)")
    print(f"batch slice breakdown: pooled step of 8 rows wall {wall_step:.3f} "
          f"ms, device busy {dev_step:.3f} ms (idle share "
          f"{1 - dev_step / wall_step:.3f}): " + ", ".join(inside)
          + "; top kernels: " + ", ".join(
              f"{name[:40]} {100 * ms / dev:.1f}%" for name, ms in top[:8]))
    pool._cache = cache = None
    gc.collect()
    torch.cuda.empty_cache()

    # the pooled logits: kernels against the plain versions
    plain_engine = Engine(cfg, params, buckets=BATCH_BUCKETS,
                          max_new_tokens=BATCH_MAX_NEW,
                          cache_dtype=torch.int8, steps_per_call=BATCH_STEPS,
                          attention=PLAIN)
    lk, fed = pooled_logits(engine, pool, ids, frames, lens)
    lp, _ = pooled_logits(plain_engine, pool, ids, frames, lens, fed)
    for i, (a, b) in enumerate(zip(lk, lp)):
        where = "batched prefill" if i == 0 else f"pooled step {i}"
        check(bool(torch.isfinite(a).all()) and a.shape == (
            8, cfg.text.vocab_size), f"batch slice: {where} logits")
        diff = max_err(a, b)
        top2 = torch.topk(b, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        print(f"batch slice: {where} logits (8 rows) kernels vs plain max abs "
              f"diff {diff:.4e} (tol {BATCH_LOGIT_TOL}; max |logit| "
              f"{b.abs().max().item():.3f}), greedy tokens agree in {agree} "
              f"of 8 rows (smallest plain top-2 margin {margin:.4f})")
        check(diff <= BATCH_LOGIT_TOL, f"batch slice: {where} logits beyond "
              "tolerance")
    del lk, lp, plain_engine

    # each greedy request against the same request alone (B = 1, kernels)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False)
    same = 0
    for i, ((toks, _, _), (p, f, t)) in enumerate(zip(results, reqs)):
        if t:
            continue
        alone = [int(x[0]) for x in engine.generate_tokens([p], f, gcfg,
                                                           eos_ids=[-1])]
        if alone == toks:
            same += 1
            continue
        step = next(j for j, (a, b) in enumerate(zip(alone, toks)) if a != b)
        state = engine.prefill([p], f, gcfg)
        lg = state.logits[0] if step == 0 else decode_logits(
            engine, state, len(p), alone[:step])[-1]
        top2 = torch.topk(lg, 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"batch slice: request {i} parts from its run alone at step "
              f"{step}, where the run alone's top-2 margin is {margin:.4f} "
              f"(bar {BATCH_MARGIN_BAR})")
        check(margin < BATCH_MARGIN_BAR, f"batch slice: request {i} parts "
              f"from its run alone at step {step} with margin {margin}")
    print(f"batch slice: {same} of 10 greedy requests give the tokens of "
          f"their run alone (Engine.generate_tokens, B = 1)")
    return counts


def serve_batch_path(smi: str, gen) -> list:
    """Batched serving, batch_infer's configuration: K7 (the card's read
    rate), K6 and its T3 variant at the fused Valley-7B shapes (rows 8 and
    1), K1 and K3-int8 at the pool's shapes, against their plain versions;
    then the slice on random Valley-7B bf16 weights, fused.  Returns its
    kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.matvec import bf16_matvec

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers = cfg.text.num_hidden_layers
    k7_t = k7_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    bf16_matvec.launches = 0
    k6_err, k6_t, _ = k6_phase(gen, K6_SHAPES_FUSED, BATCH_ROWS, layers)
    k6_err = max(k6_err, k6_phase(gen, K6_SHAPES_FUSED, 1, layers)[0],
                 k6_checks(gen))
    round_launches = bf16_matvec.launches
    k6r_err, k6r_t, _ = k6_phase(gen, K6_SHAPES_FUSED, BATCH_ROWS, layers,
                                 round_products=True)
    round_launches = bf16_matvec.launches - round_launches
    k1_err, k1_t = k1_phase([flash_batch_case(gen)])
    k3q_err, k3q_t = k3_int8_phase([pool_decode_int8_case(
        gen, 2048 + BATCH_MAX_NEW, layers)])
    gc.collect()
    torch.cuda.empty_cache()
    params = fuse_llama_params(random_weights(cfg))
    counts = batch_slice(cfg, params, smi)
    return [{**K1_SRC, "name": "flash_fwd_batch", "path": "serve_batch",
             "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn_int8_batch",
             "path": "serve_batch", "launches": counts["K3-int8"],
             "max_abs_err": k3q_err, **k3q_t},
            {**K6_SRC, "path": "serve_batch", "launches": counts["K6"],
             "max_abs_err": k6_err, **k6_t},
            {**K6_SRC, "name": "bf16_matvec_round",
             "replaces": "tools/exp_pallas_gemv2.py:73",
             "path": "serve_batch, GEMV phase only (not on the main path)",
             "launches": round_launches, "max_abs_err": k6r_err, **k6r_t},
            {"name": "read_sum", "route": "cuda",
             "source": "valley_tpu_torch/csrc/read_sum.cu",
             "replaces": "tools/exp_read_bw.py:64",
             "path": "serve_batch, read-rate phase", "bound_by": "bytes",
             **k7_t}]


def train_path(smi: str, gen) -> list:
    """K2 (and K1 at the training shape) against the plain versions, then
    the training slice.  Returns its kernels entries."""
    k2_err, k2_t, k1_train = k2_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    train_k1, train_k2 = train_phase(smi)
    return [{**K1_SRC, "name": "flash_fwd_train", "path": "train",
             "launches": train_k1, **k1_train},
            {"name": "flash_bwd", "route": "cuda",
             "source": "valley_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "valley_tpu/ops/flash_attention.py:183",
             "path": "train", "launches": train_k2, "max_abs_err": k2_err,
             **k2_t}]


# Each path runs in a process of its own, one after the other: each frees
# its model by exiting, and each gets a fresh profiler (on an H100 with
# torch 2.11, traces taken in one process after both serving paths came
# back short of events, then empty)
PATHS = {"serve": serve_path, "serve_batch": serve_batch_path,
         "serve_int8": serve_int8_path, "serve_int4": serve_int4_path,
         "train": train_path}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=sorted(PATHS),
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import valley_tpu_torch  # noqa: F401
        from valley_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a valley-tpu checkout "
              f"({e})", file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.path:
        entries = PATHS[args.path](nvidia_smi(),
                                   torch.Generator("cuda").manual_seed(0))
        check("jax" not in sys.modules, "the port imported jax")
        with open(args.out, "w") as f:
            json.dump(entries, f)
        return 0

    # the device, the build, then each path in a process of its own
    smi = nvidia_smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"build: {_build.build_all():.2f} s for {list(_build.SOURCES)}",
          flush=True)
    kernels = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in PATHS:
            out = f"{tmp}/{name}.json"
            t0 = time.perf_counter()
            subprocess.run([sys.executable, __file__, "--path", name,
                            "--out", out], check=True)
            print(f"path {name}: {time.perf_counter() - t0:.1f} s wall",
                  flush=True)
            with open(out) as f:
                kernels += json.load(f)
    # the decode GEMVs against the read rate K7 measured (the faster of
    # K7 and torch.sum on 2.15 GB): ``ceiling_bound_ms`` is the bound at
    # that rate, beside ``bound_ms`` at the datasheet's 3.35 TB/s
    probe = next(e for e in kernels if e["name"] == "read_sum")
    ceiling = max(probe["read_gb_per_s"], probe["library_read_gb_per_s"])
    for e in kernels:
        if e["name"] in GEMV_NAMES:
            e["ceiling_bound_ms"] = e["bound_ms"] * HBM_BYTES_PER_S / (
                ceiling * 1e9)
            print(f"{e['name']} ({e['path']}): device {e['ms']:.4f} ms per "
                  f"call, {e['bound_ms'] / e['ms']:.3f} of the bound at 3.35 "
                  f"TB/s, {e['ceiling_bound_ms'] / e['ms']:.3f} of the bound "
                  f"at the measured {ceiling:.1f} GB/s")
    # one entry per kernel and path: ``launches`` is that path's count
    # (serving: one request; batched serving: the 12 requests; training:
    # the three timed updates; the T3 variant and K7: their phases), the
    # times and bound are at the shape that path gives the kernel (K4, K5,
    # K6: per call, averaged over one decode step's GEMVs)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
