"""Smoke test of the PyTorch port (``valley_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the CUDA kernels from ``valley_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the Valley-7B and
Valley-13B paths give it (K1 and K3 before serving, K4 and K3's int8-cache
branch before int8 serving, K5 with K1 and K3-int8 at 13B shapes before
int4 serving, K2 before training, each with a planted fault that must fail
the check; K6, the bf16 decode GEMV, at the shapes of both bf16 serving
paths and K7, the read-bandwidth probe, on 2 GB before batched serving;
T4-T7, the decode-attention lab, on the conversation's cache; the decode
GEMVs K4, K5 and K6 also at a speculative verify round's 9 rows and at 16,
each row bit-equal to the same row alone; K8, the grouped W4A8 product, at
the 13B projections before the int4gpa8 request), and drives
the port's paths at full width with random bf16 weights from a seed, ten
processes one after the other; the serving paths' models at a quarter
of their depth (`SERVE_LAYERS`: Valley-7B at 8 of its 32 layers,
Valley-13B at 10 of its 40), the training paths' as each says:

- serving: one 8-frame video question with Valley-7B through
  ``Engine.generate_tokens``, its 63 decode steps one replay of a CUDA
  graph; checks that the path went through K1, K3 and K6 (every bf16
  decode product, lm_head included), that the eager step gives the
  graph's first 16 tokens and the launches of those steps (decode wall,
  device busy and idle share printed for both, with the capture's time
  and memory), that a sampled graph draws
  fresh numbers each replay and repeats them under a seed, and compares
  its logits at the prefill and at three decode steps with the same path
  run on the plain versions;
- batched serving, ``batch_infer``'s configuration: Valley-7B bf16 weights
  fused, an int8 KV cache, a ``ContinuousEngine`` of 16 rows taking 12
  requests at once (8 video questions, 4 text prompts of 40 to 1500
  tokens, two of them sampled), each pooled chunk one replay of a CUDA
  graph; checks the launches of K1, K3's int8 branch and K6 against the
  pool's own count of prefills and pooled steps, every greedy request's
  first 16 tokens against the same traffic through an eager pool
  (aggregate rate
  and the pooled step's wall, device busy and idle share printed for
  both), the pooled logits at three teacher-forced steps against the
  plain versions, and each greedy video request's tokens against the same
  request alone through ``Engine.generate_tokens``;
- int8 serving, the serving flagship of the JAX package: the same weights
  fused (``wqkv``, ``w_gateup``) and quantized to int8a8 on the card, an
  int8 KV cache, the same question (by graph, and by the eager step as on
  the bf16 path); checks that the path went through K1, K3's int8 branch
  and K4 (the int8 decode GEMV, lm_head included) and compares its logits
  with the same path on the plain versions;
- int4 serving, the JAX package's one-card Valley-13B setup: random
  Valley-13B weights fused and quantized to int4gp on the card (group-128
  scales, nibble-packed), an int8 KV cache, the same question (by graph,
  and by the eager step as on the bf16 path); checks that the path went
  through K1, K3's int8 branch and K5 (the grouped-int4 decode GEMV,
  lm_head included) and compares its logits with the same path on the
  plain versions;
- in the same process, on the same weights, the multi-turn video
  conversation (``ChatSession`` over an engine with batch_infer's buckets
  and max_new_tokens, a 2052-slot session cache): the video question, then
  two follow-ups framed as ``run_valley_conv`` frames them, 64 greedy
  tokens each; checks the launches of K1, K3-int8 and K5 against the
  session's own count of prefills, extends and decode steps and the
  session's valid mask, and prints per turn the time to first token, the
  prefill's or extend's device time and decode wall and device busy per
  token, beside re-prefilling the whole conversation; compares the logits
  at turn 2's extend and three teacher-forced decode steps with the plain
  versions; runs a session that must compact its cache (the packed slots
  checked bit for bit, turn 3's extend against the same extend
  uncompacted) and two ``PrefixCache`` spawns; then the decode-attention
  lab: T4 (head-major, 8 or 16 heads a block), T5 (one head a block), T6
  (T4 on the stacked cache) and T7 (the first K3's structure cut stage by
  stage, stages 0-4), with K3 and K3-int8 beside them, each held against
  its plain version with a planted fault and timed beside its bound and SDPA's
  forward, on the session's real cache and mask and at the TPU tools' shape
  (L32 S640 H32, 500 valid);
- speculative decoding, in the serving, int8 and int4 processes on the
  same weights: the request through ``SpecDecoder`` by graph (JAX's
  SpecConfig, the adaptive switch off so that every token comes from a
  verify round), 128 greedy tokens beside the plain graph: its tokens
  against the plain graph's (they may part only where the plain top-2
  margin is under the path's logit bar), its launches against its rounds,
  the first round's 9-row logits against the plain versions, a round's
  wall and device time against a plain step and the break-even; on the
  bf16 path also a sampled request repeated under its seed and bench.py's
  constant-filled Valley-7B, whose rounds accept every draft; on the int4
  path a follow-up turn through ``PrefixCache.spawn(speculative=True)``
  against the plain spawn's; in the batched process the 12 requests
  through ``ContinuousEngine(speculative=True)`` (launches, aggregate
  against the plain graph pool, acceptance, pauses, the first round's
  logits against the plain pool's first step);
- the serving stack, after the int8 path: Valley-7B's random bf16
  weights written as a sharded Hugging Face checkpoint (bytes, seconds,
  free disk) and read back by ``load_valley_checkpoint(quantize="int8a8",
  fused=True)`` (seconds, GB/s, peak device memory under the bf16 tree's,
  every tensor bit-equal to the same tree fused and quantized in memory);
  the port's controller and worker in the process on localhost ports (the
  JAX worker's 7B setup, one bucket and one frame bucket, warmed as
  ``--warmup`` warms it): a stateless request through the controller's
  proxy by the default ``SpecDecoder`` against the same call made
  directly (text, launches of K1, K3-int8 and K4 against the decoder's
  rounds and the engine's steps, first chunk and ms/token over HTTP
  against direct), three questions at once against each alone, a
  two-turn session against ``SpecChatSession``, the prefix cache against
  its spawn, the OpenAI route against the native one, and a pooled worker
  (the plain pool, int8a8, int8 cache) taking four requests at once, one
  a prefix hit, each against its run alone (parting only at near ties),
  with its launches against the pool's counters;
- training: Valley-7B stage 1 (frozen backbone, projector and input
  embeddings trained, the stage-1 recipe's optimizer settings; cut to 16
  of its 32 layers, at full width) through
  ``Trainer.train_step`` on 16 synthetic rows from the port's collator and
  loader; checks a falling loss, untouched frozen weights, K1 and K2
  launches per step, and the first step's loss and gradients against the
  same step on the plain attention functions; then, in the same process,
  stage 2 at batch 1 of 2048 tokens over synthetic video conversations
  written as the recipes' JSON: LoRA through ``Trainer`` (the first step
  and a later one against the plain attention functions, launches, the
  update's device time by kind with the adapter products, dropout masks
  and the layers' gradient stack as their own kinds, only adapters and
  projector moved, the steps eval's engine refilled in place against a
  fresh one), the LoRA recipe through the training entry point, its
  adapter merged (logits against the unmerged adapter forward, bench's
  request by graph from the merged tree, the generate-eval), full stage
  2 (peak memory under 80 GB), the same full stage 2 through the sharded
  path of ``parallel/`` at world 1 over NCCL (valley_stage2_zero3.yaml:
  every parameter after the updates bit-equal to the unsharded run's, K1
  and K2 launched inside), stage 1 at Valley-7B's width cut to 2 layers on
  two ranks of the one card over gloo against world 1 (the stage-1 bars),
  then the same two ranks as a (1, 1, 2) mesh, the model axis in training
  (stage 1 and full stage 2, each rank on 16 of the 32 heads, every
  trainable first-step gradient against world 1, each rank's K1 and K2
  launches), and K1 and K2 at those shapes against their plain versions;
- serving variants: K8, the grouped W4A8 product of prefill chunks, at
  Valley-13B's four fused projections at 512 and 128 rows against its
  plain version (bit-equal; a planted fault: the group scales shifted by
  one group), timed beside its bound and the library's int8 product
  looped over the groups and ungrouped, and at ragged rows and outputs
  with groups of 32, 64, 128 and 256 (bit-equal); K8q, the per-token
  activation quantization, bit-equal to its plain version on exact .5
  ties, zero rows, a subnormal absmax and the 13B widths, timed beside
  its bytes bound; both learned pooling variants at
  Valley-7B and 13B widths (8 frames, 256 patches, with and without a
  frame mask) on the card against the CPU; the CLIP tower over 8 frames
  in bf16, int8 and int8a8; then bench's request through Valley-13B with
  int4gpa8 weights (W4A8 prefill through K8, decode through K5), an
  int8a8 tower, transformer pooling and an int8 KV cache, by graph: the
  launches of K1, K3-int8, K5, K8 and K8q, first token and ms/token (printed
  beside the int4 path's int4gp request), the eager step's first 16
  tokens and launches against the graph's, the prefill's device time by
  kernel, and its logits against the plain versions; beside it every
  serving kernel (K1, K3 and its int8 branch, K4, K5, K6, K8, and K8q with
  a token's absmax over every rank's inputs) at the per-rank shapes of
  Valley-7B and 13B over 2 and 4 ranks, and K1 and K2 at the training
  shapes there, against its plain version;
- tensor parallelism in serving: two rank processes of this script on the
  one card over gloo (NCCL refuses two ranks on one device), a (1, 1, 2)
  mesh, Valley-7B's width cut to a few layers, fused bf16 and int8a8 with
  an int8 cache, against world 1 in the path's process on the same
  weights: logits at the prefill and three teacher-forced steps, greedy
  tokens, each rank's launches of K1, K3 and K6 or K4, and each rank's
  kernels against their plain versions on its own shares.

Then the card tests, ``tests/test_torch_cuda.py`` (each kernel against its
plain version at small shapes, the tiny models end to end), in a process
of their own; a failing test fails the script.

TF32 is off for matmuls and cuDNN, so fp32 references are fp32.  Every
phase prints its lines; a failed check raises and the script exits
non-zero.  The line before the last is a JSON object with one entry for
each kernel on each path: its launches on that path, error, device time
beside its plain version's, its bound and the library's time, at the shape
that path gives it (each decode GEMV also with the bound at the read rate
K7 measured; K1 and K2 also with their rate over the attended pairs and
their time over the library's); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# Kernel tolerance, relative to the reference output: max abs error <=
# REL_TOL * max|ref|, two bf16 ulps at the largest output.  Both sides
# compute in fp32 from the same bf16 inputs and round the output to bf16;
# they differ in summation order and, for decode, in where probabilities are
# rounded to bf16 (per chunk of slots in the kernel, after the global softmax
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
# twice that.  At the served depth (`SERVE_LAYERS`): 0.0371-0.0482.
LOGIT_TOL = 0.15
# The int8 slice's logits through the kernels (K1, K3-int8, K4) against the
# same path on their plain versions, at the prefill and three
# teacher-forced decode steps: the kernels' summation order and bf16
# roundings, through 32 layers of int8 weights, an int8 cache (a value
# moved across a rounding edge moves one int8 step) and W8A8 prefill.
# H100 readings of this script: 0.155 at the prefill (largest logit 4.16),
# 0.062 at the decode steps; the bar is about twice that (at the served
# depth: 0.118 and 0.041-0.049).  The same greedy
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
# 0.0743-0.0816 at the decode steps; the bar is about twice that (at the
# served depth: 0.0478-0.0490).
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
# 0.0770-0.0830 at the pooled steps; the bar is about twice that (at the
# served depth: 0.0448 and 0.0449-0.0468).
BATCH_LOGIT_TOL = 0.17
# A greedy request served in the pool may part from the same request
# served alone only where the alone run's top-2 logits lie closer than
# this: the two paths differ in summation order (batched prefill products,
# the decode slots' chunks), by about what the kernels and the plain
# versions differ on the serving slice (LOGIT_TOL's readings).
BATCH_MARGIN_BAR = 0.15
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 0.05
# The stage-1 slice's depth: Valley-7B's 32 layers cut to 16, at full width,
# since the sharded training phases were added, to keep the script inside
# its time (the bars above were read at 32 layers; at 8 layers the
# first-step loss read 3.45e-4 from the plain attention's, over
# TRAIN_LOSS_TOL: the bar reads rounding, ROADMAP.md §3)
TRAIN_LAYERS = 16
DECODE_CHECK_STEPS = 3
NEW_TOKENS = 64
# bench.py's request: a 473-token prompt in the 512 bucket; the engine's
# cache holds bucket + max_new_tokens + steps_per_call slots
PROMPT_LEN, BUCKET = 473, 512
SMAX = BUCKET + NEW_TOKENS + NEW_TOKENS - 1
# Profiler kernel names of each kernel of the serving paths
KERNEL_NAMES = {"K1": ("flash_fwd_kernel",),
                "K3": ("decode_attn_kernel", "decode_merge_kernel"),
                "K3-int8": ("decode_attn_kernel", "decode_merge_kernel"),
                "K4": ("int8_matvec_mma_kernel",),
                "K5": ("int4_matvec_mma_kernel",),
                "K6": ("bf16_matvec_mma_kernel", "bf16_matvec_kf_mma_kernel",
                       "bf16_matvec_kf_kernel"),
                "T4": ("t4_head_chunked_kernel",),
                "T5": ("t5_per_head_kernel",), "T6": ("t6_stacked_kernel",),
                "T7": ("t7_stage_kernel", "t7_combine_kernel")}
# Profiler kernel names by kind, for the training step's breakdown
KERNEL_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd", ("flash_bwd_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    # the offloaded optimizer's moments, on their own streams
    ("host-device copies", ("Memcpy HtoD", "Memcpy DtoH")),
    ("elementwise and reductions", ("elementwise", "reduce_kernel",
                                    "softmax", "index", "scatter", "gather",
                                    "cat", "copy", "Memcpy", "Memset")),
)
# The H100 SXM's published peaks (NVIDIA's datasheet): HBM bytes/s
# and dense bf16 tensor-core FLOP/s, for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# fp32 on the CUDA cores: K7's adds
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


# Traces taken of one call before it is timed by CUDA events instead; once
# `profile_device` has found every one of them empty in a process, its later
# calls there take `PROFILE_ATTEMPTS_AFTER_EMPTY`.  In this script's runs,
# once a process had read eight empty traces of a kernel in a row (the
# training process, after its gloo ranks ran beside it), the later traces
# of its kernels came back empty too.
PROFILE_ATTEMPTS = 8
PROFILE_ATTEMPTS_AFTER_EMPTY = 2
_empty_traces = False


def traced(fn, iters: int, read, attempts: int = PROFILE_ATTEMPTS,
           **kwargs):
    """``read(prof)`` of a profiler trace, with CUDA activities, of
    ``iters`` calls of ``fn()``; ``read`` returns (device ms, ...).  A
    trace that holds no device time is taken again after a pause, up to
    ``attempts`` in all; returns None when every one was empty.  On
    an H100 with torch 2.11 a few traces in a thousand come back without
    device events, in runs of up to a few back-to-back traces, with CUPTI
    torn down after each trace or not, and a trace taken again after a
    pause has them (`valley_tpu_torch.tools.profiler_gaps` counts both).
    In this script's runs three traces of one call in a row were empty in
    two of some ten runs; K1's and K2's traces at the stage-2 shape
    (`flash_stage2_phase`) came back empty 5 and 8 times in a row, with
    pauses, in three runs of the training process, and then read the
    CUDA events' time.  The CPU side (the ops) is traced only where
    ``record_shapes`` asks for the ops' shapes: its events outnumber the
    device's several times, and reading them took tens of seconds of each
    serving process."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if kwargs.get("record_shapes"):
        activities.append(ProfilerActivity.CPU)
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            time.sleep(0.25 * attempt)
        torch.cuda.synchronize()
        with profile(activities=activities, **kwargs) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = read(prof)
        if got[0] > 0:
            return got
        print(f"profiler: trace {attempt} recorded no device time",
              flush=True)
    return None


def profile_device(fn, iters: int = 1, with_flops: bool = False):
    """Run ``fn()`` ``iters`` times under the profiler's CUDA trace.
    Returns (device ms per call summed over every kernel and copy, the
    kernels by total device ms, the FLOPs per call of `MATMUL_OPS` as the
    profiler counts them from the recorded shapes, or 0 without
    ``with_flops``).  Every call launches the same kernels and copies, so
    the time per call is each kernel's mean over its events times its
    events per call (its count over ``iters``, rounded, at least one): a
    trace that lost an event reads the calls' time all the same.  On one
    H100 with torch 2.11 every trace lost one event (nine events for ten
    calls of one kernel), and the total over ten read a kernel under its
    bytes bound.  A range's span on the device timeline (a user
    annotation, such as the optimizer's ``Optimizer.step#AdamW.step``) is
    not device time of its own: its kernels are counted.  When every trace
    of `traced` is empty, the time per call is that of ``iters`` calls
    between two CUDA events (launch gaps included), with no kernels and
    no FLOPs: a caller that reads the kernels fails its own check."""
    def read(prof):
        events = prof.key_averages()
        device = [e for e in events if str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)]
        return (sum(e.self_device_time_total for e in device) / 1e3,
                events, device)

    global _empty_traces
    attempts = PROFILE_ATTEMPTS_AFTER_EMPTY if _empty_traces \
        else PROFILE_ATTEMPTS
    got = traced(fn, iters, read, attempts, record_shapes=with_flops,
                 with_flops=with_flops)
    if got is None:
        _empty_traces = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        print(f"profiler: no device time in {attempts} traces; "
              f"{ms:.4f} ms per call from CUDA events around {iters} "
              f"calls instead", flush=True)
        return ms, [], 0
    total, events, device = got
    rows = [(e.key, e.self_device_time_total / 1e3) for e in device]
    flops = sum(e.flops or 0 for e in events if e.key in MATMUL_OPS)
    per_call = sum(e.self_device_time_total / 1e3 / e.count
                   * max(1, round(e.count / iters)) for e in device)
    lost = [f"{e.key[:40]} {e.count}" for e in device if e.count % iters]
    if lost:
        print(f"profiler: events for {iters} calls: " + ", ".join(lost)
              + f"; per call {per_call:.4f} ms from the events' means "
              f"({total / iters:.4f} from the total)")
    return per_call, sorted(rows, key=lambda r: -r[1]), flops / iters


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
    ``extra_bytes``) read or written once, and the mask.  Also returns
    those operations as ``ops``."""
    b, sq, h, d = q.shape
    pairs = attended_pairs(kv_mask, sq, causal) * h
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + \
        kv_mask.numel() + extra_bytes
    ops = products * 2 * d * pairs
    return {**bound(n_bytes, ops), "ops": ops}


def attention_rates(times: dict) -> str:
    """Put beside an attention kernel's times its rate over the attended
    pairs' operations (``tflop_per_s``) and its time over the library
    call's (``library_ratio``); returns them for the kernel's line."""
    times["tflop_per_s"] = times["ops"] / (times["ms"] * 1e-3) / 1e12
    times["library_ratio"] = times["ms"] / times["library_ms"]
    return (f"; {times['tflop_per_s']:.1f} TFLOP/s over the attended "
            f"pairs, {times['library_ratio']:.2f}x the library's time")


def k3_traffic_text(q, k, valid, quant: bool) -> str:
    """What K3's design reads on this data, worked out from the mask and
    the library's chunk, not measured, for the readable lines only: the
    valid slots' K and V rows (int8 and their two bf16 scales, or bf16),
    the mask, q, and the fp32 partials (m, l, PV) that each chunk with a
    valid slot writes and the merge reads back; and the share of its (row,
    chunk) blocks with no valid slot, which read no K, V or scale."""
    from valley_tpu_torch.ops.decode_attention import _lib

    chunk = _lib().chunk
    b, smax = valid.shape
    hkv, d = k.shape[3], k.shape[4]
    n_split = -(-smax // chunk)
    padded = torch.zeros((b, n_split * chunk), dtype=torch.bool,
                         device=valid.device)
    padded[:, :smax] = valid
    live = int(padded.view(b, n_split, chunk).any(dim=-1).sum())
    rows = 2 * int(valid.sum()) * hkv * (d + 2 if quant else 2 * d)
    partials = 2 * live * q.shape[2] * (d + 2) * 4
    read = rows + partials + valid.numel() + q.numel() * q.element_size()
    return (f"its design reads {read / 1e6:.2f} MB and skips "
            f"{100 * (1 - live / (b * n_split)):.1f} % of its chunks")


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


def flash_cases(gen, heads: int = 32, model: str = "7b",
                prompt_len: int = PROMPT_LEN):
    """(name, q, k, v, kv_mask, causal): the prefill shape of a model with
    ``heads`` heads of 128 first, a prompt of ``prompt_len`` in the 512
    bucket."""
    def qkv(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(3)]

    cases = []
    q, k, v = qkv(1, 512, heads, 128)
    mask = torch.ones((1, 512), dtype=torch.bool, device="cuda")
    mask[:, prompt_len:] = False               # a prompt padded to 512
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
        _kernel_delta, attention_delta, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain)

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
                  f"ms ({k1['bound_by']}), library {k1['library_ms']:.4f} ms"
                  + attention_rates(k1))
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
                     f" ms" + attention_rates(k2_t))
            # two passes and no atomics: a second call gives the same bits
            again = flash_attention_bwd(q, k, v, mask, out, lse, g,
                                        causal=causal)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            check(same, f"K2 {name}: a second call gave other bits")
            line += "; a second call bit-identical"
            del again
            # delta = rowsum(dO * O) inside K2's time: its kernel against
            # the eager PyTorch reduction it replaced
            k2_t["delta_ms"] = profile_device(
                lambda: _kernel_delta(out, g), 5)[0]
            k2_t["torch_delta_ms"] = profile_device(
                lambda: attention_delta(out, g), 5)[0]
            line += (f"; delta {k2_t['delta_ms']:.4f} ms (attention_delta "
                     f"{k2_t['torch_delta_ms']:.4f} ms)")
        print(line)
        del q, k, v, g, out, lse, got, ref
    return k2_err, k2_t, k1


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def train_phase(smi: str) -> tuple:
    """Valley-7B stage 1 (cut to `TRAIN_LAYERS` layers) on the card
    through `Trainer`: the first step's
    loss and gradients against the plain attention functions, one warm-up
    update, then three timed updates on the same batch with the launch
    counts read around them, then one profiled update.  Returns the K1, K2
    and K2's delta-kernel launches of the three timed updates."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.dataset import (
        DataCollatorForSupervisedDataset, DataLoader)
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS, TrainRows
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.attention import KERNELS, PLAIN
    from valley_tpu_torch.ops.flash_attention import (
        _kernel_delta, flash_attention, flash_attention_bwd)
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    cfg = cfg.replace(text=dataclasses.replace(
        cfg.text, num_hidden_layers=TRAIN_LAYERS))
    layers = cfg.text.num_hidden_layers
    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"train: valley_7b random bf16 weights, cut to {layers} layers, in "
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
    # and the "dots" remat policy's against full remat's, the same weights
    trainer.tc.gradient_checkpointing = "dots"
    loss_d, _, grads_d = trainer.loss_and_grads(batch)
    trainer.tc.gradient_checkpointing = True
    dots_first_step(names, loss_k, grads_k, loss_d, grads_d)
    del grads_d
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
    _kernel_delta.launches = 0
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
    n_delta = _kernel_delta.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"train: losses {[round(x, 5) for x in losses]} (warm-up, then 3 "
          f"updates); launches over 3 updates K1 {n_k1} K2 {n_k2} (each "
          f"after one of K2's delta kernel: {n_delta})")
    check(all(np.isfinite(losses)), "train: loss not finite")
    check(losses[-1] < losses[0], "train: the loss did not fall")
    check(n_k1 == 3 * 2 * layers,
          f"K1 launched {n_k1} times in 3 updates, want {3 * 2 * layers}")
    check(n_k2 == 3 * layers,
          f"K2 launched {n_k2} times in 3 updates, want {3 * layers}")
    check(n_delta == n_k2, f"K2's delta kernel launched {n_delta} times, "
          f"K2 {n_k2}")
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
    dots = dots_updates(trainer, batch, layers, smi, step_s, peak)
    del trainer, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return n_k1, n_k2, n_delta, dots


def dots_first_step(names, loss_f, grads_f, loss_d, grads_d) -> None:
    """The ``"dots"`` remat policy's first-step loss and gradients against
    full remat's on the same weights and batch, held to the stage-1 bars
    and said bit-equal or not: its recompute runs K1 and the elementwise
    glue on the same inputs, and keeps the products' outputs that full
    remat computes again."""
    diff = abs(float(loss_d) - float(loss_f))
    same = float(loss_d) == float(loss_f) and all(
        torch.equal(a, b) for a, b in zip(grads_d, grads_f))
    parts = [f"loss {float(loss_d):.6f} vs {float(loss_f):.6f} (diff "
             f"{diff:.2e}, tol {TRAIN_LOSS_TOL})"]
    check(diff <= TRAIN_LOSS_TOL, f"train dots: first-step loss differs from "
          f"full remat's by {diff}")
    for name, gd, gf in zip(names, grads_d, grads_f):
        err = rel_l2(gd, gf)
        parts.append(f"{name} grad rel L2 {err:.2e} (max abs "
                     f"{max_err(gd, gf):.2e})")
        check(err <= TRAIN_GRAD_TOL, f"train dots: {name} grad rel L2 {err} "
              f"> {TRAIN_GRAD_TOL}")
    print(f"train dots: first step against full remat: "
          f"{'bit-equal' if same else 'NOT bit-equal'}; " + "; ".join(parts))


def dots_updates(trainer, batch, layers: int, smi: str, full_s: float,
                 full_peak: int) -> tuple:
    """Two stage-1 updates with ``gradient_checkpointing: "dots"`` after
    full remat's: their walls, the peak memory over them, K1's and K2's
    launches (K1 twice a layer, its recompute, as under full remat), and
    one profiled update by kind, beside full remat's wall and peak of this
    run.  Returns the launches (K1, K2) of the two updates."""
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)

    trainer.tc.gradient_checkpointing = "dots"
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    walls, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    n_k1, n_k2 = flash_attention.launches, flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), "train dots: loss not finite")
    check(n_k1 == 2 * 2 * layers, f"train dots: K1 launched {n_k1} times in "
          f"2 updates, want {2 * 2 * layers} (forward and recompute)")
    check(n_k2 == 2 * layers, f"train dots: K2 launched {n_k2} times in 2 "
          f"updates, want {2 * layers}")
    step_dev, top, _ = profile_device(lambda: trainer.train_step(batch))
    kinds: dict = {}
    for name, ms in top:
        kind = next((k for k, keys in KERNEL_KINDS if any(
            key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"train dots: losses {[round(x, 5) for x in losses]}; launches "
          f"over 2 updates K1 {n_k1} K2 {n_k2}; update walls "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms against full "
          f"remat's {full_s * 1e3:.1f} in this run (PERF.md's earlier "
          f"reading, at 32 layers: 1106.7 ms); device busy {step_dev:.1f} ms (idle share "
          f"{1 - step_dev / (walls[-1] * 1e3):.3f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB against full remat's "
          f"{full_peak / 2 ** 30:.2f} GiB (PERF.md's, at 32 layers: 19.13 "
          f"GiB), on {smi}")
    print("train dots: device time by kind: " + fmt_kinds(kinds, step_dev))
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
    """Device ms of torch's int8 weight-only product on K4's inputs,
    walking the weight copies ``ws`` as the kernel's timing does, and its
    label; (None, why) where this torch does not run it on CUDA.  A
    yardstick only: the port never calls it."""
    it = iter(range(10 ** 9))
    try:
        torch._weight_int8pack_mm(x, ws[0], scale)
    except (RuntimeError, NotImplementedError) as e:
        why = str(e).splitlines()[0][:80]
        print(f"K4 yardstick: torch._weight_int8pack_mm does not run on "
              f"CUDA here ({why})")
        return None, f"none: {why}"
    fn = lambda: torch._weight_int8pack_mm(  # noqa: E731
        x, ws[next(it) % len(ws)], scale)
    fn()
    return profile_device(fn, iters)[0], "torch._weight_int8pack_mm"


def bf16_linear_ms(x, w, scale, iters: int) -> float:
    """Device ms of ``F.linear`` (cuBLAS) on K4's activations and the same
    weight dequantized to bf16 (twice its bytes), walking copies of it past
    the 50 MB L2 as the kernel's timing does: K4's second yardstick, since
    torch's int8 weight-only product is a slow path at these shapes.  The
    port never calls it."""
    wb = (w.float() * scale.float()[:, None]).bfloat16()
    wbs = [wb] + [wb.clone() for _ in range(
        -(-TIMING_BYTES // (2 * wb.numel())) - 1)]
    it = iter(range(10 ** 9))
    fn = lambda: torch.nn.functional.linear(  # noqa: E731
        x, wbs[next(it) % len(wbs)])
    fn()
    return profile_device(fn, iters)[0]


def bound_share(t: dict) -> str:
    """The share of its bound a kernel's device time reaches, in words."""
    return f"{100 * t['bound_ms'] / t['ms']:.1f}% of its {t['bound_by']} bound"


def dominant_bound(per_weight: dict, layers: int) -> str:
    """What bounds one decode token's (or round's) GEMVs: the kind whose
    weights' bounds (``layers`` calls of each layer weight, one lm_head)
    sum to more."""
    share = {"bytes": 0.0, "operations": 0.0}
    for name, t in per_weight.items():
        share[t["bound_by"]] += t["bound_ms"] * (1 if name == "lm_head"
                                                 else layers)
    return max(share, key=share.get)


def rows_alone_text(fn, x, *args) -> str:
    """Check that each row of ``fn(x, *args)`` is bit-equal to the same
    row alone (the kernel's B = 1 code); returns the line's words."""
    out = fn(x, *args)
    same = all(torch.equal(fn(x[r:r + 1].contiguous(), *args)[0], out[r])
               for r in range(x.shape[0]))
    check(same, f"{fn.__name__} at B{x.shape[0]}: a row's result depends "
          "on the other rows")
    return f"; rows 1-{x.shape[0]} bit-equal to each row alone"


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
# K4's yardsticks beside its own times: torch's int8 weight-only product
# and cuBLAS over the weight dequantized to bf16
K4_TIME_KEYS = TIME_KEYS + ("bf16_linear_ms",)


def k4_phase(gen, layers: int, rows: int = 1) -> tuple:
    """K4 against its plain version on the five Valley-7B weights at B =
    ``rows`` (at B = 1 also at 8 rows and at the row limit with K = 11008
    and at an odd F, and a planted fault: the scales shifted by one output
    channel; at more rows, each row bit-equal to the same row alone); each
    7B weight timed walking copies of it past the 50 MB L2.  Returns (max
    error, times per call averaged over one decode token's (or verify
    round's) GEMVs: ``layers`` x the four layer weights, then lm_head)."""
    from valley_tpu_torch.ops.quant import (MAX_ROWS, int8_matvec,
                                            int8_matvec_plain)

    cases = [(f"7b_{n}_B{rows}", rows, k, f) for n, k, f in K4_SHAPES_7B]
    if rows == 1:
        cases += [("rows8_K11008", 8, 11008, 4096),
                  (f"rows{MAX_ROWS}_K11008", MAX_ROWS, 11008, 4096),
                  ("B3_odd_F1001", 3, 4096, 1001)]
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
        if b > 1 and name.startswith("7b_wqkv"):
            line += rows_alone_text(int8_matvec, x, w, scale)
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
            # bytes: the weight, x, the scale and the fp32 output once;
            # the products at the card's bf16 tensor-core peak (the type
            # the int8 weight is widened to)
            n_bytes = f * k + 2 * b * k + 2 * f + 4 * b * f
            add_bound(t, bound(n_bytes, 2 * b * k * f), f"K4 {name}")
            t["library_ms"], label = library_matvec_ms(x, ws, scale, 20)
            del ws
            t["bf16_linear_ms"] = bf16_linear_ms(x, w, scale, 20)
            per_weight[name.split(f"_B{rows}")[0][3:]] = t
            lib = "none" if t["library_ms"] is None else \
                f"{t['library_ms']:.4f} ms"
            line += (f" {fmt_times(t)} ({f * k / t['ms'] / 1e6:.1f} GB/s of "
                     f"weights); bound {t['bound_ms']:.4f} ms ("
                     f"{t['bound_by']}, {n_bytes / 1e6:.2f} MB), "
                     f"{bound_share(t)}; library {lib} ({label}), F.linear "
                     f"over the bf16 weight {t['bf16_linear_ms']:.4f} ms")
        print(line)
        del x, w, scale, out, ref
    calls = 4 * layers + 1
    token = {key: None if any(t[key] is None for t in per_weight.values())
             else layers * sum(per_weight[n][key] for n, _, _ in
                               K4_SHAPES_7B[:4]) + per_weight["lm_head"][key]
             for key in K4_TIME_KEYS}
    avg = {key: None if v is None else v / calls for key, v in token.items()}
    avg["bound_by"] = dominant_bound(per_weight, layers)
    avg["library_call"] = label
    avg["rows"] = rows
    lib = "none" if token["library_ms"] is None else \
        f"{token['library_ms']:.4f} ms"
    print(f"K4 int8_matvec per decode token at B{rows} ({calls} calls: "
          f"{layers} x "
          f"wqkv, wo, w_gateup, w_down, then lm_head): device "
          f"{token['ms']:.4f} ms vs plain {token['plain_ms']:.4f} ms; bound "
          f"{token['bound_ms']:.4f} ms, {bound_share(avg)}; library "
          f"{lib} ({label}); F.linear over the bf16 weights "
          f"{token['bf16_linear_ms']:.4f} ms")
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
                     f"K/V and scales in the layer; "
                     f"{k3_traffic_text(q, k, valid, True)}); bound "
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


def pool_bytes(handle):
    """Bytes the caching allocator's segments of the graph memory pool
    ``handle`` hold, or None where its snapshot names no pool."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(handle))


def graph_memory(engine) -> tuple:
    """(bytes of the memory pool of ``engine``'s decode graphs, or None;
    bytes of their static decode states)."""
    state_bytes = 0
    for g in engine.graph_sets.values():
        st = g.state
        for t in (st.cache.k, st.cache.v, st.cache.k_scale, st.cache.v_scale,
                  st.valid):
            if t is not None:
                state_bytes += t.numel() * t.element_size()
    return pool_bytes(engine._graph_pool), state_bytes


def fmt_mb(n) -> str:
    return "not measured" if n is None else f"{n / 1e6:.1f} MB"


def sampled_graph_check(tag: str, engine, prompt, frames, new: int) -> None:
    """A sampled request through the graphs twice under one seed gives the
    same tokens; its graph replayed on the same state draws other tokens
    each replay, and the same again after its generator is seeded
    again."""
    from valley_tpu_torch.inference.engine import GenerationConfig

    sg = GenerationConfig(max_new_tokens=new, do_sample=True,
                          temperature=1.0, top_p=0.9, seed=5)
    runs = [[int(t[0]) for t in engine.generate_tokens([prompt], frames, sg,
                                                       eos_ids=[-1])]
            for _ in range(2)]
    check(runs[0] == runs[1], f"{tag}: a sampled request repeated under its "
          "seed gave other tokens")
    graphs = next(g for g in engine.graph_sets.values()
                  if (new - 1, True) in g.keys())
    saved = graphs.state.snapshot()
    outs = []
    for seed in (None, None, 11, 11):
        if seed is not None:
            graphs.generator.manual_seed(seed)
        graphs.state.restore(saved)
        outs.append(graphs.run(new - 1, True).clone())
    graphs.state.restore(saved)
    fresh = int((outs[0] != outs[1]).sum())
    check(fresh > 0 and torch.equal(outs[2], outs[3]), f"{tag}: sampled "
          f"graph replays: {fresh} tokens differ between two replays, "
          f"seeded replays equal {torch.equal(outs[2], outs[3])}")
    print(f"{tag}: sampled graph (temperature 1.0, top_p 0.9): two requests "
          f"under seed 5 give the same {new} tokens; two replays of its "
          f"{new - 1}-step graph on the same state differ in {fresh} of "
          f"{new - 1} tokens, two replays after seeding 11 agree in all")


# the eager references beside the graph paths decode this many tokens (the
# graph's first EAGER_NEW compared, launches scaled to their steps)
EAGER_NEW = 16


def eager_launches(counts: dict, steps: int, eager_steps: int) -> dict:
    """The launches of a request decoding ``eager_steps`` steps, from a
    request's ``counts`` over ``steps`` steps: K1 and K8 launches only at
    the prefill, K3 only in decode steps, a GEMV kernel once at the prefill
    (lm_head) and as often in each step."""
    out = {}
    for k, n in counts.items():
        pre = n if k.startswith(("K1", "K8")) else \
            0 if k.startswith("K3") or not n else 1
        check((n - pre) % steps == 0, f"{k}: {n} launches over {steps} "
              "steps")
        out[k] = pre + (n - pre) // steps * eager_steps
    return out


def serve_slice(tag: str, cfg, params, smi: str, cache_dtype,
                kernels: dict, logit_tol: float, same_token: bool,
                sampled: bool = False, walls: Optional[dict] = None
                ) -> dict:
    """One `bench_request` through ``Engine.generate_tokens`` (64 greedy
    tokens, one stream, each decode chunk a replay of a CUDA graph), after
    a warm-up request that captures the graph.  ``kernels`` maps a label
    to (wrapper, launches the request must make): every count is set to 0
    just before the request and read just after.  Then the same request
    through the eager step (``eager=True``): the same tokens and launches.
    Then the breakdown (profiled prefill and requests, graph and eager),
    with ``sampled`` `sampled_graph_check`, and the logits through the
    kernels against the same path on the plain versions, at the prefill and
    three teacher-forced decode steps, within ``logit_tol`` and, with
    ``same_token``, picking the same greedy token.  Returns the counts;
    ``walls``, where given, takes the request's first-token ms and decode
    ms per token by graph."""
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

    # the eager reference's engine: the same cache, its first chunk the
    # EAGER_NEW - 1 steps the reference runs
    eager_engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                          steps_per_call=steps, cache_dtype=cache_dtype,
                          decode_ramp=(EAGER_NEW - 1,))

    def run(eager=False, n=new):
        t0 = time.perf_counter()
        t_first, toks = None, []
        g = GenerationConfig(max_new_tokens=n, do_sample=False)
        eng = eager_engine if eager else engine
        for t in eng.generate_tokens([prompt], frames, g, eos_ids=[-1],
                                     eager=eager):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(int(t[0]))
        return t_first, time.perf_counter() - t0, toks

    run()   # warm-up: lazy CUDA initialisation, the decode graph's capture
    capture_s = sum(g.capture_s for g in engine.graph_sets.values())
    graph_bytes, state_bytes = graph_memory(engine)
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
    check(list(engine.graph_sets) == [(1, bucket + new + steps)]
          and list(engine.graph_sets[(1, bucket + new + steps)].keys())
          == [(steps, False)], f"{tag}: graphs {engine.graph_sets}")
    decode_tps = (new - 1) / (total - t_first)
    if walls is not None:
        walls.update(first_token_ms=t_first * 1e3,
                     decode_ms_per_token=1e3 / decode_tps)
    print(f"{tag}: prompt {len(prompt)} tokens in bucket {bucket}, 8 frames "
          f"{size}px uint8, {new} greedy tokens, {cache_dtype} KV cache, "
          f"decode by one replay of a {steps}-step CUDA graph; launches "
          + " ".join(f"{k} {n}" for k, n in counts.items()))
    print(f"{tag}: video->first-token {t_first:.4f} s, decode "
          f"{decode_tps:.2f} tok/s ({1e3 / decode_tps:.3f} ms/token) on "
          f"{smi}")

    # the reference: the same request through the eager step, over its
    # first EAGER_NEW tokens
    run(eager=True, n=EAGER_NEW)
    for fn, _ in kernels.values():
        fn.launches = 0
    e_first, e_total, e_toks = run(eager=True, n=EAGER_NEW)
    e_counts = {k: fn.launches for k, (fn, _) in kernels.items()}
    e_steps = EAGER_NEW - 1
    check(e_toks == toks[:EAGER_NEW], f"{tag}: the graph's tokens differ "
          f"from the eager step's at step {next((i for i, (a, b) in enumerate(zip(toks, e_toks)) if a != b), None)}")
    e_want = eager_launches(counts, steps, e_steps)
    check(e_counts == e_want, f"{tag}: eager launches {e_counts}, want "
          f"{e_want} (the graph's {counts} over {e_steps} of {steps} steps)")
    print(f"{tag}: the eager step gives the graph's first {EAGER_NEW} "
          f"tokens and its launches for {e_steps} steps; decode "
          f"{(e_total - e_first) / e_steps * 1e3:.3f} ms/token eager against "
          f"{(total - t_first) / steps * 1e3:.3f} by graph; capture of the "
          f"graph {capture_s:.3f} s, its memory pool {fmt_mb(graph_bytes)}, "
          f"the static decode state (cache and mask) {fmt_mb(state_bytes)}")

    # where the time goes: device busy time of the prefill and of a whole
    # request, graph and eager, against the unprofiled wall times above
    frames_dev = torch.from_numpy(frames).cuda()
    vision_ms = time_ms(lambda: valley.encode_images(params, cfg, frames_dev),
                        iters=3, warmup=1)
    vision_dev, _, _ = profile_device(
        lambda: valley.encode_images(params, cfg, frames_dev))
    prefill_dev, prefill_top, _ = profile_device(
        lambda: engine.prefill([prompt], frames, gcfg))
    run_dev, top, _ = profile_device(run)
    e_run_dev, _, _ = profile_device(lambda: run(eager=True, n=EAGER_NEW))
    decode_dev = (run_dev - prefill_dev) / (new - 1)
    e_decode_dev = (e_run_dev - prefill_dev) / e_steps
    wall_tok = (total - t_first) / (new - 1) * 1e3
    e_wall_tok = (e_total - e_first) / e_steps * 1e3
    k3_in = sum(t for name, t in top if "decode_attn_kernel" in name)
    check(k3_in > 0, f"{tag}: the profiler saw no K3 inside the graph's "
          "replay")
    shares = ", ".join(f"{name[:48]} {100 * ms / run_dev:.1f}%"
                       for name, ms in top[:8])
    print(f"{tag} breakdown: video->first-token wall {t_first * 1e3:.2f} ms, "
          f"prefill device {prefill_dev:.2f} ms (vision tower device "
          f"{vision_dev:.2f} ms, wall {vision_ms:.2f} ms); decode by graph: "
          f"wall {wall_tok:.3f} ms/token, device busy {decode_dev:.3f} "
          f"ms/token (idle share {1 - decode_dev / wall_tok:.3f}); eager: "
          f"wall {e_wall_tok:.3f} ms/token, device busy {e_decode_dev:.3f} "
          f"ms/token (idle share {1 - e_decode_dev / e_wall_tok:.3f}); "
          f"request device busy {run_dev:.2f} ms of {total * 1e3:.2f} ms "
          f"wall (graph); top kernels: {shares}")
    if sampled:
        sampled_graph_check(tag, engine, prompt, frames, new)
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
    logits = [[s.logits[0]] + decode_logits(e, s.cache, s.valid, s.bucket,
                                            len(prompt), forced)
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
    del engine, eager_engine, plain_engine, states, logits, frames_dev
    return counts


def decode_logits(engine, cache, valid, slot0: int, pos0: int, tokens):
    """fp32 logits of teacher-forced decode steps on a cache (written in
    place; ``valid`` is not): step i feeds ``tokens[i]`` at slot slot0 + i
    and rotary position pos0 + i, as ``Engine._decode`` does."""
    from valley_tpu_torch.models import llama

    p, text, dev = engine.params["llama"], engine.cfg.text, engine.device
    valid = valid.clone()
    out = []
    with torch.inference_mode():
        for i, t in enumerate(tokens):
            slot = slot0 + i
            valid[:, slot] = True
            hidden, _ = llama.forward_hidden(
                p, text, llama.embed(p, torch.tensor([[t]], device=dev)),
                positions=torch.tensor([[pos0 + i]], device=dev),
                cache=cache, cache_index=slot, kv_valid=valid,
                attention=engine.attention)
            out.append(llama.logits_from_hidden(p, hidden,
                                                engine.attention)[0, 0])
    return out


# Speculative serving (`SpecDecoder` by graph): bench's request, 128 greedy
# tokens, JAX's SpecConfig (D = 8, ngram 4, 16 rounds a call after a probe
# of 4) with the adaptive switch off (threshold 0), so that every token
# comes from verify rounds and a round's cost can be read on random
# weights, whose drafts are almost never accepted; the plain graph beside
# it decodes in chunks of 16 steps (batch_infer's steps_per_call)
SPEC_NEW = 128
SPEC_STEPS = 16
# JAX's adaptive thresholds (speculative.py:171-175), printed beside the
# card's break-even
JAX_THRESHOLDS = "0.40 (bf16, int8) / 1.70 (4-bit)"


def counted(kernels: dict, fn):
    """(fn(), {label: launches of the wrapper during it}): every count set
    to 0 just before and read just after."""
    for w in kernels.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in kernels.items()}


def first_divergence(tag: str, engine, prompt, frames, want, got,
                     bar: float) -> str:
    """Where ``got`` first parts from the plain graph's ``want``: the plain
    path's top-2 margin there (teacher-forced eager steps, the graph's
    arithmetic) must lie under ``bar``, the path's kernels-vs-plain logit
    bar.  Returns the line's words."""
    from valley_tpu_torch.inference.engine import GenerationConfig

    if got == want:
        return f"the same {len(got)} tokens"
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    st = engine.prefill([prompt], frames,
                        GenerationConfig(max_new_tokens=len(want)))
    lg = st.logits[0] if i == 0 else decode_logits(
        engine, st.cache, st.valid, st.bucket, len(prompt), want[:i])[-1]
    top2 = torch.topk(lg, 2).values
    margin = (top2[0] - top2[1]).item()
    gap = (lg[want[i]] - lg[got[i]]).item()
    check(margin < bar, f"{tag}: speculation parts from plain decode at "
          f"token {i} where the plain top-2 margin is {margin} (bar {bar})")
    return (f"the same first {i} of {len(got)} tokens, then token {got[i]} "
            f"for the plain graph's {want[i]}, where the plain top-2 margin "
            f"is {margin:.4f} and the two tokens' logits lie {gap:.4f} apart "
            f"(under the path's bar {bar})")


def verify_logits(engine, prompt, frames, first: int) -> torch.Tensor:
    """fp32 logits (D + 1, V) of a first verify round after the prefill of
    ``prompt``: [first, draft] written at the bucket's end and attended
    over the cache, the draft looked up as `spec_round` does."""
    from valley_tpu_torch.inference.engine import GenerationConfig
    from valley_tpu_torch.inference.speculative import SpecConfig, ngram_draft
    from valley_tpu_torch.models import llama

    sp = SpecConfig()
    p, dev = engine.params["llama"], engine.device
    st = engine.prefill([prompt], frames, GenerationConfig())
    with torch.inference_mode():
        hist = torch.tensor([prompt + [first]], device=dev)
        draft = ngram_draft(hist, torch.tensor([hist.shape[1]], device=dev),
                            sp.draft_len, sp.ngram)
        chunk = torch.cat([torch.tensor([[first]], device=dev), draft], 1)
        pos = len(prompt) + torch.arange(sp.draft_len + 1, device=dev)
        hidden, _ = llama.forward_hidden(
            p, engine.cfg.text, llama.embed(p, chunk), positions=pos[None],
            cache=st.cache, cache_index=torch.tensor([st.bucket], device=dev),
            cross_valid=st.valid, attention=engine.attention)
        return llama.logits_from_hidden(p, hidden, engine.attention)[0]


def timed_captures(graphs) -> dict:
    """Record the seconds of each capture of ``graphs`` by its key."""
    caps, capture = {}, graphs.capture

    def timed(n, do_sample):
        t0 = time.perf_counter()
        entry = capture(n, do_sample)
        caps[(n, do_sample)] = time.perf_counter() - t0
        return entry

    graphs.capture = timed
    return caps


def spec_run(dec, prompt, frames, gcfg) -> tuple:
    """One request through ``dec``: (first-token s, total s, tokens, each
    counted round's tokens, rounds run on the card)."""
    log, ran = [], [0]
    count, rounds = dec._count, dec._rounds

    def rec(rounds=0, emitted=0, disabled=0):
        if rounds:
            log.append(emitted)
        count(rounds, emitted, disabled)

    def run_rounds(state, n_rounds, *a, **k):
        ran[0] += n_rounds
        return rounds(state, n_rounds, *a, **k)

    dec._count, dec._rounds = rec, run_rounds
    try:
        t0 = time.perf_counter()
        t_first, toks = None, []
        for t in dec.generate_tokens(prompt, frames, gcfg, eos_ids=[-1]):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(t)
        return t_first, time.perf_counter() - t0, toks, log, ran[0]
    finally:
        dec._count, dec._rounds = count, rounds


def plain_run(engine, prompt, frames, gcfg) -> tuple:
    """One request through ``engine``'s graphs: (first-token s, total s,
    tokens, decode steps run)."""
    steps0 = engine.steps_run
    t0 = time.perf_counter()
    t_first, toks = None, []
    for t in engine.generate_tokens([prompt], frames, gcfg, eos_ids=[-1]):
        if t_first is None:
            t_first = time.perf_counter() - t0
        toks.append(int(t[0]))
    return t_first, time.perf_counter() - t0, toks, engine.steps_run - steps0


def spec_slice(tag: str, cfg, params, smi: str, cache_dtype, kernels: dict,
               per_round: dict, logit_tol: float) -> dict:
    """bench's request through `SpecDecoder` by graph beside the plain
    graph (`SPEC_NEW` greedy tokens each, after a warm-up request of each
    that captures their graphs): the tokens against the plain graph's by
    `first_divergence`; the launches (``kernels``: label -> wrapper) against
    ``per_round`` (label -> (launches a round, launches of the prefill));
    the first verify round's (D + 1)-row logits through the kernels against
    the plain versions within ``logit_tol``; rounds, tokens, accepted
    drafts; wall and device ms a round against a plain step, the
    break-even; each capture's seconds and the graphs' memory.  Returns the
    spec request's launches."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.inference.speculative import (SpecConfig,
                                                        SpecDecoder)
    from valley_tpu_torch.ops.attention import PLAIN

    t_slice = time.perf_counter()
    prompt, frames = bench_request(cfg, 512)
    gcfg = GenerationConfig(max_new_tokens=SPEC_NEW, do_sample=False)
    engine = Engine(cfg, params, buckets=(512,), max_new_tokens=SPEC_NEW,
                    steps_per_call=SPEC_STEPS, cache_dtype=cache_dtype)
    sp = SpecConfig(disable_below=0.0)
    dec = SpecDecoder(engine, sp)
    cache_len = 512 + SPEC_NEW + sp.rounds_per_call * (sp.draft_len + 1)
    caps = timed_captures(dec.graphs_for(512, cache_len))
    plain_run(engine, prompt, frames, gcfg)             # captures
    spec_run(dec, prompt, frames, gcfg)                 # captures
    (p_first, p_total, want, _), _ = counted(
        kernels, lambda: plain_run(engine, prompt, frames, gcfg))
    (t_first, total, got, log, ran), counts = counted(
        kernels, lambda: spec_run(dec, prompt, frames, gcfg))
    check(len(got) == SPEC_NEW and all(0 <= t < cfg.text.vocab_size
                                       for t in got), f"{tag}: tokens")
    for k, (a_round, a_prefill) in per_round.items():
        want_n = a_round * ran + a_prefill
        check(counts[k] == want_n, f"{tag}: {k} launched {counts[k]} times "
              f"in {ran} rounds, want {want_n}")
    print(f"{tag}: bench's request through SpecDecoder by graph (D "
          f"{sp.draft_len}, ngram {sp.ngram}, probe {sp.probe_rounds} then "
          f"{sp.rounds_per_call} rounds a replay), {SPEC_NEW} greedy tokens: "
          f"{len(log)} rounds emit them ({ran} run on the card, the last "
          f"call's surplus dropped), {sum(log) / len(log) - 1:.3f} accepted "
          f"drafts a round, tokens a round {sorted(set(log))}; launches "
          + " ".join(f"{k} {n}" for k, n in counts.items()))
    print(f"{tag}: against the plain graph: "
          + first_divergence(tag, engine, prompt, frames, want, got,
                             logit_tol))

    # a round's cost against a plain step: wall over the requests above,
    # device time of one more replay of each graph on the state the
    # request left (the steady call's rounds, a chunk's steps)
    plain_graphs = engine.graph_sets[(1, 512 + SPEC_NEW + SPEC_STEPS)]
    step_dev = profile_device(lambda: plain_graphs.run(
        SPEC_STEPS, False))[0] / SPEC_STEPS
    r_dev, top, _ = profile_device(lambda: dec.graph_sets[
        (512, cache_len)].run(sp.rounds_per_call, False))
    round_dev = r_dev / sp.rounds_per_call
    step_wall = (p_total - p_first) / (len(want) - 1) * 1e3
    round_wall = (total - t_first) / ran * 1e3
    print(f"{tag}: a verify round {round_wall:.3f} ms wall, {round_dev:.3f} "
          f"ms device; a plain step {step_wall:.3f} ms wall, {step_dev:.3f} "
          f"ms device: a round costs {round_wall / step_wall:.3f}x a step "
          f"(device {round_dev / step_dev:.3f}x), so the break-even is "
          f"{round_wall / step_wall - 1:.3f} accepted drafts a round (device "
          f"{round_dev / step_dev - 1:.3f}; JAX's thresholds "
          f"{JAX_THRESHOLDS}); decode {(len(got) - 1) / (total - t_first):.2f}"
          f" tok/s by rounds against {(len(want) - 1) / (p_total - p_first):.2f}"
          f" plain, on {smi}")
    print(f"{tag}: a round's top kernels: " + ", ".join(
        f"{name[:44]} {100 * ms / r_dev:.1f}%" for name, ms in top[:8]))
    graph_bytes, state_bytes = graph_memory(engine)
    hist_bytes = sum(g.state.hist.numel() * 8 for g in dec.graph_sets.values())
    print(f"{tag}: captures " + ", ".join(
        f"{n} rounds {'sampled' if ds else 'greedy'} {t:.3f} s"
        for (n, ds), t in sorted(caps.items())) + f"; the engine's graph "
          f"memory pool (plain and round graphs) {fmt_mb(graph_bytes)}, "
          f"static decode states {fmt_mb(state_bytes)}, token histories "
          f"{hist_bytes} bytes")

    # the first verify round: kernels against the plain versions
    plain_engine = Engine(cfg, params, buckets=(512,),
                          max_new_tokens=SPEC_NEW, steps_per_call=SPEC_STEPS,
                          cache_dtype=cache_dtype, attention=PLAIN)
    lk = verify_logits(engine, prompt, frames, got[0])
    lp = verify_logits(plain_engine, prompt, frames, got[0])
    check(bool(torch.isfinite(lk).all()) and lk.shape == (
        sp.draft_len + 1, cfg.text.vocab_size), f"{tag}: verify logits")
    diff = max_err(lk, lp)
    print(f"{tag}: the first verify round's {sp.draft_len + 1}-row logits, "
          f"kernels vs plain: max abs diff {diff:.4e} (tol {logit_tol}; max "
          f"|logit| {lp.abs().max().item():.3f}); greedy tokens agree in "
          f"{int((lk.argmax(-1) == lp.argmax(-1)).sum())} of "
          f"{sp.draft_len + 1} rows")
    check(diff <= logit_tol, f"{tag}: verify logits beyond tolerance")
    del plain_engine, lk, lp
    print(f"{tag}: {time.perf_counter() - t_slice:.1f} s wall", flush=True)
    return {"engine": engine, "dec": dec, "prompt": prompt,
            "frames": frames, "counts": counts, "rounds": ran,
            "round_ms": round_dev, "step_ms": step_dev}


def spec_sampled_check(tag: str, sl: dict) -> None:
    """One sampled request through the round graphs twice under one seed:
    the same tokens; under another seed, other tokens."""
    from valley_tpu_torch.inference.engine import GenerationConfig

    runs = []
    for seed in (5, 5, 6):
        g = GenerationConfig(max_new_tokens=32, do_sample=True,
                             temperature=1.0, top_p=0.9, seed=seed)
        runs.append(spec_run(sl["dec"], sl["prompt"], sl["frames"], g)[2])
    check(runs[0] == runs[1], f"{tag}: a sampled request repeated under its "
          "seed gave other tokens")
    check(runs[0] != runs[2], f"{tag}: seeds 5 and 6 gave the same tokens")
    print(f"{tag}: a sampled request (temperature 1.0, top_p 0.9, 32 "
          f"tokens) by round graphs gives the same tokens twice under seed "
          f"5 and {sum(a != b for a, b in zip(runs[0], runs[2]))} other "
          f"tokens under seed 6")


def full_acceptance(cfg, params, smi: str) -> None:
    """bench.py's constant-filled Valley-7B (bench.py:243-250: every weight
    0.008, so every logit ties and greedy emits token 0 forever, which the
    n-gram lookup drafts): rounds against the plain graph, the card's
    ceiling for D = 8.  ``params`` is overwritten."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.inference.speculative import (SpecConfig,
                                                        SpecDecoder)

    t0 = time.perf_counter()
    with torch.inference_mode():
        for prm in params.parameters():
            prm.fill_(0.008)
    prompt, frames = bench_request(cfg, 512)
    gcfg = GenerationConfig(max_new_tokens=SPEC_NEW, do_sample=False)
    engine = Engine(cfg, params, buckets=(512,), max_new_tokens=SPEC_NEW,
                    steps_per_call=SPEC_STEPS)
    dec = SpecDecoder(engine, SpecConfig())
    plain_run(engine, prompt, frames, gcfg)
    spec_run(dec, prompt, frames, gcfg)
    p_first, p_total, want, _ = plain_run(engine, prompt, frames, gcfg)
    t_first, total, got, log, ran = spec_run(dec, prompt, frames, gcfg)
    d1 = dec.spec.draft_len + 1
    p_tps = (len(want) - 1) / (p_total - p_first)
    s_tps = (len(got) - 1) / (total - t_first)
    check(got == want, f"full acceptance: rounds gave other tokens than the "
          f"plain graph: {got[:12]} against {want[:12]}")
    if set(want) == {want[0]}:
        # rounds 1-3 find no 2-token match of the history's tail (token,
        # token) before it holds three of them; from round 4 on every draft
        # is the token
        check(log[:3] == [1, 1, 1] and set(log[3:]) == {d1}, f"full "
              f"acceptance: tokens a round {log}")
        why = (f"rounds 1-3 emit one token each (the history holds no "
               f"2-token match of its tail before), every later round all "
               f"{d1}")
    else:
        # the ties are not exact: check the bookkeeping instead
        check(sum(log) >= SPEC_NEW and all(1 <= n <= d1 for n in log),
              f"full acceptance: tokens a round {log}")
        why = (f"the logits do not tie exactly (greedy tokens "
               f"{sorted(set(want))[:8]}), so acceptance is partial: tokens "
               f"a round {log}")
    print(f"full acceptance (bench.py's constant-filled Valley-7B, bf16): "
          f"{len(log)} rounds emit the plain graph's {SPEC_NEW} tokens "
          f"({ran} run); {why}; decode {s_tps:.2f} tok/s by rounds against "
          f"{p_tps:.2f} plain ({s_tps / p_tps:.2f}x), on {smi}; "
          f"{time.perf_counter() - t0:.1f} s wall")


def spec_conv(cfg, params, smi: str) -> dict:
    """A follow-up turn through `PrefixCache.spawn(speculative=True)` (a
    `SpecChatSession`, rounds kept on: threshold 0) on the int4 slice's
    weights, beside a plain spawn: bench's video prefix, the first
    conversation question, 64 greedy tokens each; its tokens against the
    plain turn's (at a first divergence, the plain session's top-2 margin
    there, by extending the question and the turn so far, must lie under
    the int4 bar).  Returns the speculative turn's launches."""
    from valley_tpu_torch.inference.engine import (Engine, GenerationConfig,
                                                   PrefixCache)
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.quant import int4_matvec

    t_conv = time.perf_counter()
    prompt, frames = bench_request(cfg, 512)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False)
    engine = Engine(cfg, params, buckets=(512,), max_new_tokens=NEW_TOKENS,
                    cache_dtype=torch.int8, steps_per_call=SPEC_STEPS)
    pc = PrefixCache(engine, prompt, frames, gcfg)
    question = follow_up_ids(CONV_QUESTIONS[0])
    want = pc.spawn().chat(question, eos_ids=[-1])
    sess = pc.spawn(speculative=True)
    sess._decoder.spec.disable_below = 0.0
    rounds0 = sess._decoder.total_rounds
    kernels = {"K1": flash_attention, "K5": int4_matvec}
    t0 = time.perf_counter()
    got, counts = counted(kernels, lambda: sess.chat(question, eos_ids=[-1]))
    dt = time.perf_counter() - t0
    rounds = sess._decoder.total_rounds - rounds0
    line = f"the same {len(got)} tokens"
    if got != want:
        i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
        cache, valid, seq, slot, _ = pc.spawn()._state
        chunk = question + want[:i]
        cb = 1 << max(4, (len(chunk) - 1).bit_length())
        ids = torch.zeros((1, cb), dtype=torch.long)
        ids[0, :len(chunk)] = torch.tensor(chunk)
        dev = engine.device
        _, lg, *_ = engine._extend(
            cache, valid, ids.to(dev), torch.tensor([len(chunk)], device=dev),
            torch.tensor([seq], device=dev), slot,
            torch.Generator(dev).manual_seed(0), 1.0, 1.0, False)
        top2 = torch.topk(lg[0], 2).values
        margin = (top2[0] - top2[1]).item()
        check(margin < INT4_LOGIT_TOL, f"spec conv: the speculative turn "
              f"parts from the plain turn at token {i} where the plain "
              f"top-2 margin is {margin}")
        line = (f"the same first {i} of {len(got)} tokens, then {got[i]} for "
                f"{want[i]}, where the plain session's top-2 margin is "
                f"{margin:.4f} (bar {INT4_LOGIT_TOL})")
    print(f"spec conv: a follow-up turn through PrefixCache.spawn("
          f"speculative=True) (SpecChatSession, eager rounds, threshold 0): "
          f"{len(got)} tokens in {rounds} rounds, {dt:.3f} s wall; against "
          f"the plain spawn's turn: {line}; launches "
          + " ".join(f"{k} {n}" for k, n in counts.items()) + f", on {smi}; "
          f"{time.perf_counter() - t_conv:.1f} s wall")
    check(counts["K5"] > 0, "spec conv: no K5 launch")
    del engine, pc, sess
    return counts


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
                     f" ms" + attention_rates(k1_t))
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
                     f"in the layer; {k3_traffic_text(q, k, valid, False)}); "
                     f"bound "
                     f"{k3_t['bound_ms']:.4f} ms ({k3_t['bound_by']}, "
                     f"{need / 1e6:.2f} MB of valid slots), library "
                     f"{k3_t['library_ms']:.4f} ms")
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


# The serving paths' depth, at full width: Valley-7B at 8 of its 32 layers
# and Valley-13B at 10 of its 40, so that the script keeps well inside its
# time limit on the slower card hosts (PERF.md §6).  The kernel phases keep
# the full depth's shapes and per-token sums.
SERVE_LAYERS = {"valley_7b": 8, "valley_13b": 10}


def serving_depth(cfg, model: str = "valley_7b"):
    """``cfg`` cut to `SERVE_LAYERS`'s depth for ``model``."""
    return cfg.replace(text=dataclasses.replace(
        cfg.text, num_hidden_layers=SERVE_LAYERS[model]))


K1_SRC = dict(name="flash_fwd", route="cuda",
              source="valley_tpu_torch/csrc/flash_fwd.cu",
              replaces="valley_tpu/ops/flash_attention.py:54")
K2_SRC = dict(name="flash_bwd", route="cuda",
              source="valley_tpu_torch/csrc/flash_bwd.cu",
              replaces="valley_tpu/ops/flash_attention.py:183")
K3_SRC = dict(route="cuda", source="valley_tpu_torch/csrc/decode_attn.cu",
              replaces="valley_tpu/ops/decode_pallas.py:68")


def serve_path(smi: str, gen, work: Path) -> list:
    """The bf16 serving path: K1 and K3 against their plain versions, then
    the slice.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec

    k1_err, k1_t = k1_phase(flash_cases(gen))
    k3_err, k3_t = k3_phase(gen, SMAX, PROMPT_LEN, BUCKET)
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers, steps = cfg.text.num_hidden_layers, NEW_TOKENS - 1
    k6_err, k6_t, _ = k6_phase(gen, K6_SHAPES_SERVE, 1, layers)
    # a verify round's 9 rows, and a 16-row pool step
    k6v_err, k6v_t, _ = k6_phase(gen, K6_SHAPES_SERVE, 9, layers)
    (k6w_err, k6w_t, _), k6w_n = counted(
        {"K6": bf16_matvec},
        lambda: k6_phase(gen, K6_SHAPES_SERVE, 16, layers))
    cfg = serving_depth(cfg)
    layers = cfg.text.num_hidden_layers
    params = random_weights(cfg)
    counts = serve_slice("slice", cfg, params, smi,
                         torch.bfloat16, {
                             "K1": (flash_attention, layers),
                             "K3": (decode_attention_stacked, layers * steps),
                             "K6": (bf16_matvec, 7 * layers * steps
                                    + NEW_TOKENS),
                             "K4": (int8_matvec, 0)}, LOGIT_TOL,
                         same_token=True, sampled=True)
    sl = spec_slice("spec slice", cfg, params, smi, torch.bfloat16, {
        "K1": flash_attention, "K3": decode_attention_stacked,
        "K6": bf16_matvec, "K4": int8_matvec}, {
        "K1": (0, layers), "K3": (0, 0), "K6": (7 * layers + 1, 1),
        "K4": (0, 0)}, LOGIT_TOL)
    spec_sampled_check("spec slice", sl)
    spec_counts = sl["counts"]
    del sl
    gc.collect()
    full_acceptance(cfg, params, smi)
    return [{**K1_SRC, "path": "serve", "launches": counts["K1"],
             "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn", "path": "serve",
             "launches": counts["K3"], "max_abs_err": k3_err, **k3_t},
            {**K6_SRC, "name": "bf16_matvec_serve", "path": "serve",
             "launches": counts["K6"], "max_abs_err": k6_err, **k6_t},
            {**K1_SRC, "name": "flash_fwd_spec", "path": "serve_spec",
             "launches": spec_counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K6_SRC, "name": "bf16_matvec_verify", "path": "serve_spec",
             "launches": spec_counts["K6"], "max_abs_err": k6v_err,
             **k6v_t},
            {**K6_SRC, "name": "bf16_matvec_B16",
             "path": "serve, GEMV phase only (a 16-row pool step)",
             "launches": k6w_n["K6"], "max_abs_err": k6w_err, **k6w_t}]


def serve_int8_path(smi: str, gen, work: Path) -> list:
    """The int8 serving flagship: K1 at the prefill shape, K4 and K3's
    int8-cache branch against their plain versions, then the slice on the
    same random weights fused and quantized to int8a8 on the card, with an
    int8 KV cache.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec, quantize_llama_params

    k1_err, k1_t = k1_phase(flash_cases(gen)[:1])
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers, steps = cfg.text.num_hidden_layers, NEW_TOKENS - 1
    k4_err, k4_t = k4_phase(gen, layers)
    k4v_err, k4v_t = k4_phase(gen, layers, 9)
    (k4w_err, k4w_t), k4w_n = counted({"K4": int8_matvec},
                                      lambda: k4_phase(gen, layers, 16))
    k3q_err, k3q_t = k3_int8_phase(decode_int8_cases(gen, SMAX, PROMPT_LEN,
                                                     BUCKET))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_depth(cfg)
    layers = cfg.text.num_hidden_layers
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
    sl = spec_slice("int8 spec slice", cfg, params, smi, torch.int8, {
        "K1": flash_attention, "K3-int8": decode_attention_stacked,
        "K4": int8_matvec, "K6": bf16_matvec}, {
        "K1": (0, layers), "K3-int8": (0, 0), "K4": (4 * layers + 1, 1),
        "K6": (0, 0)}, INT8_LOGIT_TOL)
    spec_counts = sl["counts"]
    del sl
    k4_src = {"route": "cuda",
              "source": "valley_tpu_torch/csrc/int8_matvec.cu",
              "replaces": "valley_tpu/ops/quant.py:455"}
    return [{**K1_SRC, "name": "flash_fwd_int8", "path": "serve_int8",
             "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn_int8", "path": "serve_int8",
             "launches": counts["K3-int8"], "max_abs_err": k3q_err,
             **k3q_t},
            {**k4_src, "name": "int8_matvec", "path": "serve_int8",
             "launches": counts["K4"], "max_abs_err": k4_err, **k4_t},
            {**K1_SRC, "name": "flash_fwd_int8_spec",
             "path": "serve_int8_spec", "launches": spec_counts["K1"],
             "max_abs_err": k1_err, **k1_t},
            {**k4_src, "name": "int8_matvec_verify",
             "path": "serve_int8_spec", "launches": spec_counts["K4"],
             "max_abs_err": k4v_err, **k4v_t},
            {**k4_src, "name": "int8_matvec_B16",
             "path": "serve_int8, GEMV phase only (a 16-row pool step)",
             "launches": k4w_n["K4"], "max_abs_err": k4w_err, **k4w_t}]


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


def k5_phase(gen, layers: int, rows: int = 1) -> tuple:
    """K5 against its plain version on the five Valley-13B weights at B =
    ``rows`` (at B = 1 also at 8 rows and at the row limit with G = 108 and
    on 7B's G = 86 at an odd F, and a planted fault: the group scales
    shifted by one group; at more rows, each row bit-equal to the same row
    alone); each 13B weight timed walking copies of it past the 50 MB L2.
    Returns (max error, times per call averaged over one decode token's (or
    verify round's) GEMVs: ``layers`` x the four layer weights, then
    lm_head)."""
    from valley_tpu_torch.ops.quant import (MAX_ROWS, int4_matvec,
                                            int4_matvec_plain)

    cases = [(f"13b_{n}_B{rows}", rows, k, f, g)
             for n, k, f, g in K5_SHAPES_13B]
    if rows == 1:
        cases += [("rows8_K13824_G108", 8, 13824, 5120, 128),
                  (f"rows{MAX_ROWS}_K13824_G108", MAX_ROWS, 13824, 5120, 128),
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
        if b > 1 and name.startswith("13b_wqkv"):
            line += rows_alone_text(int4_matvec, x, w, scale)
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
            # once; the products at the card's bf16 tensor-core peak
            n_bytes = w.numel() + 2 * b * k + 2 * scale.numel() + 4 * b * f
            add_bound(t, bound(n_bytes, 2 * b * k * f), f"K5 {name}")
            t["library_ms"], label = library_int4_matvec_ms(x, w, scale, n,
                                                            20, ref)
            per_weight[name.split(f"_B{rows}")[0][4:]] = t
            lib = "none" if t["library_ms"] is None else \
                f"{t['library_ms']:.4f} ms"
            line += (f" {fmt_times(t)} ({w.numel() / t['ms'] / 1e6:.1f} GB/s "
                     f"of packed weights); bound {t['bound_ms']:.4f} ms ("
                     f"{t['bound_by']}, {n_bytes / 1e6:.2f} MB), "
                     f"{bound_share(t)}; library {lib} ({label})")
        print(line)
        del x, w, scale, out, ref
    calls = 4 * layers + 1
    token = {key: None if any(t[key] is None for t in per_weight.values())
             else layers * sum(per_weight[n][key] for n, *_ in
                               K5_SHAPES_13B[:4]) + per_weight["lm_head"][key]
             for key in TIME_KEYS}
    avg = {key: None if v is None else v / calls for key, v in token.items()}
    avg["bound_by"] = dominant_bound(per_weight, layers)
    avg["library_call"] = label
    avg["rows"] = rows
    lib = "none" if token["library_ms"] is None else \
        f"{token['library_ms']:.4f} ms"
    print(f"K5 int4_matvec per decode token at B{rows} ({calls} calls: "
          f"{layers} x "
          f"wqkv, wo, w_gateup, w_down, then lm_head): device "
          f"{token['ms']:.4f} ms vs plain {token['plain_ms']:.4f} ms; bound "
          f"{token['bound_ms']:.4f} ms, {bound_share(avg)}; library "
          f"{lib}")
    return err_max, avg


# The conversation slice, BASELINE.json config 3 (Valley-13B multi-turn
# video conversation), on the int4 slice's weights: an Engine with
# batch_infer's buckets and max_new_tokens, so a session cache holds
# 512 + 256 + 4 * (256 + 64) + 4 = 2052 slots (ChatSession's default room,
# engine.py:883-890), an int8 cache, three turns of 64 greedy tokens
CONV_BUCKETS = (512, 1024, 2048)
CONV_MAX_NEW = 256
CONV_SMAX = 512 + CONV_MAX_NEW + 4 * (CONV_MAX_NEW + 64) + 4
# the follow-up questions, framed as run_valley_conv frames a later turn
CONV_QUESTIONS = ("And then?", "Describe the second half of the clip.")
# a second session of 512 + 256 + 16 + 4 = 788 slots compacts at turn 3
CONV_COMPACT_EXTRA = 16
# decode steps profiled after each turn's prefill or extend
CONV_PROFILE_STEPS = 4
# PrefixCache: a 60-token system prompt, then the video, then questions
PREFIX_SYSTEM, PREFIX_NEW = 60, 16
# The conversation's logits through the kernels (K5, then K3-int8 and K5)
# against the same session state run on the plain versions, at turn 2's
# extend and three teacher-forced decode steps; and turn 3's extend from a
# compacted cache against the same extend on the uncompacted one.  The
# extend itself is plain attention over the int8 cache dequantized, and
# products of more than 8 rows are the dequantized int4 ones, on both
# sides, so they differ by K5's lm_head there and by K3-int8 and K5 in
# decode; compacting moves the extend's softmax sums into another order.
# Readings of this script on an H100 80GB HBM3 at 700 W: 4.8e-07 at the
# extend, 0.070-0.081 at the decode steps, 0.077 compacted vs not; the bar
# is about twice that.
CONV_LOGIT_TOL = 0.16


def follow_up_ids(question: str) -> list:
    """A later turn's ids as run_valley_conv makes them: the v1 template's
    framing, the byte tokenizer, no BOS."""
    from valley_tpu_torch.conversation import conv_templates
    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    conv, tk = conv_templates["v1"], ByteFallbackTokenizer()
    ids = tk.encode(f" {conv.roles[0]}: {question}{conv.sep}"
                    f"{conv.roles[1]}:")
    return ids[1:] if ids and ids[0] == tk.bos_token_id else ids


def clone_state(state) -> tuple:
    """A copy of a ChatSession's state (cache, valid, length, slot,
    pending) that the session's later writes do not reach."""
    from valley_tpu_torch.models.llama import KVCache

    cache, valid, seq, slot, pending = state
    return (KVCache(*(None if x is None else x.clone() for x in (
        cache.k, cache.v, cache.k_scale, cache.v_scale))), valid.clone(),
        seq, slot, pending)


def converse(sess, turns, snapshots=None) -> list:
    """Each turn through ``sess.chat`` (64 greedy tokens, no stop), the
    state before it copied into ``snapshots`` (None before the first).
    Returns [(reply, first-token s, wall s)], host clock around ``chat``."""
    out = []
    for ids, images in turns:
        if snapshots is not None:
            snapshots.append(clone_state(sess._state) if sess.started
                             else None)
        first = []

        def on_token(_):
            if not first:
                first.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = sess.chat(ids, images=images, eos_ids=[-1],
                          on_token=on_token)
        out.append((reply, first[0] - t0, time.perf_counter() - t0))
    return out


def compare_logits(tag: str, points, tol: float) -> None:
    """(where, kernels' logits, plain logits) at each point: within
    ``tol``; the same greedy token wherever the plain path's top-2 margin
    exceeds the paths' difference."""
    for where, lk, lp in points:
        check(bool(torch.isfinite(lk).all()), f"{tag}: {where} not finite")
        diff = max_err(lk, lp)
        top2 = torch.topk(lp, 2).values
        margin = (top2[0] - top2[1]).item()
        tk, tp = int(lk.argmax()), int(lp.argmax())
        checked = "checked" if margin > diff else \
            "not checked: under the difference"
        print(f"{tag}: {where} logits max abs diff {diff:.4e} (tol {tol}; "
              f"max |logit| {lp.abs().max().item():.3f}), greedy token "
              f"{tk} vs {tp} (top-2 margin {margin:.4f}, {checked})")
        check(diff <= tol, f"{tag}: {where} logits beyond tolerance")
        if margin > diff:
            check(tk == tp, f"{tag}: {where}: different greedy tokens")


def conv_slice(cfg, params, smi: str) -> tuple:
    """The conversation slice on the int4 slice's weights: a warm-up, then
    the main path, three turns of one `ChatSession` (bench.py's video
    question, two follow-ups) with the launches of K1, K3-int8 and K5
    against the session's own count of prefills, extends and decode steps;
    per turn the first token's wall, the prefill's or extend's device time
    and decode wall and device busy per token; the time to first token if
    the whole conversation were prefilled again; kernels vs plain logits at
    turn 2; a session that compacts; two `PrefixCache` spawns.  Returns
    (counts, the session's final cache and valid mask)."""
    from valley_tpu_torch.inference.engine import (ChatSession, Engine,
                                                   GenerationConfig,
                                                   PrefixCache,
                                                   _compact_cache,
                                                   _grow_cache)
    from valley_tpu_torch.ops.attention import PLAIN
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int4_matvec, int8_matvec
    from valley_tpu_torch.tools.decode_attn_lab import conversation_valid

    tag = "conv"
    layers, vocab = cfg.text.num_hidden_layers, cfg.text.vocab_size
    engine = Engine(cfg, params, buckets=CONV_BUCKETS,
                    max_new_tokens=CONV_MAX_NEW, cache_dtype=torch.int8)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False)
    prompt, frames = bench_request(cfg, BUCKET)
    turns = [(prompt, frames)] + [(follow_up_ids(q), None)
                                  for q in CONV_QUESTIONS]
    # warm-up: the extend's shapes, once
    converse(ChatSession(engine, GenerationConfig(max_new_tokens=4)), turns)

    kernels = {"K1": flash_attention, "K3-int8": decode_attention_stacked,
               "K5": int4_matvec, "K4": int8_matvec, "K6": bf16_matvec}
    sess = ChatSession(engine, gen)
    snaps: list = []
    for fn in kernels.values():
        fn.launches = 0
    results = converse(sess, turns, snaps)               # the main path
    counts = {k: fn.launches for k, fn in kernels.items()}
    replies = [r for r, _, _ in results]
    check((sess.prefills, sess.extends, sess.decode_steps)
          == (1, 2, 3 * (NEW_TOKENS - 1)),
          f"{tag}: session ran {sess.prefills} prefills, {sess.extends} "
          f"extends, {sess.decode_steps} decode steps")
    want = {"K1": layers * sess.prefills,
            "K3-int8": layers * sess.decode_steps,
            "K5": (4 * layers + 1) * sess.decode_steps + sess.prefills
            + sess.extends, "K4": 0, "K6": 0}
    for k, n in want.items():
        check(counts[k] == n, f"{tag}: {k} launched {counts[k]} times, "
              f"want {n}")
    for r in replies:
        check(len(r) == NEW_TOKENS and all(0 <= t < vocab for t in r),
              f"{tag}: a reply of {len(r)} tokens or bad ids")
    chunks = [len(ids) + 1 for ids, _ in turns[1:]]   # + the pending token
    cache, valid = sess._state[:2]
    check(cache.max_len == CONV_SMAX, f"{tag}: session cache {cache.max_len}")
    check(torch.equal(valid.cpu(), conversation_valid(
        CONV_SMAX, len(prompt), BUCKET, chunks, NEW_TOKENS)),
        f"{tag}: the session's valid mask")
    print(f"{tag}: Valley-13B int4gp, int8 cache, session of {CONV_SMAX} "
          f"slots ({int(valid.sum())} valid after 3 turns); turn 1 the "
          f"{len(prompt)}-token video question, turns 2-3 chunks of "
          f"{chunks} tokens; {NEW_TOKENS} greedy tokens a turn; session "
          f"counts: {sess.prefills} prefill, {sess.extends} extends, "
          f"{sess.decode_steps} decode steps; launches " + " ".join(
              f"{k} {n}" for k, n in counts.items()))

    # per turn: the prefill's or extend's device time and decode device
    # busy per token, each profiled on a copy of the state before the turn
    for i, ((ids, images), snap, (_, first, wall)) in enumerate(
            zip(turns, snaps, results)):
        s = ChatSession(engine, gen)
        s._state = snap
        start_dev = profile_device(lambda: s._start_turn(ids, images))[0]
        tok, _, c, v, seq, slot = s._start_turn(ids, images)
        dec_dev, top, _ = profile_device(lambda: engine._decode(
            c, v, tok, slot, torch.tensor([seq], device="cuda"), s.generator,
            gen, CONV_PROFILE_STEPS))
        share = {k: sum(t for n, t in top if any(
            key in n for key in KERNEL_NAMES[k])) / dec_dev
            for k in ("K3-int8", "K5")}
        dec_dev /= CONV_PROFILE_STEPS
        wall_tok = (wall - first) / (NEW_TOKENS - 1) * 1e3
        inside = ", ".join(f"{k} {100 * f:.1f}%" for k, f in share.items())
        what = "video -> first token" if i == 0 else "follow-up -> first token"
        print(f"{tag} turn {i + 1}: {what} {first * 1e3:.2f} ms wall, "
              f"{'prefill' if i == 0 else 'extend'} device {start_dev:.2f} "
              f"ms; decode wall {wall_tok:.3f} ms/token, device busy "
              f"{dec_dev:.3f} ms/token (idle share "
              f"{1 - dec_dev / wall_tok:.3f}; of the decode device time: "
              f"{inside}) on {smi}")
        del s, c, v

    # the reference's way: the whole conversation prefilled again each turn
    full = prompt
    engine.prefill([prompt + replies[0] + turns[1][0]], frames, gen)  # warm
    for i in (1, 2):
        full = full + replies[i - 1] + turns[i][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = engine.prefill([full], frames, gen)
        int(st.token[0])
        print(f"{tag} turn {i + 1}: re-prefilling the {len(full)}-token "
              f"conversation (bucket {st.bucket}) instead: first token "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall, against "
              f"{results[i][1] * 1e3:.2f} ms through the session")
        del st

    # kernels vs plain on the state before turn 2: its extend, then three
    # decode steps fed turn 2's tokens
    plain = Engine(cfg, params, buckets=CONV_BUCKETS,
                   max_new_tokens=CONV_MAX_NEW, cache_dtype=torch.int8,
                   attention=PLAIN)
    forced = replies[1][:DECODE_CHECK_STEPS]
    logits = []
    for eng in (engine, plain):
        s = ChatSession(eng, gen)
        s._state = clone_state(snaps[1])
        _, lg, c, v, seq, slot = s._start_turn(turns[1][0], None)
        logits.append([lg[0]] + decode_logits(eng, c, v, slot, seq, forced))
        del s, c, v
    compare_logits(f"{tag} kernels vs plain", [
        ("turn 2 extend" if i == 0 else f"turn 2 decode step {i}", a, b)
        for i, (a, b) in enumerate(zip(*logits))], CONV_LOGIT_TOL)
    del plain, logits, snaps

    # a session too short for turn 3 without compaction
    cs = ChatSession(engine, gen, extra_slots=CONV_COMPACT_EXTRA)
    r1 = cs.chat(prompt, images=frames, eos_ids=[-1])
    check(r1 == replies[0], f"{tag} compaction: turn 1 differs from the "
          "main session's")
    cs.chat(turns[1][0], eos_ids=[-1])
    snap3 = clone_state(cs._state)
    r3 = cs.chat(turns[2][0], eos_ids=[-1])
    check(cs.compactions == 1 and len(r3) == NEW_TOKENS,
          f"{tag} compaction: {cs.compactions} compactions")
    c3, v3 = clone_state(snap3)[:2]
    packed, _, n_valid = _compact_cache(c3, v3)
    keep = v3[0].nonzero()[:, 0]
    check(int(n_valid[0]) == len(keep) and all(
        torch.equal(getattr(packed, n)[:, 0, :len(keep)],
                    getattr(c3, n)[:, 0, keep])
        for n in ("k", "v", "k_scale", "v_scale")),
        f"{tag} compaction: the packed slots are not the valid ones in order")
    ext = []
    for grow in (False, True):
        s = ChatSession(engine, gen)
        st = clone_state(snap3)
        if grow:
            st = (*_grow_cache(st[0], st[1], CONV_SMAX), *st[2:])
        s._state = st
        ext.append(s._start_turn(turns[2][0], None)[1][0])
        check(s.compactions == (0 if grow else 1), f"{tag} compaction")
        del s, st
    print(f"{tag} compaction: a session of {snap3[0].max_len} slots, at slot "
          f"{snap3[3]} before turn 3, packs its {len(keep)} live slots to the "
          f"front (K, V and scales in order, bit for bit)")
    compare_logits(f"{tag} compaction", [
        ("turn 3 extend, compacted vs not", ext[0], ext[1])], CONV_LOGIT_TOL)
    del cs, snap3, c3, v3, packed, ext

    # PrefixCache: the system prompt and the video prefilled once, two
    # questions spawned from it, and a third spawn repeating the first
    rng = np.random.default_rng(2)
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    prefix = [1] + rng.integers(5, 30000, PREFIX_SYSTEM).tolist() + span
    pgen = GenerationConfig(max_new_tokens=PREFIX_NEW, do_sample=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc = PrefixCache(engine, prefix, images=frames, gen=pgen)
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t0
    frag = clone_state((pc._frag, pc._valid, 0, 0, None))[0]
    questions = [follow_up_ids("What is in the video?"),
                 follow_up_ids("Which colour dominates?")]
    answers, firsts = [], []
    for q in questions + questions[:1]:
        out = converse(pc.spawn(), [(q, None)])
        answers.append(out[0][0])
        firsts.append(out[0][1])
    check(all(len(a) == PREFIX_NEW and all(0 <= t < vocab for t in a)
              for a in answers), f"{tag} prefix: replies")
    check(answers[2] == answers[0], f"{tag} prefix: a spawn after another "
          "session ran answers differently")
    check(all(torch.equal(getattr(pc._frag, n), getattr(frag, n))
              for n in ("k", "v", "k_scale", "v_scale")),
          f"{tag} prefix: a session wrote the stored fragment")
    engine.prefill([prefix + questions[0]], frames, pgen)     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    int(engine.prefill([prefix + questions[0]], frames, pgen).token[0])
    full_s = time.perf_counter() - t0
    print(f"{tag} prefix: {len(prefix)}-token prefix (system prompt, video) "
          f"prefilled once in {prefix_s * 1e3:.2f} ms wall; spawned "
          f"questions of {[len(q) for q in questions]} tokens: first token "
          f"{', '.join(f'{f * 1e3:.2f}' for f in firsts)} ms wall, against "
          f"{full_s * 1e3:.2f} ms prefilling prefix and question together; "
          f"the third spawn (the first question again, after the second "
          f"ran) answers as the first; the fragment unchanged")
    del pc, frag
    return counts, sess._state[0], sess._state[1]


def lab_phase(x, smi: str, path: str) -> list:
    """T4-T7 (every hc, every stage) and K3 (bf16; int8 on the int8 cache
    ``x`` came from) on the lab input ``x``: one pass of every variant over
    every layer with the launches counted; each held against its plain
    version with its planted fault (`decode_attn_lab.check`), T7 stage 3
    against K3's function; each timed walking the layers beside its plain
    version, its bound and SDPA's forward on the same layout.  Returns the
    kernels entries."""
    from valley_tpu_torch.tools import decode_attn_lab as lab

    variants = lab.variants(x)
    n_layers, b, s, h, d = x.k.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wrappers = {v.wrapper for v in variants}
    for w in wrappers:
        w.launches = 0
    for v in variants:                  # the lab's pass over the layers
        for li in range(n_layers):
            v.run(li)
    torch.cuda.synchronize()
    launches = {w: w.launches for w in wrappers}
    per = {w: sum(v.wrapper is w for v in variants) * n_layers
           for w in wrappers}
    for w in wrappers:
        check(launches[w] == per[w], f"lab {x.name}: {w.__name__} launched "
              f"{launches[w]} times in the pass, want {per[w]}")
    n_valid = int(x.valid.sum())
    print(f"lab {x.name}: L{n_layers} B{b} S{s} H{h} D{d}, {n_valid} valid "
          f"slots, {sms} SMs; one pass of every variant over the layers: "
          + ", ".join(f"{w.__name__} {n}" for w, n in launches.items()))
    # SDPA's forward, a yardstick only, on each layout at the middle layer
    library = {
        "head-major": library_attention_ms(
            x.q, x.k_hm[x.li].transpose(1, 2), x.v_hm[x.li].transpose(1, 2),
            x.valid, False, iters=20),
        "slot-major": library_attention_ms(x.q, x.k[x.li], x.v[x.li],
                                           x.valid, False, iters=20)}
    entries, stage_ms = [], {}
    for v in variants:
        err, tol, fault = lab.check(x, v)
        run, plain = lab.walk(v.run, n_layers), lab.walk(v.plain, n_layers)
        ms, top, _ = profile_device(run, 20)
        traced = [n for n, _ in top]
        check(any(key in n for n in traced for key in KERNEL_NAMES[
            v.name[:2]]), f"lab {x.name} {v.name}: its kernel is not in the "
            f"profiler's trace ({traced})")
        t = {"ms": ms, "plain_ms": profile_device(plain, 20)[0],
             "loop_ms": time_ms(run, 20), "plain_loop_ms": time_ms(plain, 20)}
        need = x.need_bytes(v)
        add_bound(t, bound(need, x.need_flops()), f"lab {x.name} {v.name}")
        layout = "head-major" if v.name[:2] in ("T4", "T5", "T6") \
            else "slot-major"
        t["library_ms"] = library[layout]
        t["library_call"] = f"SDPA forward, {layout} layer in bf16"
        gbps = x.layer_bytes(v) / t["ms"] / 1e6
        traffic = ""
        if v.name.startswith("K3"):
            traffic = "; " + k3_traffic_text(x.q, x.k, x.valid,
                                             v.name == "K3-int8")
        print(f"lab {x.name} {v.name}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); {v.fault_what} instead: {fault:.3e} (must fail); "
              f"{fmt_times(t)}; {gbps:.1f} GB/s of the layer's "
              f"{x.layer_bytes(v) / 1e6:.2f} MB of K/V{traffic}; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{need / 1e6:.2f} MB of valid slots); "
              f"library {t['library_ms']:.4f} ms; {lab.grid_text(v, sms)}")
        entry = {"name": f"{v.key}_{x.name}", "route": "cuda",
                 "source": v.source, "replaces": v.replaces, "path": path,
                 "launches": n_layers, "max_abs_err": err, **t,
                 "grid_blocks": v.blocks, "combine_blocks": v.combine,
                 "blocks_per_sm": v.blocks / sms, "read_gb_per_s": gbps}
        if v.name.startswith("T7"):
            stage_ms[int(v.name[-1])] = t
        else:
            entries.append(entry)
        if v.name == "T7 stage 3":
            t7 = entry
    errs = lab.stage3_against_k3(x)
    print(f"lab {x.name}: T7 stage 3 against decode_attention_plain with the "
          f"matching mask {errs[0]:.3e}, against K3 {errs[1]:.3e}")
    print("lab " + lab.stage_line(x.name, {k: t["ms"] for k, t in
                                           stage_ms.items()}) + f" on {smi}")
    t7["launches"] = len(lab.STAGES) * n_layers
    t7["stages_ms"] = {str(k): t["ms"] for k, t in stage_ms.items()}
    t7["stages_plain_ms"] = {str(k): t["plain_ms"]
                             for k, t in stage_ms.items()}
    entries.append(t7)
    return entries


def serve_int4_path(smi: str, gen, work: Path) -> list:
    """Valley-13B served int4gp, the JAX package's one-card 13B setup
    (bench.py:216-231,272-274; worker --quantize int4gp --fused --kv-cache
    int8): K5, and K1 and K3-int8 at the 13B shapes, against their plain
    versions, then the slice on random weights fused and quantized on the
    card (group-128 scales, nibble-packed), with an int8 KV cache; then,
    on the same weights, the conversation (`conv_slice`), whose cache it
    saves in ``work`` for the lab.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_13b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
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
    k5v_err, k5v_t = k5_phase(gen, layers, 9)
    (k5w_err, k5w_t), k5w_n = counted({"K5": int4_matvec},
                                      lambda: k5_phase(gen, layers, 16))
    k1_err, k1_t = k1_phase(flash_cases(gen, text.num_attention_heads,
                                        "13b")[:1])
    k3q_err, k3q_t = k3_int8_phase(decode_int8_cases(
        gen, SMAX, PROMPT_LEN, BUCKET, layers, text.kv_heads, "13b")[:1])
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_depth(cfg, "valley_13b")
    text = cfg.text
    layers = text.num_hidden_layers
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
    walls = {}
    counts = serve_slice("int4 slice", cfg, params, smi, torch.int8, {
        "K1": (flash_attention, layers),
        "K3-int8": (decode_attention_stacked, layers * steps),
        "K5": (int4_matvec, 4 * layers * steps + NEW_TOKENS),
        "K4": (int8_matvec, 0), "K6": (bf16_matvec, 0)}, INT4_LOGIT_TOL,
        same_token=True, walls=walls)
    sl = spec_slice("int4 spec slice", cfg, params, smi, torch.int8, {
        "K1": flash_attention, "K3-int8": decode_attention_stacked,
        "K5": int4_matvec, "K4": int8_matvec, "K6": bf16_matvec}, {
        "K1": (0, layers), "K3-int8": (0, 0), "K5": (4 * layers + 1, 1),
        "K4": (0, 0), "K6": (0, 0)}, INT4_LOGIT_TOL)
    spec_counts = sl["counts"]
    del sl
    gc.collect()
    conv_spec = spec_conv(cfg, params, smi)
    entries = [{**K1_SRC, "name": "flash_fwd_int4", "path": "serve_int4",
                "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
               {**K3_SRC, "name": "decode_attn_int4", "path": "serve_int4",
                "launches": counts["K3-int8"], "max_abs_err": k3q_err,
                **k3q_t},
               {**K5_SRC, "name": "int4_matvec", "path": "serve_int4",
                "launches": counts["K5"], "max_abs_err": k5_err, **k5_t,
                "request_first_token_ms": walls["first_token_ms"],
                "request_decode_ms_per_token":
                    walls["decode_ms_per_token"]},
               {**K1_SRC, "name": "flash_fwd_int4_spec",
                "path": "serve_int4_spec", "launches": spec_counts["K1"],
                "max_abs_err": k1_err, **k1_t},
               {**K5_SRC, "name": "int4_matvec_verify",
                "path": "serve_int4_spec", "launches": spec_counts["K5"],
                "max_abs_err": k5v_err, **k5v_t},
               {**K5_SRC, "name": "int4_matvec_B16",
                "path": "serve_int4, GEMV phase only (a 16-row pool step)",
                "launches": k5w_n["K5"], "max_abs_err": k5w_err, **k5w_t},
               {**K5_SRC, "name": "int4_matvec_spec_conv",
                "path": "serve_conv_spec", "launches": conv_spec["K5"],
                "max_abs_err": k5v_err, **k5v_t}]

    # the conversation on the same weights; its cache and launches go to
    # the lab's process (`lab_conv_path`)
    t0 = time.perf_counter()
    conv_counts, cache, valid = conv_slice(cfg, params, smi)
    torch.save({"k": cache.k, "k_scale": cache.k_scale, "v": cache.v,
                "v_scale": cache.v_scale, "valid": valid,
                "counts": conv_counts}, work / CONV_CACHE)
    print(f"conv: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return entries + [
        {**K1_SRC, "name": "flash_fwd_conv", "path": "serve_conv",
         "launches": conv_counts["K1"], "max_abs_err": k1_err, **k1_t},
        {**K5_SRC, "name": "int4_matvec_conv", "path": "serve_conv",
         "launches": conv_counts["K5"], "max_abs_err": k5_err, **k5_t}]


def lab_conv_path(smi: str, gen, work: Path) -> list:
    """The decode-attention lab on the conversation's cache, which the
    int4 path's process saved: every lab kernel, and the conversation's
    K3-int8 entry with that shape's reading and the conversation's
    launches."""
    from valley_tpu_torch.tools import decode_attn_lab as lab

    saved = torch.load(work / CONV_CACHE, map_location="cuda")
    x = lab.conv_inputs(saved["k"], saved["k_scale"], saved["v"],
                        saved["v_scale"], saved["valid"], gen)
    entries = lab_phase(x, smi, "serve_conv, lab on the conversation's cache")
    k3c = next(e for e in entries if e["name"] == "decode_attn_int8_lab_conv")
    return entries + [
        {**K3_SRC, "name": "decode_attn_conv", "path": "serve_conv",
         "launches": saved["counts"]["K3-int8"], **{
             k: k3c[k] for k in ("max_abs_err", "bound_by", "library_call")
             + TIME_KEYS}}]


def lab_tools_path(smi: str, gen, work: Path) -> list:
    """The decode-attention lab at the TPU tools' shape."""
    from valley_tpu_torch.tools import decode_attn_lab as lab

    return lab_phase(lab.tools_inputs(gen), smi,
                     "serve_conv, lab at the tools' shape")


K5_SRC = dict(name="int4_matvec", route="cuda",
              source="valley_tpu_torch/csrc/int4_matvec.cu",
              replaces="tools/exp_int4_group.py:91")
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
GEMV_NAMES = ("int8_matvec", "int4_matvec", "int4_matvec_conv",
              "bf16_matvec", "bf16_matvec_serve", "bf16_matvec_round",
              "bf16_matvec_verify", "bf16_matvec_B16", "bf16_matvec_B8",
              "int8_matvec_verify",
              "int8_matvec_B16", "int4_matvec_verify", "int4_matvec_B16",
              "int4_matvec_spec_conv")


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
        alone = rows_alone_text(bf16_matvec, x, w, kf) \
            if rows > 8 and name == shapes[0][0] else ""
        ws = [w] + [w.clone() for _ in range(
            -(-TIMING_BYTES // (2 * w.numel())) - 1)]
        it = iter(range(10 ** 9))
        t = kernel_times(
            lambda: bf16_matvec(x, ws[next(it) % len(ws)], kf,
                                round_products),
            lambda: bf16_matvec_plain(x, ws[next(it) % len(ws)], kf,
                                      round_products), iters=10)
        # bytes: the weight, x and the fp32 output once; the products at
        # the bf16 tensor-core peak
        n_bytes = 2 * w.numel() + 2 * rows * k + 4 * rows * f
        add_bound(t, bound(n_bytes, 2 * rows * k * f), f"{tag} {name}")
        t["library_ms"] = library_linear_ms(x, ws, kf, 10)
        per_weight[name] = t
        print(f"{tag} {name} B{rows} ({'(K, F)' if kf else '(F, K)'} "
              f"{k}x{f}): max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{fmt_times(t)} ({2 * w.numel() / t['ms'] / 1e6:.1f} GB/s of "
              f"weights); bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{n_bytes / 1e6:.2f} MB), library {t['library_ms']:.4f} ms "
              f"(cuBLAS bf16){alone}")
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
          f"{step['bound_ms']:.4f} ms ({step['bound_ms'] / step['ms']:.3f} "
          f"of it); library {step['library_ms']:.4f} ms (cuBLAS bf16; K6 "
          f"{step['ms'] / step['library_ms']:.3f}x its time)")
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


def pool_decode_int8_case(gen, smax: int, layers: int = 32, lens=None,
                          hole=(505, 1532)):
    """K3-int8 at a pool's shape: a row for each of ``lens`` of an int8
    cache of ``smax`` slots, quantized by `_quantize_kv` from N(0, 1) bf16
    K/V, each row valid up to its length (decode writes right after the
    prompt, so no row has a hole).  By default the batched slice's rows:
    video rows of 473 + 32 tokens, text rows of 40 and 1500 + 32, with
    the 'hole' planted as a fault [505, 1532), valid only in the last
    row."""
    from valley_tpu_torch.models.llama import _quantize_kv

    if lens is None:
        lens = [505] * (BATCH_ROWS - 2) + [72, 1532]
    b, h, d = len(lens), 32, 128
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
    lens = torch.tensor(lens, device="cuda")
    valid = torch.arange(smax, device="cuda")[None, :] < lens[:, None]
    return (f"7b_pool_decode_L{layers}_B{b}_S{smax}_D128", *out, 17, valid,
            hole)


# batch_infer's defaults (valley_tpu/inference/batch_infer.py:257,272-287):
# buckets, the engine's max_new_tokens (the pool's extra slots), steps per
# decode chunk, the pool's rows
BATCH_BUCKETS = (512, 1024, 2048)
BATCH_MAX_NEW = 256
BATCH_STEPS = 16
BATCH_ROWS = 16


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


def pool_rows(reqs, dev) -> tuple:
    """The 8 video requests of `batch_requests`, repeated to fill the pool's
    `BATCH_ROWS` rows: (ids (rows, 512) on ``dev``, frames, lengths)."""
    video = [reqs[i % 8] for i in range(BATCH_ROWS)]
    ids = torch.zeros((BATCH_ROWS, 512), dtype=torch.int64)
    for i, (p, _, _) in enumerate(video):
        ids[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p, _, _ in video], device=dev)
    return ids.to(dev), np.concatenate([f for _, f, _ in video]), lens


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
    """The pool's fp32 logits (rows, V) after a batched prefill of the video
    prompts ``ids`` into a cache of the pool's ``smax`` slots, then at three
    teacher-forced pooled steps (per-row slots and positions at each row's
    length, as the pool decodes after compaction), fed ``feed`` or the
    greedy tokens of each step.  Returns (logits, the tokens fed)."""
    from valley_tpu_torch.models import llama

    dev = engine.device
    p, text = engine.params["llama"], engine.cfg.text
    n = ids.shape[0]
    with torch.inference_mode():
        zeros = torch.zeros(n, device=dev)
        tok, lg, cache, valid = engine._prefill(
            ids, engine._prepare_images(frames, n), lens,
            torch.Generator(dev).manual_seed(0), zeros, zeros + 1, False,
            pool.smax)
        out, fed = [lg], []
        seq = lens.clone()
        rows = torch.arange(n, device=dev)
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


def pooled_step(engine, pool, ids, frames, lens, spec: bool = False) -> tuple:
    """The pooled step (``spec``: the pooled verify round, each row's
    history its prompt and first token) of ``pool`` (closed) with every row
    filled by a batched prefill of the video prompts ``ids``: one chunk of
    `BATCH_STEPS` to warm, three timed on the host clock, one profiled.
    Returns (wall ms, device busy ms, top kernels, device ms of the chunk)
    a step.  By graph the device is busy nearly all the wall, so the idle
    share (the two taken from different chunks) may read a little under
    0."""
    n = ids.shape[0]
    with torch.inference_mode():
        tok, _, cache, valid = engine._prefill(
            ids, engine._prepare_images(frames, n), lens,
            torch.Generator("cuda").manual_seed(0),
            torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"),
            False, pool.smax)
        for b in range(n):
            pool._insert(cache, valid, tok, int(lens[b]), b, b)
            if spec:
                pool._state.load_hist(b, ids[b, :int(lens[b])].tolist(),
                                      tok[b])
        del cache
        pool._temps[:] = 0.0
        chunk = pool._spec_chunk if spec else pool._decode_chunk
        chunk(BATCH_STEPS)                               # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            chunk(BATCH_STEPS).cpu()
        wall_step = (time.perf_counter() - t0) / (3 * BATCH_STEPS) * 1e3
        dev, top, _ = profile_device(lambda: chunk(BATCH_STEPS))
    return wall_step, dev / BATCH_STEPS, top, dev


def batch_slice(cfg, params, smi: str) -> dict:
    """``batch_infer``'s configuration on Valley-7B: 12 requests at once
    through a `ContinuousEngine` of `BATCH_ROWS` rows (after a warm-up pair
    that captures its decode graph), each pooled chunk one replay of a CUDA
    graph; the launches of K1, K3-int8 and K6 against the pool's count of
    prefills and pooled steps; aggregate tokens/s; the same traffic through
    an eager pool (``eager=True``) over `EAGER_NEW` tokens: every greedy
    request's tokens the graph pool's first; the pooled step's wall and device time and its kernels,
    graph and eager; the pooled logits against the plain versions; each
    greedy video request's tokens against the same request alone.  Returns
    the counts."""
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
    reqs = batch_requests(cfg)
    kernels = {"K1": flash_attention, "K3-int8": decode_attention_stacked,
               "K6": bf16_matvec, "K4": int8_matvec, "K5": int4_matvec}
    pools, runs = {}, {}
    for mode in ("graph", "eager"):
        pool = ContinuousEngine(engine, rows=BATCH_ROWS, admit_batch=4,
                                eager=mode == "eager")
        pools[mode] = pool
        check(pool.smax == 2048 + BATCH_MAX_NEW, f"pool smax {pool.smax}")
        # warm-up: lazy CUDA / cuBLAS initialisation at two admission
        # buckets, and the capture of the pooled chunk's graph
        for q in (pool.submit(reqs[0][0], reqs[0][1], max_new_tokens=4,
                              eos_id=-1),
                  pool.submit(reqs[10][0], max_new_tokens=4, eos_id=-1)):
            list(_drain(q, timeout=600))
        torch.cuda.synchronize()
        steps0, groups0 = pool.steps_run, len(pool.prefill_sizes)
        for fn in kernels.values():
            fn.launches = 0
        new = NEW_TOKENS if mode == "graph" else EAGER_NEW
        results, wall = run_traffic(pool, reqs, new)   # main path
        counts = {k: fn.launches for k, fn in kernels.items()}
        steps = pool.steps_run - steps0
        groups = pool.prefill_sizes[groups0:]
        pool.close()
        runs[mode] = (results, wall, counts, steps, groups)
        for (toks, _, _), (p, f, t) in zip(results, reqs):
            check(len(toks) == new and all(
                0 <= x < cfg.text.vocab_size for x in toks),
                f"batch slice {mode}: a request gave {len(toks)} tokens or "
                "bad ids")
        check(sum(groups) == len(reqs), f"batch slice {mode}: admissions "
              f"{groups}")
        want = {"K1": layers * len(groups), "K3-int8": layers * steps,
                "K6": (4 * layers + 1) * steps + len(groups), "K4": 0,
                "K5": 0}
        for k, n in want.items():
            check(counts[k] == n, f"batch slice {mode}: {k} launched "
                  f"{counts[k]} times, want {n}")
        firsts = sorted(r[1] for r in results)
        n_tok = sum(len(r[0]) for r in results)
        print(f"batch slice {mode}: {len(reqs)} requests (8 video x 473 "
              f"tokens + 8 frames, text of 40/200/700/1500 tokens, 2 "
              f"sampled), {new} new tokens each, pool of {BATCH_ROWS} "
              f"rows x {pool.smax} slots (int8 cache), "
              f"{'each chunk one replay of a CUDA graph' if mode == 'graph' else 'eager steps'}"
              f"; {len(groups)} admission prefills of {groups} rows, {steps} "
              f"pooled steps; launches " + " ".join(
                  f"{k} {n}" for k, n in counts.items()))
        print(f"batch slice {mode}: aggregate {n_tok / wall:.2f} tok/s "
              f"({n_tok} tokens in {wall:.3f} s wall), first tokens at "
              f"{firsts[0]:.3f}-{firsts[-1]:.3f} s, on {smi}")
    graph_pool = pools["graph"]
    check(set(graph_pool._graphs.keys()) == {(BATCH_STEPS, True)},
          f"batch slice: pool graphs {list(graph_pool._graphs.keys())}")
    results, wall, counts, steps, groups = runs["graph"]
    e_results, _, _, _, e_groups = runs["eager"]
    check(groups == e_groups, f"batch slice: admission groups {groups} "
          f"(graph) and {e_groups} (eager)")
    for i, ((toks, _, _), (e_toks, _, _), (_, _, t)) in enumerate(
            zip(results, e_results, reqs)):
        if not t:
            check(toks[:EAGER_NEW] == e_toks, f"batch slice: greedy request "
                  f"{i} differs between the graph pool and the eager pool")
    print(f"batch slice: every greedy request (10 of 12) gives the eager "
          f"pool's {EAGER_NEW} tokens (its first) through the graph pool; "
          f"its graph captured in {graph_pool._graphs.capture_s:.3f} s")

    # the pooled step: every row after a batched prefill of video prompts
    ids, frames, lens = pool_rows(reqs, engine.device)
    steps_of = {}
    for mode in ("graph", "eager"):
        steps_of[mode] = pooled_step(engine, pools[mode], ids, frames, lens)
    check(steps_of["graph"][3] > 0 and any(
        "decode_attn_kernel" in name for name, _ in steps_of["graph"][2]),
        "batch slice: the profiler saw no K3 inside the pooled graph")
    for mode, (wall_step, dev_step, top, dev) in steps_of.items():
        inside = []
        for k in ("K3-int8", "K6"):
            ms = sum(t for name, t in top
                     if any(key in name for key in KERNEL_NAMES[k]))
            inside.append(f"{k} {ms / BATCH_STEPS:.3f} ms "
                          f"({100 * ms / dev:.1f}%)")
        print(f"batch slice breakdown ({mode}): pooled step of {BATCH_ROWS} "
              f"rows wall "
              f"{wall_step:.3f} ms, device busy {dev_step:.3f} ms (idle "
              f"share {1 - dev_step / wall_step:.3f}): " + ", ".join(inside)
              + "; top kernels: " + ", ".join(
                  f"{name[:40]} {100 * ms / dev:.1f}%"
                  for name, ms in top[:8]))
    print(f"batch slice: the pooled graph's memory pool "
          f"{fmt_mb(pool_bytes(graph_pool._graphs.pool))}")
    pool = graph_pool
    del pools, steps_of
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
            BATCH_ROWS, cfg.text.vocab_size), f"batch slice: {where} logits")
        diff = max_err(a, b)
        top2 = torch.topk(b, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        print(f"batch slice: {where} logits ({BATCH_ROWS} rows) kernels vs "
              f"plain max abs "
              f"diff {diff:.4e} (tol {BATCH_LOGIT_TOL}; max |logit| "
              f"{b.abs().max().item():.3f}), greedy tokens agree in {agree} "
              f"of {BATCH_ROWS} rows (smallest plain top-2 margin "
              f"{margin:.4f})")
        check(diff <= BATCH_LOGIT_TOL, f"batch slice: {where} logits beyond "
              "tolerance")
    del lk, lp, plain_engine

    # each greedy video request against the same request alone (B = 1,
    # kernels; the text requests alone would each capture a graph of
    # another bucket, which the script's time limit does not hold)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False)
    same = 0
    for i, ((toks, _, _), (p, f, t)) in enumerate(zip(results, reqs)):
        if t or f is None:
            continue
        alone = [int(x[0]) for x in engine.generate_tokens([p], f, gcfg,
                                                           eos_ids=[-1])]
        if alone == toks:
            same += 1
            continue
        step = next(j for j, (a, b) in enumerate(zip(alone, toks)) if a != b)
        state = engine.prefill([p], f, gcfg)
        lg = state.logits[0] if step == 0 else decode_logits(
            engine, state.cache, state.valid, state.bucket, len(p),
            alone[:step])[-1]
        top2 = torch.topk(lg, 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"batch slice: request {i} parts from its run alone at step "
              f"{step}, where the run alone's top-2 margin is {margin:.4f} "
              f"(bar {BATCH_MARGIN_BAR})")
        check(margin < BATCH_MARGIN_BAR, f"batch slice: request {i} parts "
              f"from its run alone at step {step} with margin {margin}")
    print(f"batch slice: {same} of 8 greedy video requests give the "
          f"tokens of their run alone (Engine.generate_tokens, B = 1)")
    return counts


def pool_verify_logits(engine, pool, ids, frames, lens) -> torch.Tensor:
    """fp32 logits (rows, D + 1, V) of the speculative pool's first verify
    round after a batched prefill of the video prompts ``ids``: each row's
    [token, draft] at its own slot (its prompt length), the draft looked up
    in the row's history (prompt and greedy token) as `spec_round` does."""
    from valley_tpu_torch.inference.speculative import ngram_draft
    from valley_tpu_torch.models import llama

    dev = engine.device
    p, text = engine.params["llama"], engine.cfg.text
    sp, n = pool._spec, ids.shape[0]
    with torch.inference_mode():
        zeros = torch.zeros(n, device=dev)
        tok, _, cache, valid = engine._prefill(
            ids, engine._prepare_images(frames, n), lens,
            torch.Generator(dev).manual_seed(0), zeros, zeros + 1, False,
            pool.smax)
        hist = torch.zeros((n, pool.hist_max), dtype=torch.int64, device=dev)
        hist[:, :ids.shape[1]] = ids
        hist.scatter_(1, lens[:, None], tok[:, None])
        draft = ngram_draft(hist, lens + 1, sp.draft_len, sp.ngram)
        chunk = torch.cat([tok[:, None], draft], dim=1)
        pos = lens[:, None] + torch.arange(sp.draft_len + 1, device=dev)
        hidden, _ = llama.forward_hidden(
            p, text, llama.embed(p, chunk), positions=pos, cache=cache,
            cache_index=lens, cross_valid=valid, attention=engine.attention)
        return llama.logits_from_hidden(p, hidden, engine.attention)


# new tokens a request in the speculative pool's traffic: its rounds cost
# 15x a pooled step, so its 12 requests run at a sixth of the plain pool's
# rate (16, not the plain pool's 64, keeps the script in its time limit)
SPEC_POOL_NEW = 16


def spec_pool_slice(cfg, params, smi: str) -> dict:
    """``batch_infer --speculative``'s pool: the 12 requests (`SPEC_POOL_NEW`
    new tokens each) through a `BATCH_ROWS`-row
    `ContinuousEngine(speculative=True)` with JAX's
    SpecConfig (adaptive: below 0.40 accepted drafts a round the pool
    pauses and re-probes every 32 chunks), after two warm-up requests that
    capture the round graph and the plain graph; the launches of K1,
    K3-int8 and K6 against the pool's prefills and plain steps (a round's
    rows x (D + 1) rows take the library's products and the plain
    attention); aggregate tok/s (read beside the round-versus-step ratio:
    the plain pool's rate is at another length), acceptance, pauses and
    re-probes; with every row filled,
    the pooled round's wall and device time against the same pool's plain
    step, and so its break-even; the first verify round's logits (each
    row's first) against the plain pool's first step's within the pooled
    bar.  Returns the launches."""
    from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
    from valley_tpu_torch.inference.engine import Engine
    from valley_tpu_torch.inference.speculative import resolved_disable_below
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec

    t_pool = time.perf_counter()
    layers = cfg.text.num_hidden_layers
    engine = Engine(cfg, params, buckets=BATCH_BUCKETS,
                    max_new_tokens=BATCH_MAX_NEW, cache_dtype=torch.int8,
                    steps_per_call=BATCH_STEPS)
    reqs = batch_requests(cfg)
    pool = ContinuousEngine(engine, rows=BATCH_ROWS, admit_batch=4,
                            speculative=True)
    try:
        # warm-up: the round graph's capture at the first chunk, then,
        # speculation paused, the plain graph's
        for q in (pool.submit(reqs[0][0], reqs[0][1], max_new_tokens=4,
                              eos_id=-1),
                  pool.submit(reqs[10][0], max_new_tokens=4, eos_id=-1)):
            list(_drain(q, timeout=600))
        pool.pause_speculation(1 << 30)
        list(_drain(pool.submit(reqs[10][0], max_new_tokens=4, eos_id=-1),
                    timeout=600))
        torch.cuda.synchronize()
        check(list(pool._spec_graphs.keys()) == [(BATCH_STEPS, True)]
              and list(pool._graphs.keys()) == [(BATCH_STEPS, True)],
              f"spec pool: warm-up captured {list(pool._spec_graphs.keys())}"
              f" rounds and {list(pool._graphs.keys())} plain")
        pool.reset_speculation()
        steps0, rounds0 = pool.steps_run, pool.rounds_run
        groups0 = len(pool.prefill_sizes)
        kernels = {"K1": flash_attention, "K3-int8": decode_attention_stacked,
                   "K6": bf16_matvec}
        (results, wall), counts = counted(
            kernels, lambda: run_traffic(pool, reqs, SPEC_POOL_NEW))
        steps = pool.steps_run - steps0
        rounds = pool.rounds_run - rounds0
        groups = pool.prefill_sizes[groups0:]
        want = {"K1": layers * len(groups), "K3-int8": layers * steps,
                "K6": (4 * layers + 1) * steps + len(groups)}
        for k, n in want.items():
            check(counts[k] == n, f"spec pool: {k} launched {counts[k]} "
                  f"times, want {n}")
        check(rounds > 0 and counts["K1"] > 0, f"spec pool: {rounds} "
              f"rounds, K1 launched {counts['K1']} times")
        n_tok = sum(len(r[0]) for r in results)
        check(n_tok == len(reqs) * SPEC_POOL_NEW, f"spec pool: {n_tok} "
              "tokens")
        acc = pool.spec_emitted / max(1, pool.spec_rounds) - 1
        print(f"spec pool: {len(reqs)} requests through a {BATCH_ROWS}-row "
              f"ContinuousEngine(speculative=True) (int8 cache, D "
              f"{pool._spec.draft_len}): {rounds} verify rounds and {steps} "
              f"plain steps in chunks of {BATCH_STEPS}; {pool.spec_rounds} "
              f"row rounds accept {acc:.3f} drafts each; "
              f"{pool.spec_disables} pauses, {pool.spec_reprobes} re-probes; "
              f"{SPEC_POOL_NEW} new tokens a request, aggregate "
              f"{n_tok / wall:.2f} tok/s; the round graph captured in "
              f"{pool._spec_graphs.capture_s:.3f} s, the graphs' memory pool "
              f"{fmt_mb(pool_bytes(pool._graphs.pool))}; launches "
              + " ".join(f"{k} {n}" for k, n in counts.items())
              + f", on {smi}")
    finally:
        pool.close()

    # the pooled round against the pooled step, both by graph on this pool
    # with every row filled: the break-even in accepted drafts a row round
    ids, frames, lens = pool_rows(reqs, engine.device)
    s_wall, s_dev, _, _ = pooled_step(engine, pool, ids, frames, lens)
    r_wall, r_dev, r_top, r_all = pooled_step(engine, pool, ids, frames,
                                              lens, spec=True)
    threshold = resolved_disable_below(pool._spec, engine)
    print(f"spec pool: a pooled verify round of {BATCH_ROWS} rows x "
          f"{pool._spec.draft_len + 1} tokens {r_wall:.3f} ms wall, "
          f"{r_dev:.3f} ms device; a pooled step {s_wall:.3f} ms wall, "
          f"{s_dev:.3f} ms device: a round costs {r_wall / s_wall:.3f}x a "
          f"step (device {r_dev / s_dev:.3f}x), so the break-even is "
          f"{r_wall / s_wall - 1:.3f} accepted drafts a row round (device "
          f"{r_dev / s_dev - 1:.3f}; the pool's threshold {threshold:.2f}); "
          f"the round's top kernels: " + ", ".join(
              f"{name[:40]} {100 * ms / r_all:.1f}%"
              for name, ms in r_top[:5]) + f", on {smi}")
    check(r_dev > 0 and s_dev > 0, "spec pool: no device time")

    lv = pool_verify_logits(engine, pool, ids, frames, lens)
    ls, _ = pooled_logits(engine, pool, ids, frames, lens)
    check(bool(torch.isfinite(lv).all()), "spec pool: verify logits")
    diff = max_err(lv[:, 0], ls[1])
    print(f"spec pool: the first verify round's logits ({BATCH_ROWS} rows x "
          f"{lv.shape[1]}; each row's first against the plain pool's first "
          f"pooled step) max abs diff {diff:.4e} (tol {BATCH_LOGIT_TOL}), "
          f"greedy tokens agree in "
          f"{int((lv[:, 0].argmax(-1) == ls[1].argmax(-1)).sum())} of "
          f"{BATCH_ROWS}")
    check(diff <= BATCH_LOGIT_TOL, "spec pool: verify logits beyond the "
          "pooled bar")
    print(f"spec pool: {time.perf_counter() - t_pool:.1f} s wall",
          flush=True)
    return counts


# The serving stack (`valley_tpu_torch/serve/`) on the int8 flagship: the
# JAX worker's 7B setup (--quantize int8a8 --fused --kv-cache int8), one
# bucket and one frame bucket, its weights written as a Hugging Face
# checkpoint and quantized on load
WORKER_BUCKET, WORKER_NEW, WORKER_STEPS = 512, 64, 32
# the checkpoint's shards: its bf16 tree cut into about this many files
WORKER_SHARDS = 3
WORKER_SYSTEM = "You are Valley."
K4_SRC = dict(route="cuda", source="valley_tpu_torch/csrc/int8_matvec.cu",
              replaces="valley_tpu/ops/quant.py:455")
WORKER_QUESTIONS = ("Describe the video in detail.", "Who is in it?",
                    "What happens at the end?", "Which colours dominate?")


def id_text_tokenizer():
    """The byte tokenizer (`ByteFallbackTokenizer`, its ids and markers),
    its text naming every token: an ASCII byte as itself, any other id as
    ``⟦id⟧``, read back the same way.  Random weights over 32000 ids emit
    tokens the byte tokenizer's text drops, so text streamed by the worker
    would not show them; with this one it names its tokens one for one, and
    a client's next turn (its prompt and the reply's text) encodes back to
    them, as a session's reuse needs."""
    import re

    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    class IdTextTokenizer(ByteFallbackTokenizer):
        def decode(self, ids, skip_special_tokens: bool = True) -> str:
            return "".join(chr(t - 3) if 3 <= t < 3 + 128 else f"⟦{t}⟧"
                           for t in map(int, ids))

        def encode(self, text: str, add_bos=None) -> list:
            out = [1] if (self.add_bos if add_bos is None else add_bos) \
                else []
            for i, part in enumerate(re.split(r"⟦(\d+)⟧", text)):
                if i % 2:
                    out.append(int(part))
                elif part:
                    out += ByteFallbackTokenizer.encode(self, part, False)
            return out

    return IdTextTokenizer()


def frame_dir(path: Path, seed: int, n: int = 8) -> str:
    """``n`` random 224 px frames as PNG files, a video the worker's loader
    reads (a frame directory)."""
    from PIL import Image

    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), np.uint8)).save(
            path / f"{i:02d}.png")
    return str(path)


def worker_request(question: str, video: str, **kw) -> dict:
    return {"model": "valley-7b", "prompt": f"{WORKER_SYSTEM}### Human: "
            f"<video> {question}\n### Assistant:", "videos": [video],
            "temperature": 0.0, "max_new_tokens": WORKER_NEW, **kw}


def timed_stream(url: str, req: dict) -> tuple:
    """(chunks, first chunk s, last chunk s) of a streamed request."""
    from valley_tpu_torch.serve.httpd import stream_chunks

    t0 = time.perf_counter()
    chunks, first = [], None
    for c in stream_chunks(url + "/worker_generate_stream", req,
                           timeout=600):
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(c)
    check(chunks and all(c["error_code"] == 0 for c in chunks),
          f"worker: a request failed: {chunks[-1:]}")
    return chunks, first, time.perf_counter() - t0


def write_checkpoint(cfg, work: Path, tk) -> tuple:
    """Valley-7B's random bf16 weights (seed 0, as `random_weights` makes
    them) written as a sharded HF checkpoint.  Returns (directory, bytes
    written, the bf16 tree's bytes)."""
    from valley_tpu_torch.utils import hf_bridge

    params = random_weights(cfg)
    tree_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    ckpt = work / "valley7b_checkpoint"
    free = shutil.disk_usage(work).free
    t0 = time.perf_counter()
    written = hf_bridge.export_valley_checkpoint(
        cfg, params, str(ckpt), dtype=torch.bfloat16,
        max_shard_bytes=-(-tree_bytes // WORKER_SHARDS))
    write_s = time.perf_counter() - t0
    shards = sorted(ckpt.glob("*.safetensors"))
    check(len(shards) >= 2 and (ckpt / "model.safetensors.index.json"
                                ).is_file(), f"checkpoint files {shards}")
    print(f"worker checkpoint: Valley-7B bf16 ({tree_bytes / 1e9:.3f} GB "
          f"of weights) written as {len(shards)} safetensors shards, an "
          f"index and config.json: {written / 1e9:.3f} GB in {write_s:.1f} "
          f"s ({written / write_s / 1e9:.2f} GB/s); free disk "
          f"{free / 1e9:.1f} GB before, "
          f"{shutil.disk_usage(work).free / 1e9:.1f} GB after", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ckpt, written, tree_bytes


def load_checkpoint(cfg, ckpt: Path, written: int, tree_bytes: int, tk):
    """Quantize-on-load: `load_valley_checkpoint(quantize="int8a8",
    fused=True)`, its peak device memory (reset before it) under the bf16
    tree's bytes, and every tensor bit-equal to the same bf16 tree fused
    and quantized in memory on the card.  Returns (config, weights)."""
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.quant import quantize_llama_params
    from valley_tpu_torch.utils import hf_bridge

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lcfg, loaded, _ = hf_bridge.load_valley_checkpoint(
        str(ckpt), quantize="int8a8", fused=True, tokenizer=tk)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    held = sum(p.numel() * p.element_size() for p in loaded.parameters())
    check(peak < tree_bytes, f"worker load: peak device memory {peak} "
          f"bytes, not under the bf16 tree's {tree_bytes}")
    check(lcfg.text == dataclasses.replace(
        cfg.text, num_key_value_heads=cfg.text.kv_heads)
        and lcfg.tokens == cfg.tokens and lcfg.vision == cfg.vision,
        f"worker load: config {lcfg}")
    print(f"worker load: load_valley_checkpoint(quantize=int8a8, fused) "
          f"read {written / 1e9:.3f} GB in {load_s:.2f} s "
          f"({written / load_s / 1e9:.2f} GB/s); peak device memory "
          f"{peak / 1e9:.3f} GB above the {before / 1e9:.3f} GB held before "
          f"(bf16 tree {tree_bytes / 1e9:.3f} GB; the loaded tree "
          f"{held / 1e9:.3f} GB)", flush=True)
    ref = quantize_llama_params(fuse_llama_params(random_weights(cfg)),
                                act8=True)
    got, want = loaded.state_dict(), ref.state_dict()
    check(set(got) == set(want), f"worker load: tensors {sorted(got)}")
    differ = [k for k in want if got[k].dtype != want[k].dtype
              or not torch.equal(got[k], want[k])]
    check(not differ, f"worker load: {differ} differ from the in-memory "
          "quantization")
    print(f"worker load: all {len(want)} tensors bit-equal to the same "
          f"bf16 tree fused and quantized (int8a8) in memory on the card")
    del ref, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return lcfg, loaded


def web_ui_phase(smi: str, ctrl: str, worker, work: Path) -> None:
    """The port's web UI (`serve.web_server`) against the process's
    controller, its LOGDIR a temporary directory: the page and the model
    list, then bench's video question as the page sends it (an mp4 of 8
    random 224 px frames in base64), greedy, 64 tokens, through
    ``/chat_stream`` to the default worker.  The UI runs with
    ``--conv-mode v1``, the training recipes' template: its own default
    (``multimodal_video``) makes a 674-token prompt of this question and
    video, over the worker's one 512 bucket.  Checked: the video saved
    under ``LOGDIR/serve_images`` by its md5, the chat record and a vote in
    ``{date}-conv.json``, and the relayed text equal to the worker's own
    stream of the same prompt and video; printed: the first relayed chunk's
    time beside the direct call's first chunk (the second request of each,
    the first having read the video once)."""
    import base64
    import hashlib
    import urllib.request

    import cv2

    from valley_tpu_torch.serve import web_server
    from valley_tpu_torch.serve.httpd import (iter_delimited, open_json,
                                              post_json)

    logdir = Path(tempfile.mkdtemp(prefix="chip_smoke_web_"))
    web_server.LOGDIR = str(logdir)
    app = web_server.build_app(web_server.WebServer(ctrl, conv_mode="v1"))
    app.host = "127.0.0.1"
    addr = f"http://127.0.0.1:{app.start()}"
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(addr + "/", timeout=30) as r:
            page = r.read()
        check(b"Valley" in page and b"tab-video" in page
              and b"TPU" not in page, "web: the page")
        models = post_json(addr + "/list_models", {})["models"]
        check("valley-7b" in models, f"web: models {models}")
        video = work / "web_video.mp4"
        out = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"),
                              8, (224, 224))
        rng = np.random.default_rng(5)
        for _ in range(8):
            out.write(rng.integers(0, 256, (224, 224, 3), np.uint8))
        out.release()
        raw = video.read_bytes()
        page_req = {"model": "valley-7b", "text": WORKER_QUESTIONS[0],
                    "media": base64.b64encode(raw).decode(),
                    "media_type": "video", "temperature": 0.0,
                    "max_new_tokens": WORKER_NEW, "history": []}

        def chat():
            t0 = time.perf_counter()
            first, chunks = None, []
            with open_json(addr + "/chat_stream", page_req,
                           timeout=600) as r:
                for c in iter_delimited(r):
                    if first is None:
                        first = time.perf_counter() - t0
                    chunks.append(json.loads(c))
            check(chunks and all(c.get("error_code", 0) == 0
                                 for c in chunks), f"web: {chunks[-1:]}")
            return chunks, first, time.perf_counter() - t0

        chat()
        saved = logdir / "serve_images" / f"{hashlib.md5(raw).hexdigest()}.mp4"
        check(saved.is_file() and saved.read_bytes() == raw,
              f"web: the video is not saved as {saved}")
        conv_log = next(logdir.glob("*-conv.json"))
        rec = json.loads(conv_log.read_text().splitlines()[-1])
        prompt = rec["prompt"]
        direct, d_first, d_total = timed_stream(worker.worker_addr, {
            "model": "valley-7b", "prompt": prompt, "videos": [str(saved)],
            "temperature": 0.0, "max_new_tokens": WORKER_NEW, "stop": "###"})
        chunks, w_first, w_total = chat()
        answer = direct[-1]["text"][len(prompt):].strip()
        check(chunks[-1]["text"] == answer and rec["answer"] == answer,
              "web: the relayed text differs from the worker's own stream "
              "of the same prompt")
        history = [["Human", WORKER_QUESTIONS[0]], ["Assistant", answer]]
        post_json(addr + "/vote", {"type": "upvote", "history": history})
        vote = json.loads(conv_log.read_text().splitlines()[-1])
        check(vote["type"] == "upvote" and vote["history"] == history,
              f"web: the vote record {vote}")
        n_tok = len(direct)
        print(f"web: the page ({len(page)} bytes) and models {models}; "
              f"bench's video question through /chat_stream (an 8-frame "
              f"mp4 of {len(raw)} bytes saved as serve_images/{saved.name},"
              f" a {len(prompt)}-character prompt, v1 template): {len(chunks)}"
              f" relayed chunks ({n_tok} from the worker directly), the text "
              f"equal to the worker's own stream; chat and vote records in "
              f"{conv_log.name}")
        print(f"web: first relayed chunk {w_first * 1e3:.2f} ms after the "
              f"request, against the direct call's first chunk "
              f"{d_first * 1e3:.2f} ms ({(w_first - d_first) * 1e3:+.2f} ms);"
              f" last {w_total * 1e3:.1f} against {d_total * 1e3:.1f} ms, on "
              f"{smi}", flush=True)
    finally:
        app.shutdown()
        shutil.rmtree(logdir, ignore_errors=True)


def serve_worker_path(smi: str, gen, work: Path) -> list:
    """The serving stack on the int8 flagship: a Valley-7B checkpoint
    written and quantized on load, the port's controller and worker in this
    process on localhost ports, and (a) a stateless request through the
    controller's proxy by the default `SpecDecoder` against the same call
    made directly, with its launches of K1, K3-int8 and K4 against the
    decoder's rounds and the engine's steps; (b) three questions at once,
    each its run alone; (c) a two-turn session against `SpecChatSession`
    driven directly; (d) the prefix cache against the same spawn driven
    directly; (e) the OpenAI route against the native one; (g) the web UI
    against this controller (`web_ui_phase`); (f) a pooled
    worker (the plain pool, an int8 cache) taking four requests at once,
    one a prefix hit, against each alone, with its launches against the
    pool's counters; then K1, K3-int8 and K4 against their plain versions
    at the shapes these requests gave them, timed.  Returns its kernels
    entries."""
    import threading

    from valley_tpu_torch import valley_7b
    from valley_tpu_torch.inference.continuous import ContinuousEngine
    from valley_tpu_torch.inference.engine import (Engine, GenerationConfig,
                                                   PrefixCache)
    from valley_tpu_torch.inference.speculative import SpecChatSession
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec
    from valley_tpu_torch.serve import controller, model_worker
    from valley_tpu_torch.serve.httpd import post_json

    tk = id_text_tokenizer()
    cfg = valley_7b(tokens=tk.special_tokens())
    kernel_layers = cfg.text.num_hidden_layers
    cfg = serving_depth(cfg)
    layers = cfg.text.num_hidden_layers
    ckpt, written, tree_bytes = write_checkpoint(cfg, work, tk)
    cfg, params = load_checkpoint(cfg, ckpt, written, tree_bytes, tk)
    shutil.rmtree(ckpt)

    # the worker's engine: --buckets 512 --frame-buckets 8 --max-new-tokens
    # 64 and the worker's --steps-per-call 32 and --decode-ramp 2,6
    engine = Engine(cfg, params, buckets=(WORKER_BUCKET,),
                    max_new_tokens=WORKER_NEW, cache_dtype=torch.int8,
                    steps_per_call=WORKER_STEPS, decode_ramp=(2, 6),
                    frame_buckets=(8,), raw_media=True)
    ctrl_app = controller.build_app(controller.Controller())
    ctrl_app.host = "127.0.0.1"
    ctrl = f"http://127.0.0.1:{ctrl_app.start()}"
    apps = [ctrl_app]

    def serve(name: str, **kw):
        w = model_worker.ModelWorker(ctrl, "", name, engine, tk,
                                     no_register=True, num_frames=8, **kw)
        app = model_worker.build_app(w)
        app.host = "127.0.0.1"
        w.worker_addr = f"http://127.0.0.1:{app.start()}"
        w.register_to_controller()
        # its heartbeats, or the controller forgets it after 30 s
        threading.Thread(target=w._heartbeat_loop, daemon=True).start()
        apps.append(app)
        return w

    kernels = {"K1": flash_attention, "K3-int8": decode_attention_stacked,
               "K4": int8_matvec, "K6": bf16_matvec}
    try:
        # the default worker (SpecDecoder for stateless requests), warmed
        # as --warmup warms it (no plain decode graphs: stateless requests
        # decode by the decoder's)
        w = serve("valley-7b", speculative=True)
        dec = w.spec_decoder
        t0 = time.perf_counter()
        paths = w.warmup_serving_paths()
        held = w.register_graph_memory()
        keys = (set(engine.graph_sets), set(dec.graph_sets))
        print(f"worker warm-up: {time.perf_counter() - t0:.1f} s; "
              f"warmup_serving_paths captured {paths['graphs']} graphs in "
              f"{paths['capture_s']:.1f} s; the graphs hold {fmt_mb(held)} "
              f"(static decode states and memory pools) at cache lengths "
              f"{sorted(k[1] for k in keys[0])}", flush=True)
        models = post_json(ctrl + "/list_models", {})["models"]
        check(models == ["valley-7b"], f"controller models {models}")
        video = frame_dir(work / "video_a", 1)

        # (a) a stateless request through the controller's proxy against
        # the decoder called directly on the same inputs
        req = worker_request(WORKER_QUESTIONS[0], video)
        ids, frames, gcfg, _ = w.prepare(req)

        def direct_call():
            t0 = time.perf_counter()
            first, toks = None, []
            with w._engine_lock:
                for t in dec.generate_tokens(ids, frames, gcfg,
                                             eos_ids=[tk.eos_token_id]):
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.append(int(t))
            return first, time.perf_counter() - t0, toks

        # the first call may capture a count of rounds a call that the
        # warm-up's short replies did not reach; the second is timed
        direct_call()
        d_first, d_total, d_toks = direct_call()
        direct = req["prompt"] + tk.decode(d_toks)
        rounds0, steps0 = dec.total_rounds, engine.steps_run
        ran = [0]
        rounds = dec._rounds

        def run_rounds(state, n_rounds, *a, **k):
            ran[0] += n_rounds
            return rounds(state, n_rounds, *a, **k)

        dec._rounds = run_rounds
        try:
            (chunks, h_first, h_total), counts = counted(
                kernels, lambda: timed_stream(ctrl, req))
        finally:
            dec._rounds = rounds
        steps = engine.steps_run - steps0
        check(chunks[-1]["text"] == direct, "worker (a): the streamed text "
              "differs from SpecDecoder.generate_tokens called directly")
        check(len(d_toks) == WORKER_NEW, f"worker (a): {len(d_toks)} tokens")
        want = {"K1": layers, "K3-int8": layers * steps,
                "K4": (4 * layers + 1) * (ran[0] + steps) + 1, "K6": 0}
        for k, n in want.items():
            check(counts[k] == n, f"worker (a): {k} launched {counts[k]} "
                  f"times, want {n}")
        per_tok = [(t - f) / (WORKER_NEW - 1) * 1e3
                   for f, t in ((h_first, h_total), (d_first, d_total))]
        print(f"worker (a): {len(ids)}-token prompt in bucket "
              f"{WORKER_BUCKET}, 8 frames, {WORKER_NEW} greedy tokens through "
              f"the controller's proxy by SpecDecoder: the streamed text "
              f"equals the direct call's; {dec.total_rounds - rounds0} "
              f"rounds counted by the decoder ({ran[0]} run), {steps} plain "
              f"steps; launches " + " ".join(
                  f"{k} {n}" for k, n in counts.items()))
        print(f"worker (a): first streamed chunk {h_first * 1e3:.2f} ms "
              f"after the request, against the direct call's first token "
              f"{d_first * 1e3:.2f} ms; {per_tok[0]:.3f} ms/token over HTTP "
              f"against {per_tok[1]:.3f} direct, on {smi}", flush=True)
        request_counts = counts
        # a reply of another length decodes at the same cache length
        short = timed_stream(ctrl, {**req, "max_new_tokens": 16})[0]
        check(len(tk.encode(short[-1]["text"][len(req["prompt"]):],
                            False)) == 16 and direct.startswith(
                  short[-1]["text"]), "worker (a): a 16-token reply is not "
              "the 64-token reply's start")

        # (b) three questions at once, each its run alone
        reqs = [worker_request(q, video) for q in WORKER_QUESTIONS[1:]]
        for r in reqs:             # a reply's round counts may be new
            timed_stream(w.worker_addr, r)
        alone = [timed_stream(w.worker_addr, r) for r in reqs]
        together: list = [None] * len(reqs)

        def run(i):
            together[i] = timed_stream(w.worker_addr, reqs[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        check(all(t is not None and t[0] == a[0]
                  for t, a in zip(together, alone)),
              "worker (b): a concurrent request differs from its run alone")
        print(f"worker (b): three questions at once: each stream equals its "
              f"run alone; {wall:.2f} s for the three against "
              f"{sum(a[2] for a in alone):.2f} s one after another (the "
              f"engine lock serializes them)")

        # (c) a worker with --max-sessions: a two-turn session against
        # SpecChatSession driven directly (sessions decode eagerly)
        ws = serve("valley-7b-sessions", speculative=True, max_sessions=2)
        s1 = worker_request(WORKER_QUESTIONS[0], video, session_id="c")
        t1 = timed_stream(ws.worker_addr, s1)[0][-1]["text"]
        # the client sends the whole conversation, its video again
        s2 = {**s1, "prompt": t1 + "\n### Human: And then?\n### Assistant:"}
        t2 = timed_stream(ws.worker_addr, s2)[0][-1]["text"]
        sess = ws._sessions["c"][0]
        check(sess.prefills == 1 and sess.extends == 1, f"worker (c): the "
              f"session ran {sess.prefills} prefills, {sess.extends} extends")
        ids1, frames1, g1, _ = ws.prepare(s1)
        ids2 = ws.prepare(s2)[0]
        extra = -(-(2 * WORKER_NEW + 256) // 512) * 512
        ds = SpecChatSession(engine, g1, extra_slots=extra)
        with torch.inference_mode():
            r1 = ds.chat(ids1, images=frames1, eos_ids=[tk.eos_token_id])
            r2 = ds.chat(ids2[len(ids1) + len(r1):],
                         eos_ids=[tk.eos_token_id])
        check(t1 == s1["prompt"] + tk.decode(r1) and
              t2 == s2["prompt"] + tk.decode(r2), "worker (c): the session's "
              "streamed turns differ from SpecChatSession driven directly")
        print(f"worker (c): a session of two turns ({len(ids1)} then "
              f"{len(ids2) - len(ids1) - len(r1)} new tokens, the second "
              f"extending the kept cache) equals SpecChatSession driven "
              f"directly ({len(r1)} and {len(r2)} tokens)")
        del ds, sess

        # (d) a worker with --prefix-cache: a miss, then a hit, against the
        # spawn driven directly
        wx = serve("valley-7b-prefix", speculative=True, prefix_cache=2)
        texts = [timed_stream(wx.worker_addr, req)[0][-1]["text"]
                 for _ in range(2)]
        check((wx.prefix_misses, wx.prefix_hits) == (1, 1),
              f"worker (d): prefix misses/hits {wx.prefix_misses}/"
              f"{wx.prefix_hits}")
        pre, suffix = wx._prefix_split(wx.prepare(req)[3], ids)
        with torch.inference_mode():
            pc = PrefixCache(engine, pre, frames, extra_slots=512)
            spawned = pc.spawn(gen=gcfg, speculative=True, seed=gcfg.seed
                               ).chat(suffix, eos_ids=[tk.eos_token_id])
        check(texts[0] == texts[1] == req["prompt"] + tk.decode(spawned),
              "worker (d): the prefix cache's streams differ from the spawn "
              "driven directly")
        print(f"worker (d): --prefix-cache: a miss and a hit ({len(pre)}-"
              f"token prefix, {len(suffix)}-token question) both equal the "
              f"spawn driven directly; the plain path's text "
              f"{'equals' if texts[0] == direct else 'differs from'} it "
              f"(a spawn extends where the plain path prefills)")
        del pc

        # (e) the OpenAI route against the native one
        from valley_tpu_torch.serve.openai_api import _flatten_messages

        msgs = [{"role": "system", "content": WORKER_SYSTEM},
                {"role": "user", "content": [
                    {"type": "text", "text": WORKER_QUESTIONS[0]},
                    {"type": "video_url", "video_url": {"url": video}}]}]
        out = post_json(w.worker_addr + "/v1/chat/completions", {
            "messages": msgs, "temperature": 0.0,
            "max_tokens": WORKER_NEW}, timeout=600)
        prompt = _flatten_messages(msgs)[0]
        native = timed_stream(w.worker_addr, {
            "prompt": prompt, "videos": [video], "temperature": 0.0,
            "max_new_tokens": WORKER_NEW, "stop": "###"})[0][-1]["text"]
        check(out["choices"][0]["message"]["content"]
              == native[len(prompt):].strip(), "worker (e): the OpenAI "
              "route's text differs from the native route's")
        print(f"worker (e): /v1/chat/completions gives the native route's "
              f"text ({out['usage']['completion_tokens']} completion "
              f"tokens)")
        stats = post_json(w.worker_addr + "/worker_get_status", {})["stats"]
        print(f"worker stats: {json.dumps(stats)}")
        check((set(engine.graph_sets), set(dec.graph_sets)) == keys,
              "worker: stateless requests made graph keys the warm-up did "
              f"not: {sorted(engine.graph_sets)}, {sorted(dec.graph_sets)}")
        print("worker: requests of 64 and 16 new tokens replayed the warm-up's"
              f" {len(keys[0])} decode state(s); no key added")

        # (g) the web UI against this controller and the default worker
        web_ui_phase(smi, ctrl, w, work)

        # (f) a pooled worker: the plain pool (--batch-window-ms -1, as
        # --speculative's default leaves it), int8 cache, four requests at
        # once, one a prefix hit, each against its run alone
        wp = serve("valley-7b-pool", batch_window_ms=-1, max_batch=4,
                   prefix_cache=2, speculative=True, speculative_pool=False)
        pool = wp.continuous
        check(isinstance(pool, ContinuousEngine) and pool._spec is None,
              "worker (f): the pool speculates by default")
        # the first request caches its prefix and, decoding every chunk
        # size (2, 6, 32), captures the pool's graphs
        t0 = time.perf_counter()
        timed_stream(wp.worker_addr, req)
        wp.register_graph_memory()
        print(f"worker (f): the first request {time.perf_counter() - t0:.1f} "
              f"s, {len(pool._graphs.keys()) if pool._graphs else 0} graphs "
              f"captured; hbm {json.dumps(wp.hbm and wp.hbm.snapshot())}",
              flush=True)
        rng = np.random.default_rng(4)
        video_b = frame_dir(work / "video_b", 2)
        text_req = {"model": "valley-7b-pool", "temperature": 0.0,
                    "max_new_tokens": WORKER_NEW}
        quad = [worker_request(WORKER_QUESTIONS[1], video),      # a hit
                worker_request(WORKER_QUESTIONS[2], video_b),    # a miss
                {**text_req, "prompt": "".join(
                    chr(c) for c in rng.integers(97, 123, 40))},
                {**text_req, "prompt": "".join(
                    chr(c) for c in rng.integers(97, 123, 200))}]
        steps0, sizes0 = pool.steps_run, len(pool.prefill_sizes)
        chunks0, misses0 = len(pool.prefix_chunks), wp.prefix_misses
        hits0 = wp.prefix_hits
        got: list = [None] * 4

        def run_pooled(i):
            got[i] = timed_stream(wp.worker_addr, quad[i])

        def pooled():
            ths = [threading.Thread(target=run_pooled, args=(i,))
                   for i in range(4)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()

        t0 = time.perf_counter()
        _, counts = counted(kernels, pooled)
        wall = time.perf_counter() - t0
        steps = pool.steps_run - steps0
        admissions = len(pool.prefill_sizes) - sizes0
        prefix_chunks = pool.prefix_chunks[chunks0:]
        builds = wp.prefix_misses - misses0
        check(wp.prefix_hits - hits0 == 1 and builds == 1 and
              len(prefix_chunks) == 2, f"worker (f): {wp.prefix_hits - hits0}"
              f" hits, {builds} builds, prefix admissions {prefix_chunks}")
        want = {"K1": layers * (admissions + builds),
                "K3-int8": layers * steps,
                "K4": (4 * layers + 1) * steps + admissions + builds
                + sum(1 + (4 * layers if c <= 16 else 0)
                      for c in prefix_chunks), "K6": 0}
        for k, n in want.items():
            check(counts[k] == n, f"worker (f): {k} launched {counts[k]} "
                  f"times, want {n}")
        parts, pool_lens = [], []
        for r, g in zip(quad, got):
            p_ids, p_frames, p_gen, _ = wp.prepare(r)
            pool_lens.append(len(p_ids) + WORKER_NEW // 2)
            toks = tk.encode(g[0][-1]["text"][len(r["prompt"]):], False)
            alone = [int(t[0]) for t in engine.generate_tokens(
                [p_ids], p_frames, GenerationConfig(max_new_tokens=WORKER_NEW,
                                                    do_sample=False),
                eos_ids=[tk.eos_token_id])]
            parts.append(first_divergence("worker (f)", engine, p_ids,
                                          p_frames, alone, toks,
                                          INT8_LOGIT_TOL))
        print(f"worker (f): four requests at once through the pooled worker "
              f"(4 rows, int8a8, int8 cache; one prefix hit, one prefix "
              f"built and admitted from, two text) in {wall:.2f} s: "
              f"{admissions} admission prefills (sizes "
              f"{pool.prefill_sizes[sizes0:]}), {len(prefix_chunks)} "
              f"admissions from a prefix (chunks {prefix_chunks}), {steps} "
              f"pooled steps; launches " + " ".join(
                  f"{k} {n}" for k, n in counts.items()))
        for i, part in enumerate(parts):
            print(f"worker (f): request {i} against its run alone: {part}")
        pool_counts = counts
        pool.close()
        stats = post_json(wp.worker_addr + "/worker_get_status", {})["stats"]
        print(f"worker (f) stats: {json.dumps(stats)}")
        # the worker's kernels against their plain versions at the shapes
        # these requests gave them: K1 at the stateless prompt's prefill
        # (every prefill here is one prompt in the 512 bucket), K4 at a
        # verify round's 9 rows (a request's plain steps and its prefill's
        # lm_head take 1) and at the pool's rows, K3-int8 over the
        # decoder's cache (its fallback steps) and over the pool's rows
        # half-way through their replies
        k1_err, k1_t = k1_phase(flash_cases(gen, prompt_len=len(ids))[:1])
        k4_err, k4_t = k4_phase(gen, kernel_layers, 9)
        k3_err, k3_t = k3_int8_phase(decode_int8_cases(
            gen, dec.cache_len(WORKER_BUCKET), len(ids), WORKER_BUCKET)[:1])
        k4p_err, k4p_t = k4_phase(gen, kernel_layers, pool.rows)
        k3p_err, k3p_t = k3_int8_phase([pool_decode_int8_case(
            gen, pool.smax, kernel_layers, pool_lens,
            (min(pool_lens), max(pool_lens)))])
    finally:
        for app in apps:
            app.shutdown()
    # a request's verify rounds attend through the plain attention: K3
    # runs only in the plain steps of an adaptive fallback
    entries = [{**K1_SRC, "name": "flash_fwd_worker", "path": "serve_worker",
                "launches": request_counts["K1"], "max_abs_err": k1_err,
                **k1_t},
               {**K3_SRC, "name": "decode_attn_int8_worker",
                "path": "serve_worker", "launches": request_counts["K3-int8"],
                "max_abs_err": k3_err, **k3_t},
               {**K4_SRC, "name": "int8_matvec_worker",
                "path": "serve_worker", "launches": request_counts["K4"],
                "max_abs_err": k4_err, **k4_t},
               {**K1_SRC, "name": "flash_fwd_worker_pool",
                "path": "serve_worker_pool", "launches": pool_counts["K1"],
                "max_abs_err": k1_err, **k1_t},
               {**K3_SRC, "name": "decode_attn_int8_worker_pool",
                "path": "serve_worker_pool",
                "launches": pool_counts["K3-int8"], "max_abs_err": k3p_err,
                **k3p_t},
               {**K4_SRC, "name": "int8_matvec_worker_pool",
                "path": "serve_worker_pool", "launches": pool_counts["K4"],
                "max_abs_err": k4p_err, **k4p_t}]
    return [e for e in entries if e["launches"]]


def serve_batch_path(smi: str, gen, work: Path) -> list:
    """Batched serving, batch_infer's configuration: K7 (the card's read
    rate), K6 and its T3 variant at the fused Valley-7B shapes (the pool's
    rows; K6 also at 1 and 8), K1 and K3-int8 at the pool's shapes, against their plain
    versions; then the slice on random Valley-7B bf16 weights, fused, and
    the speculative pool.  Returns its kernels entries."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
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
    # at 8 rows, the pool's width before it reached batch_infer's 16
    b8_launches = bf16_matvec.launches
    k6b8_err, k6b8_t, _ = k6_phase(gen, K6_SHAPES_FUSED, 8, layers)
    b8_launches = bf16_matvec.launches - b8_launches
    round_launches = bf16_matvec.launches
    k6r_err, k6r_t, _ = k6_phase(gen, K6_SHAPES_FUSED, BATCH_ROWS, layers,
                                 round_products=True)
    round_launches = bf16_matvec.launches - round_launches
    k1_err, k1_t = k1_phase([flash_batch_case(gen)])
    k3q_err, k3q_t = k3_int8_phase([pool_decode_int8_case(
        gen, 2048 + BATCH_MAX_NEW, layers)])
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_depth(cfg)
    params = fuse_llama_params(random_weights(cfg))
    counts = batch_slice(cfg, params, smi)
    gc.collect()
    torch.cuda.empty_cache()
    spec_counts = spec_pool_slice(cfg, params, smi)
    spec_entries = [
        {**K1_SRC, "name": "flash_fwd_spec_pool", "path": "serve_batch_spec",
         "launches": spec_counts["K1"], "max_abs_err": k1_err, **k1_t},
        {**K3_SRC, "name": "decode_attn_int8_spec_pool",
         "path": "serve_batch_spec", "launches": spec_counts["K3-int8"],
         "max_abs_err": k3q_err, **k3q_t},
        {**K6_SRC, "name": "bf16_matvec_spec_pool",
         "path": "serve_batch_spec", "launches": spec_counts["K6"],
         "max_abs_err": k6_err, **k6_t}]
    return [e for e in spec_entries if e["launches"]] + [
            {**K1_SRC, "name": "flash_fwd_batch", "path": "serve_batch",
             "launches": counts["K1"], "max_abs_err": k1_err, **k1_t},
            {**K3_SRC, "name": "decode_attn_int8_batch",
             "path": "serve_batch", "launches": counts["K3-int8"],
             "max_abs_err": k3q_err, **k3q_t},
            {**K6_SRC, "path": "serve_batch", "launches": counts["K6"],
             "max_abs_err": k6_err, **k6_t},
            {**K6_SRC, "name": "bf16_matvec_B8",
             "path": "serve_batch, GEMV phase only (an 8-row pool step)",
             "launches": b8_launches, "max_abs_err": k6b8_err, **k6b8_t},
            {**K6_SRC, "name": "bf16_matvec_round",
             "replaces": "tools/exp_pallas_gemv2.py:73",
             "path": "serve_batch, GEMV phase only (not on the main path)",
             "launches": round_launches, "max_abs_err": k6r_err, **k6r_t},
            {"name": "read_sum", "route": "cuda",
             "source": "valley_tpu_torch/csrc/read_sum.cu",
             "replaces": "tools/exp_read_bw.py:64",
             "path": "serve_batch, read-rate phase", "bound_by": "bytes",
             **k7_t}]


# Stage 2 (valley_tpu/configs/experiment/valley_stage2_lora.yaml and
# valley_stage2.yaml): batch 1 of synthetic multi-turn video conversations
# of 1985-2048 tokens, padded to 2048, the recipes' optimizer settings
STAGE2_SEQ = 2048
STAGE2_TRAIN_CONVS = 4
STAGE2_EVAL_CONVS = 2
# The first LoRA step through the kernels (K1, K2) against the same step on
# the plain attention functions, as TRAIN_LOSS_TOL and TRAIN_GRAD_TOL hold
# stage 1's: loss absolute, gradients relative L2 (the adapters' B and the
# projector at step 0, where every A's gradient is exactly 0 because B is;
# the adapters' A after one update).
# H100 readings of this script: loss 5.82e-4 (loss 10.616; the same
# forward without gradients on two conversations: 1.19e-3 and 7.63e-4,
# per-token differences 1.4e-2 on average, 5.5e-2 at most, alike in every
# quarter of the sequence: rounding through 32 layers, averaged over
# ~1000 supervised tokens where stage 1 averages ~6000), gradients
# 8.85e-3; the bars are about twice the largest.
STAGE2_LOSS_TOL = 2.5e-3
STAGE2_GRAD_TOL = 0.02
# The merged model (bf16 W + A B s rounded once) against the unmerged
# adapter forward (bf16 W, then the adapter branch added in bf16) on
# bench's request, at the prefill and at three teacher-forced decode
# steps through the engine's kernels (K1, K3, K6 over the merged weights)
# H100 readings of this script: 0.0798 at the prefill (largest logit
# 4.44; the adapter itself moves them by 2.01), 0.0811-0.0846 at the
# decode steps; the bar is about twice that.
MERGE_LOGIT_TOL = 0.17
# The generate-eval: replies of up to 128 tokens (the steps eval's)
EVAL_NEW = 128
LORA_KINDS = ("LoRA adapter products", "LoRA dropout masks")
STACK_KIND = "stacked gradients (unbind's stack)"


def stage2_text(rng, n_chars: int) -> str:
    """Random lower-case words of about ``n_chars`` characters."""
    words, size = [], 0
    while size < n_chars:
        w = "".join(chr(97 + int(c)) for c in rng.integers(0, 26,
                                                           rng.integers(2, 9)))
        words.append(w)
        size += len(w) + 1
    return " ".join(words)


def write_stage2_corpus(root: Path, seed: int = 0) -> dict:
    """Synthetic stage-2 data as the recipes read it (a video JSON of
    multi-turn conversations, each video a frame directory of 8 random
    224 px PNGs named ``<id>.mp4`` under ``videos/webvid``), made with
    numpy from ``seed``: `STAGE2_TRAIN_CONVS` training conversations of
    three turns and 1985-2048 tokens with the byte tokenizer, and
    `STAGE2_EVAL_CONVS` shorter ones of two turns for the generate-eval
    (their prompts and 128-token replies fit the 2048 bucket).  Returns
    the paths."""
    rng = np.random.default_rng(seed)
    videos = root / "videos"

    def conv(cid: str, chars: list) -> dict:
        frame_dir(videos / "webvid" / f"{cid}.mp4",
                  seed=int(rng.integers(1 << 30)))
        turns = []
        for i, n in enumerate(chars):
            value = stage2_text(rng, n)
            if i == 0:
                value = "<video>\n" + value
            turns.append({"from": "gpt" if i % 2 else "human",
                          "value": value})
        return {"id": cid, "video": cid, "conversations": turns}

    train = [conv(f"s2train{i}", [int(rng.integers(150, 250))
                                  for _ in range(5)] + [0])
             for i in range(STAGE2_TRAIN_CONVS)]
    # the last reply takes what is left of the length: 1985-2048 tokens
    for c in train:
        used = sum(len(t["value"]) for t in c["conversations"])
        c["conversations"][-1]["value"] = stage2_text(
            rng, 1475 - used + int(rng.integers(0, 40)))
    evals = [conv(f"s2eval{i}", [int(rng.integers(60, 120))
                                 for _ in range(4)])
             for i in range(STAGE2_EVAL_CONVS)]
    (root / "train.json").write_text(json.dumps(train))
    (root / "eval.json").write_text(json.dumps(evals))
    return {"train": str(root / "train.json"),
            "eval": str(root / "eval.json"), "videos": str(videos)}


def stage2_dataset(tokenizer, corpus: dict, which: str):
    """The port's dataset and collator over the ``which`` JSON of
    `write_stage2_corpus`, as ``train/train.py`` builds them."""
    from types import SimpleNamespace

    from valley_tpu_torch.data.dataset import \
        make_video_supervised_data_module

    args = SimpleNamespace(
        data_path=None, video_data_path=corpus[which],
        video_folder=corpus["videos"], is_multimodal=True,
        mm_use_im_start_end=True, conv_mode="v1", num_frames=8,
        crop_size=224, scale_size=256, patch_size=14)
    module = make_video_supervised_data_module(tokenizer, args)
    return module["train_dataset"], module["data_collator"]


def stage2_tokenizer():
    """`id_text_tokenizer` at the recipes' model_max_length: its text
    names every token, so eval replies of random weights read back."""
    tok = id_text_tokenizer()
    tok.model_max_length = STAGE2_SEQ
    return tok


def stage2_model(tok, seed: int):
    """Valley-7B's random bf16 weights from ``seed`` on the card, the
    tokenizer's marker ids."""
    from valley_tpu_torch import valley_7b
    from valley_tpu_torch.models import valley

    cfg = valley_7b(tokens=tok.special_tokens())
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(
        seed), torch.bfloat16, "cuda")
    return cfg, params


def profile_kinds(fn, r: int = 0) -> tuple:
    """Device time of ``fn()`` by kind, under the profiler with shapes:
    kernels by name (`KERNEL_KINDS`), then the time of three kinds moved
    out of theirs by the ops that launched them: the LoRA adapter products
    (every ``aten::mm`` with an operand of rank-``r`` side, forward,
    recompute and backward), the adapter dropout masks (the (1, S, in)
    uniform draws, compares, selects and divisions that make and apply
    them, and their backward), and the stacked layers' gradients (the
    ``aten::cat`` inside ``UnbindBackward0``: the one stack of the layers'
    gradients).  Reads the trace's raw events (each kernel carries its
    launching op's correlation id), not the profiler's Python event tree,
    which takes tens of seconds to build for a LoRA update.  Returns
    (device ms, {kind: ms}, top kernels)."""
    from torch.autograd import DeviceType

    def read(prof):
        ops, unbinds, kernels = {}, [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    kernels.append((e.name(), e.duration_ns() / 1e6,
                                    e.linked_correlation_id()))
                continue
            if e.linked_correlation_id():
                continue          # a runtime call, not an op
            name = e.name()
            if name.endswith("UnbindBackward0"):
                unbinds.append((e.start_thread_id(), e.start_ns(),
                                e.end_ns()))
            elif name in ("aten::mm", "aten::uniform_", "aten::lt",
                          "aten::where", "aten::div", "aten::cat"):
                ops[e.correlation_id()] = (name, e.shapes(),
                                           e.start_thread_id(), e.start_ns())
        return sum(ms for _, ms, _ in kernels), ops, unbinds, kernels

    got = traced(fn, 1, read, record_shapes=True)
    check(got is not None, "the profiler recorded no device time")
    total, ops, unbinds, kernels = got

    def moved_kind(op):
        name, shapes, tid, t = op
        shapes = [tuple(x) for x in shapes if x]
        if name == "aten::mm" and r and any(
                len(x) == 2 and r in x for x in shapes[:2]):
            return LORA_KINDS[0]
        if r and name != "aten::cat" and shapes and len(shapes[0]) == 3 \
                and shapes[0][0] == 1 and shapes[0][1] > 1:
            return LORA_KINDS[1]
        if name == "aten::cat" and any(u_tid == tid and lo <= t <= hi
                                       for u_tid, lo, hi in unbinds):
            return STACK_KIND
        return None

    kinds: dict = {}
    per_kernel: dict = {}
    for name, ms, corr in kernels:
        op = ops.get(corr)
        kind = moved_kind(op) if op else None
        if kind is None:
            kind = next((k for k, keys in KERNEL_KINDS if any(
                key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        per_kernel[name] = per_kernel.get(name, 0.0) + ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return total, kinds, top


def fmt_kinds(kinds: dict, total: float) -> str:
    return ", ".join(f"{k} {ms:.1f} ms ({100 * ms / total:.1f}%)"
                     for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]))


def stage2_updates(tag: str, trainer, batch, layers: int, smi: str,
                   r: int = 0) -> dict:
    """One warm-up update, then three timed updates of ``batch`` with K1's
    and K2's launches counted around them (2 x ``layers`` and ``layers``
    an update), the peak device memory from before the warm-up (the
    optimizer's state included), then one profiled update by kind.
    Returns the counts, times and readings."""
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)

    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(batch)["loss"]]     # warm-up update
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    walls = []
    for _ in range(3):                                # the main path
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        check(m["updated"], f"{tag}: a step did not update")
    n_k1, n_k2 = flash_attention.launches, flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{tag}: loss not finite")
    check(n_k1 == 3 * 2 * layers,
          f"{tag}: K1 launched {n_k1} times in 3 updates, want "
          f"{3 * 2 * layers}")
    check(n_k2 == 3 * layers,
          f"{tag}: K2 launched {n_k2} times in 3 updates, want {3 * layers}")
    check(peak < 80e9, f"{tag}: peak device memory {peak / 1e9:.2f} GB")
    tokens = int(batch["attention_mask"].sum())
    step_s = sorted(walls)[1]
    t0 = time.perf_counter()
    step_dev, kinds, top = profile_kinds(lambda: trainer.train_step(batch),
                                         r)
    print(f"{tag}: the profiled update and its trace's reading took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"{tag}: losses {[round(x, 5) for x in losses]} (warm-up, then 3 "
          f"updates); launches over 3 updates K1 {n_k1} K2 {n_k2}")
    print(f"{tag}: device time by kind: " + fmt_kinds(kinds, step_dev))
    print(f"{tag}: step wall {step_s * 1e3:.1f} ms (median of 3: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
          f"{tokens / step_s:.0f} non-pad tokens/s, device busy "
          f"{step_dev:.1f} ms (idle share {1 - step_dev / (step_s * 1e3):.3f}"
          f"), peak memory {peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB) on "
          f"{smi}; top kernels: " + ", ".join(
              f"{name[:48]} {100 * ms / step_dev:.1f}%"
              for name, ms in top[:6]))
    return {"k1": n_k1, "k2": n_k2, "step_s": step_s, "peak": peak,
            "kinds": kinds, "device_ms": step_dev, "steps": trainer.step}


def snapshot(params) -> dict:
    """A device copy of each parameter of less than 64 MB; of every larger
    one, the int64 sum of its 16-bit words (a fingerprint that an update
    moves, with no copy of the tensor, so the check adds nothing to the
    updates' peak memory)."""
    return {n: p.detach().clone() if p.numel() * p.element_size() < 64e6
            else p.detach().view(torch.int16).sum(dtype=torch.int64)
            for n, p in params.named_parameters()}


def unchanged_check(tag: str, params, before: dict, trainable,
                    may_stay=()) -> None:
    """Every frozen parameter is unchanged and every trainable one moved
    (against `snapshot`), but those in ``may_stay``, which may keep their
    bf16 values (printed)."""
    stayed = []
    for name, p in params.named_parameters():
        b = before[name]
        same = torch.equal(p.detach(), b) if b.dim() else bool(
            p.detach().view(torch.int16).sum(dtype=torch.int64) == b)
        if same and name in trainable and name in may_stay:
            stayed.append(name)
            continue
        check(same == (name not in trainable),
              f"{tag}: {name} {'unchanged' if same else 'changed'}")
    if stayed:
        print(f"{tag}: unchanged in bf16 though trained: {stayed}")


def stage2_lora_phase(smi: str, corpus: dict) -> tuple:
    """LoRA stage 2 on Valley-7B (random weights) through `Trainer` with
    the recipe's settings over the corpus's first conversation (batch 1,
    2048 tokens): the first step's loss and gradients against the plain
    attention functions (B and the projector at step 0, A after one
    update), the updates of `stage2_updates`, only the adapters and the
    projector moved; then `train.StepEval` after a further update against
    an engine built fresh on the same merged weights.  Returns (the
    updates' readings, the batch's kv mask)."""
    from valley_tpu_torch.data.dataset import DataLoader
    from valley_tpu_torch.ops.attention import KERNELS, PLAIN
    from valley_tpu_torch.train import lora
    from valley_tpu_torch.train.eval_loop import eval_sample
    from valley_tpu_torch.train.train import StepEval, _eval_engine
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer
    from valley_tpu_torch.inference.engine import GenerationConfig

    tag = "stage2 lora"
    tok = stage2_tokenizer()
    cfg, params = stage2_model(tok, seed=1)
    layers = cfg.text.num_hidden_layers
    params = lora.add_lora(params, torch.Generator("cuda").manual_seed(2),
                           r=16, alpha=32, dtype=torch.bfloat16)
    data, coll = stage2_dataset(tok, corpus, "train")
    lens = [len(data[i]["input_ids"]) for i in range(len(data))]
    check(all(STAGE2_SEQ - 64 < n <= STAGE2_SEQ for n in lens),
          f"{tag}: conversation lengths {lens}")
    loader = DataLoader(data, 1, coll, seed=0, num_workers=1)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    # valley_stage2_lora.yaml
    tc = TrainConfig(output_dir=out_dir, learning_rate=5e-4,
                     lr_scheduler_type="cosine", warmup_ratio=0.03,
                     adam_beta1=0.9, adam_beta2=0.95, max_grad_norm=1.0,
                     weight_decay=0.0, gradient_checkpointing=True,
                     freeze_backbone=False, tune_mm_mlp_adapter=True,
                     lora=True, lora_r=16, lora_alpha=32, lora_dropout=0.05,
                     per_device_train_batch_size=1, save_steps=0, eval_num=1)
    trainer = Trainer(cfg, tc, params, loader, total_steps=8)
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    b, s = batch["input_ids"].shape
    check((b, s) == (1, STAGE2_SEQ), f"{tag}: batch {b}x{s}")
    check(tuple(batch["images"].shape[:2]) == (1, 8), f"{tag}: 8 frames")
    names = [n for n, lab in trainer.labels.items() if lab != "frozen"]
    adapters = [n for n in names if lora.is_lora_key(n)]
    check(sorted(names) == sorted(["projector.w", "projector.b"] + adapters)
          and len(adapters) == 14, f"{tag}: trainable parameters {names}")
    n_train = sum(p.numel() for p in params.parameters() if p.requires_grad)
    tokens = int(batch["attention_mask"].sum())
    print(f"{tag}: batch 1x{s}, {tokens} non-pad tokens, "
          f"{int((batch['labels'] != -100).sum())} supervised, 8 frames; "
          f"trainable {n_train / 1e6:.2f} M of "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B")
    before = snapshot(params)

    def kernels_vs_plain(which: list, when: str, zero: list = ()):
        out = []
        res = []
        for att in (KERNELS, PLAIN):
            trainer.attention = att
            res.append(trainer.loss_and_grads(batch))
        trainer.attention = KERNELS
        (lk, _, gk), (lp, _, gp) = res
        diff = abs(float(lk) - float(lp))
        out.append(f"loss {float(lk):.5f} vs {float(lp):.5f} (diff "
                   f"{diff:.2e}, tol {STAGE2_LOSS_TOL})")
        check(diff <= STAGE2_LOSS_TOL, f"{tag}: {when} loss differs by "
              f"{diff}")
        order = [n for g in trainer.optimizer.param_groups
                 for n in g["names"]]
        errs = []
        for name, a, c in zip(order, gk, gp):
            check(bool(torch.isfinite(a.float()).all()),
                  f"{tag}: {name} grad not finite")
            if name in zero:
                check(a.abs().max().item() == 0 and c.abs().max().item() == 0,
                      f"{tag}: {name}'s gradient at step 0 is not 0")
            elif name in which:
                err = rel_l2(a, c)
                errs.append(err)
                check(err <= STAGE2_GRAD_TOL, f"{tag}: {when} {name} grad "
                      f"rel L2 {err} > {STAGE2_GRAD_TOL}")
        out.append(f"{len(errs)} gradients rel L2 <= {max(errs):.2e} (tol "
                   f"{STAGE2_GRAD_TOL})")
        print(f"{tag}: {when}, kernels vs plain: " + "; ".join(out))

    a_names = [n for n in adapters if n.endswith("_lora_a")]
    kernels_vs_plain([n for n in names if n not in a_names],
                     "step 0 (B and projector; every A's gradient exactly 0)",
                     zero=a_names)
    readings = stage2_updates(tag, trainer, batch, layers, smi, r=16)
    kernels_vs_plain(a_names, "after 5 updates (the adapters' A)")
    unchanged_check(tag, params, before, set(names))
    del before

    # the steps eval: one engine across evals, refilled in place, against
    # an engine built fresh on the same merged weights
    eval_data, _ = stage2_dataset(tok, corpus, "eval")
    ev = StepEval(cfg, tc, tok, eval_data)
    ev(trainer.params, trainer.step)
    engine = ev.engine
    trainer.train_step(batch)                         # a further update
    t0 = time.perf_counter()
    metrics = ev(trainer.params, trainer.step)
    eval_s = time.perf_counter() - t0
    check(ev.engine is engine, f"{tag}: the steps eval rebuilt its engine")
    fresh = _eval_engine(cfg, lora.merge_lora(trainer.params), tok, 256)
    gen = GenerationConfig(max_new_tokens=EVAL_NEW, do_sample=False)
    entry = eval_data.list_data_dict[0]
    images = eval_data[0]["image"][None]
    kept = eval_sample(engine, tok, entry, images, "v1", gen)
    new = eval_sample(fresh, tok, entry, images, "v1", gen)
    check(kept == new, f"{tag}: the steps eval's engine replies otherwise "
          "than a fresh engine on the same weights")
    # the replies stop at the template's "###" or strip to nothing (the
    # trained adapter emits spaces), so the first turn's 128 tokens too
    prompt = tok.encode(eval_prompt(cfg, entry))
    toks = [[int(t[0]) for t in e.generate_tokens(
        [prompt], images, gen, eos_ids=[-1])] for e in (engine, fresh)]
    check(toks[0] == toks[1] and len(toks[0]) == EVAL_NEW,
          f"{tag}: the steps eval's engine decodes otherwise than a fresh "
          "engine on the same weights")
    print(f"{tag}: evaluation_strategy steps after a further update: "
          f"{metrics} in {eval_s:.2f} s ({tc.eval_num} sample, "
          f"{len(new)} turns of up to {EVAL_NEW} tokens, replies of "
          f"{[len(r['prediction']) for r in new]} characters); its engine, "
          f"refilled in place, gives a fresh engine's replies and its "
          f"{EVAL_NEW} tokens on the first turn's {len(prompt)}-token "
          f"prompt")
    mask = batch["attention_mask"].bool()
    del trainer, params, batch, ev, engine, fresh
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return readings, mask


def eval_prompt(cfg, entry: dict) -> str:
    """The first turn's prompt of a conversation as `eval_sample` builds
    it (the v1 template, the media span for 8 frames)."""
    from valley_tpu_torch.conversation import conv_templates
    from valley_tpu_torch.inference.generate import media_replace_token

    conv = conv_templates["v1"].copy()
    value = entry["conversations"][0]["value"]
    for marker in ("<video>", "<image>"):
        value = value.replace(marker, media_replace_token(cfg.num_patches, 8))
    conv.append_message(conv.roles[0], value)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def stage2_entry_phase(smi: str, corpus: dict, work: Path) -> Path:
    """``python -m valley_tpu_torch.train.train --conf <yaml>`` in the
    process: the LoRA recipe on Valley-7B's random weights (model_size
    7b, seed 0) over the training conversations, one epoch.  Checks the
    adapter-only ``final`` and ``valley_meta.json``; returns the output
    directory."""
    import yaml

    from valley_tpu_torch.train import train as train_mod
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    tag = "stage2 entry point"
    out = work / "stage2_lora"
    conf = dict(
        model_name_or_path="", model_size="7b", data_path=None,
        video_data_path=corpus["train"], video_folder=corpus["videos"],
        output_dir=str(out), conv_mode="v1", freeze_backbone=False,
        tune_mm_mlp_adapter=True, lora=True, lora_r=16, lora_alpha=32,
        lora_save_strategy="steps", is_multimodal=True, num_train_epochs=1,
        per_device_train_batch_size=1, save_steps=0, learning_rate=5e-4,
        gradient_checkpointing=True, mm_vision_select_layer=-2,
        mm_use_im_start_end=True, bf16=True, gradient_accumulation_steps=1,
        weight_decay=0.0, warmup_ratio=0.03, lr_scheduler_type="cosine",
        logging_steps=1, model_max_length=STAGE2_SEQ, num_frames=8)
    path = work / "stage2_lora.yaml"
    path.write_text(yaml.safe_dump(conf))
    t0 = time.perf_counter()
    train_mod.main(["--conf", str(path)])
    took = time.perf_counter() - t0
    meta = json.loads((out / "valley_meta.json").read_text())
    adapter = ckpt_lib.restore_pytree(out / "final")
    check(meta["lora"] is True, f"{tag}: valley_meta.json {meta}")
    check(len(adapter) == 15 and all(
        k.endswith(("_lora_a", "_lora_b")) or k == "lora_scale"
        for k in adapter), f"{tag}: final holds {sorted(adapter)}")
    check(any(adapter[k].float().abs().max().item() > 0 for k in adapter
              if k.endswith("_lora_b")), f"{tag}: every B is still 0")
    try:
        train_mod.load_framework_checkpoint(str(out), STAGE2_SEQ, "cuda",
                                            torch.bfloat16)
        check(False, f"{tag}: a LoRA output loaded as a base")
    except ValueError as e:
        check(f"lora_path={out}/final" in str(e), f"{tag}: {e}")
    steps = [json.loads(x)["step"] for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    size = sum(f.stat().st_size for f in (out / "final").iterdir())
    print(f"{tag}: {len(steps)} updates in {took:.1f} s (with the model's "
          f"build and the end's checkpoint); final adapter-only, "
          f"{len(adapter)} tensors, {size / 1e6:.1f} MB; valley_meta.json "
          f"lora true; loading the output as a base names "
          f"lora_path=<dir>/final")
    shutil.rmtree(out / f"checkpoint-{steps[-1]}", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stage2_merge_phase(smi: str, corpus: dict, out: Path) -> dict:
    """The adapter round trip: the entry point's base weights (seed 0)
    with its ``final`` restored, merged (`lora.merge_lora`): the merged
    model's logits against the unmerged adapter forward at bench's
    request's prefill and three teacher-forced decode steps through the
    engine's kernels; the request served by graph from the merged tree
    (launches of K1, K3 and K6); then the generate-eval over the eval
    conversations.  Returns the request's counts."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.decode_attention import \
        decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.train import lora
    from valley_tpu_torch.train.eval_loop import generate_eval
    from valley_tpu_torch.train.train import _eval_engine
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    tag = "stage2 merged"
    tok = stage2_tokenizer()
    cfg, base = stage2_model(tok, seed=0)
    adapter = ckpt_lib.restore_pytree(out / "final", map_location="cuda")
    unmerged = lora.load_lora(base, adapter)
    t0 = time.perf_counter()
    merged = lora.merge_lora(unmerged)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    prompt, frames = bench_request(cfg, BUCKET)
    new = NEW_TOKENS
    steps = new - 1
    engine = Engine(cfg, merged, buckets=(BUCKET,), max_new_tokens=new,
                    steps_per_call=steps)
    gcfg = GenerationConfig(max_new_tokens=new, do_sample=False)

    def run():
        t0 = time.perf_counter()
        t_first, toks = None, []
        for t in engine.generate_tokens([prompt], frames, gcfg,
                                        eos_ids=[-1]):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(int(t[0]))
        return t_first, time.perf_counter() - t0, toks

    run()    # captures the decode graph
    layers = cfg.text.num_hidden_layers
    kernels = {"K1": (flash_attention, layers),
               "K3": (decode_attention_stacked, layers * steps),
               "K6": (bf16_matvec, 7 * layers * steps + 1 + steps)}
    for fn, _ in kernels.values():
        fn.launches = 0
    t_first, total, toks = run()          # the main path
    counts = {k: fn.launches for k, (fn, _) in kernels.items()}
    for k, (_, want) in kernels.items():
        check(counts[k] == want, f"{tag}: {k} launched {counts[k]} times, "
              f"want {want}")
    check(len(toks) == new, f"{tag}: {len(toks)} tokens")
    print(f"{tag}: merge of 7 x {layers} layers' adapters in {merge_s:.3f} s;"
          f" bench's request by graph from the merged tree: first token "
          f"{t_first * 1e3:.2f} ms, {(total - t_first) / steps * 1e3:.3f} "
          f"ms/token; launches " + " ".join(f"{k} {n}"
                                             for k, n in counts.items()))

    # merged (prefill and three teacher-forced decode steps through the
    # engine's kernels) against the unmerged adapter forward over the same
    # tokens, cacheless
    state = engine.prefill([prompt], frames, gcfg)
    forced = toks[:DECODE_CHECK_STEPS]
    got = [state.logits[0]] + decode_logits(engine, state.cache, state.valid,
                                            state.bucket, len(prompt),
                                            forced)
    ids = torch.tensor([prompt + forced], device="cuda")
    fr = torch.from_numpy(frames).cuda()
    with torch.no_grad():
        ref = valley.forward(unmerged, cfg, ids, fr)[0]
        plain = valley.forward(base, cfg, ids, fr)[0]
    n = len(prompt)
    for i, lk in enumerate(got):
        lr = ref[n - 1 + i]
        where = "prefill" if i == 0 else f"decode step {i}"
        diff = max_err(lk, lr)
        effect = max_err(plain[n - 1 + i], lr)
        print(f"{tag}: {where} merged vs unmerged adapter logits max abs "
              f"diff {diff:.4e} (tol {MERGE_LOGIT_TOL}; max |logit| "
              f"{lr.abs().max().item():.3f}; the adapter moves them by "
              f"{effect:.4e})")
        check(bool(torch.isfinite(lk).all()), f"{tag}: {where} not finite")
        check(diff <= MERGE_LOGIT_TOL, f"{tag}: {where} logits beyond "
              "tolerance")
    del state, ref, plain, unmerged, base

    # the generate-eval over the eval conversations, through the engine
    # train/train.py builds for it (buckets 1024 and 2048, 256 new tokens)
    eval_data, _ = stage2_dataset(tok, corpus, "eval")
    pred = out / "eval_result.jsonl"
    t0 = time.perf_counter()
    metrics = generate_eval(_eval_engine(cfg, merged, tok, 256), tok,
                            eval_data, eval_num=STAGE2_EVAL_CONVS,
                            conv_mode="v1", prediction_file=str(pred),
                            gen=GenerationConfig(max_new_tokens=EVAL_NEW,
                                                 do_sample=False))
    eval_s = time.perf_counter() - t0
    records = [json.loads(x) for x in pred.read_text().splitlines()]
    turns = sum(len(c["conversations"]) // 2
                for c in eval_data.list_data_dict)
    check(len(records) == turns and all(
        r["reference"] for r in records), f"{tag}: generate-eval wrote "
        f"{len(records)} of {turns} replies")
    check(set(metrics) >= {"bleu", "rouge1", "rouge2", "rougeL"},
          f"{tag}: metrics {metrics}")
    print(f"{tag}: generate-eval over {STAGE2_EVAL_CONVS} conversations "
          f"({turns} replies of up to {EVAL_NEW} tokens): {metrics}; "
          f"{eval_s:.2f} s, {eval_s / STAGE2_EVAL_CONVS:.2f} s per sample "
          f"(an engine's first use captures its graphs)")
    del engine, merged
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def stage2_full_phase(smi: str, corpus: dict) -> tuple:
    """Full stage 2 on Valley-7B (random weights) through `Trainer` with
    valley_stage2.yaml's settings (lr 2e-5, the decoder, embeddings, head
    and projector trained), batch 1 of 2048 tokens: the updates of
    `stage2_updates` (peak memory under 80 GB, the optimizer's state
    included), every trainable parameter moved and the tower not.  Returns
    the readings and a host copy of the parameters after the updates."""
    from valley_tpu_torch.data.dataset import DataLoader
    from valley_tpu_torch.train.trainer import Trainer

    tag = "stage2 full"
    tok = stage2_tokenizer()
    cfg, params = stage2_model(tok, seed=1)
    data, coll = stage2_dataset(tok, corpus, "train")
    loader = DataLoader(data, 1, coll, seed=0, num_workers=1)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_full_")
    trainer = Trainer(cfg, stage2_full_config(out_dir), params, loader,
                      total_steps=8)
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    names = {n for n, lab in trainer.labels.items() if lab != "frozen"}
    check(not any(n.startswith("vision.") for n in names)
          and "llama.layers.wq" in names and "projector.w" in names,
          f"{tag}: trainable {sorted(names)}")
    n_train = sum(p.numel() for p in params.parameters() if p.requires_grad)
    print(f"{tag}: batch 1x{batch['input_ids'].shape[1]}, trainable "
          f"{n_train / 1e9:.3f} B of "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B")
    before = snapshot(params)
    readings = stage2_updates(tag, trainer, batch, cfg.text.num_hidden_layers,
                              smi)
    # the norms' weights are ones, where a bf16 step is 2^-8 to 2^-7: an
    # update of about lr = 2e-5 rounds back to 1 (optax's bf16 update too)
    unchanged_check(tag, params, before, names, may_stay=(
        "llama.final_norm", "llama.layers.attn_norm",
        "llama.layers.mlp_norm"))
    host = {n: p.detach().to("cpu") for n, p in params.named_parameters()}
    del trainer, params, batch, before
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return readings, host


def stage2_full_config(out_dir: str, **kw):
    """valley_stage2.yaml's training settings (and, with
    ``offload_optimizer``, valley_stage2_offload.yaml's)."""
    from valley_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(output_dir=out_dir, learning_rate=2e-5,
                       lr_scheduler_type="cosine", warmup_ratio=0.03,
                       adam_beta1=0.9, adam_beta2=0.95, max_grad_norm=1.0,
                       weight_decay=0.0, gradient_checkpointing=True,
                       freeze_backbone=False, tune_mm_mlp_adapter=True,
                       per_device_train_batch_size=1, save_steps=0, **kw)


def stage2_offload_phase(smi: str, corpus: dict, full: dict,
                         host: dict) -> dict:
    """Full stage 2 again with valley_stage2_offload.yaml's
    ``offload_optimizer`` (its other settings are valley_stage2.yaml's):
    the same weights (seed 1), batch and updates as `stage2_full_phase`,
    the AdamW moments in pinned host memory (checked between updates) and
    streamed to the card around each update.  Its peak device memory,
    update wall and device time beside the on-device run's, and every
    parameter after the updates bit-equal to that run's (``host``, its
    copy on the host: both runs do not fit on the card at once)."""
    from valley_tpu_torch.data.dataset import DataLoader
    from valley_tpu_torch.train.trainer import Trainer

    tag = "stage2 offload"
    tok = stage2_tokenizer()
    cfg, params = stage2_model(tok, seed=1)
    data, coll = stage2_dataset(tok, corpus, "train")
    loader = DataLoader(data, 1, coll, seed=0, num_workers=1)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_offload_")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, stage2_full_config(out_dir,
                                              offload_optimizer=True),
                      params, loader, total_steps=8)
    moments = trainer.adam_moments()
    pinned = sum(t.numel() * t.element_size() for t in moments)
    print(f"{tag}: {len(moments)} AdamW moments, {pinned / 1e9:.2f} GB "
          f"({pinned / 2 ** 30:.2f} GiB), allocated pinned on the host in "
          f"{time.perf_counter() - t0:.1f} s (the trainer's construction)")
    check(all(t.device.type == "cpu" and t.is_pinned() for t in moments),
          f"{tag}: a moment is not a pinned host tensor")
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    readings = stage2_updates(tag, trainer, batch, cfg.text.num_hidden_layers,
                              smi)
    after = trainer.adam_moments()
    check(len(after) == len(moments) and all(
        a is b and a.is_pinned() for a, b in zip(after, moments)),
        f"{tag}: the moments are not the pinned host tensors between "
        "updates")
    differ = [n for n, p in params.named_parameters()
              if not torch.equal(p.detach().to("cpu"), host[n])]
    check(not differ, f"{tag}: parameters differ from the on-device run's "
          f"after the same updates: {differ}")
    print(f"{tag}: every parameter ({len(host)} tensors) bit-equal to the "
          f"on-device run's after the same 5 updates")
    print(f"{tag}: peak device memory {readings['peak'] / 2 ** 30:.2f} GiB "
          f"against {full['peak'] / 2 ** 30:.2f} GiB on the device in this "
          f"run (PERF.md's earlier reading: 59.13 GiB); update wall "
          f"{readings['step_s'] * 1e3:.1f} ms against "
          f"{full['step_s'] * 1e3:.1f} ms (PERF.md's: 706.2 ms), device time "
          f"{readings['device_ms']:.1f} ms against {full['device_ms']:.1f} "
          f"ms (the copies on their own streams counted), on {smi}")
    del trainer, params, batch, moments, after
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return readings


def stage2_zero3_phase(smi: str, corpus: dict, full: dict, host: dict,
                       work: Path) -> dict:
    """valley_stage2_zero3.yaml on the card at world 1: a process group of
    one over NCCL (a file store in the run's scratch directory), the
    recipe's mesh (data 1, fsdp -1, model 1), the same weights (seed 1),
    batch and updates as `stage2_full_phase` through the sharded path
    (`parallel.sharding`: every sharded weight read through its gather,
    every gradient through its reduce-scatter, the loss over the
    all-reduced count).  At world 1 the gather is a copy, the
    reduce-scatter sums one input and the global count is the local one,
    so every parameter after the updates must be bit-equal to that run's
    (``host``); its update wall, device time, idle share and peak beside
    the unsharded run's, and K1's and K2's launches."""
    from valley_tpu_torch.data.dataset import DataLoader
    from valley_tpu_torch.parallel import distributed, sharding
    from valley_tpu_torch.parallel.mesh import create_mesh
    from valley_tpu_torch.train.trainer import Trainer

    tag = "stage2 zero3"
    check(distributed.initialize(f"file://{work}/zero3_store", 1, 0,
                                 device="cuda"), f"{tag}: no process group")
    try:
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"{tag}: backend {backend}, want nccl")
        mesh = create_mesh(1, -1, 1, "cuda")
        tok = stage2_tokenizer()
        cfg, params = stage2_model(tok, seed=1)
        data, coll = stage2_dataset(tok, corpus, "train")
        loader = DataLoader(data, 1, coll, seed=0, num_workers=1,
                            process_index=sharding.batch_rank(mesh),
                            process_count=1)
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_zero3_")
        trainer = Trainer(cfg, stage2_full_config(out_dir), params, loader,
                          total_steps=8, mesh=mesh)
        axes = sharding.sharding_of(params).axes
        check("llama.layers.wq" in axes and "llama.embed" in axes
              and "projector.w" in axes, f"{tag}: sharded {sorted(axes)}")
        print(f"{tag}: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"over {backend}, {len(axes)} of "
              f"{len(list(params.named_parameters()))} parameters sharded "
              "over fsdp, each read through its gather")
        batch = trainer.device_batch(next(iter(loader.epoch(0))))
        readings = stage2_updates(tag, trainer, batch,
                                  cfg.text.num_hidden_layers, smi)
        check(readings["steps"] == full["steps"], f"{tag}: "
              f"{readings['steps']} updates against {full['steps']}")
        differ = [n for n, p in params.named_parameters()
                  if not torch.equal(p.detach().to("cpu"), host[n])]
        check(not differ, f"{tag}: parameters differ from the unsharded "
              f"run's after the same updates: {differ}")
        print(f"{tag}: every parameter ({len(host)} tensors) bit-equal to "
              f"the unsharded run's after the same {readings['steps']} "
              "updates")
        print(f"{tag}: update wall {readings['step_s'] * 1e3:.1f} ms against "
              f"{full['step_s'] * 1e3:.1f} ms unsharded, device busy "
              f"{readings['device_ms']:.1f} ms against "
              f"{full['device_ms']:.1f} ms, idle share "
              f"{1 - readings['device_ms'] / (readings['step_s'] * 1e3):.3f} "
              f"against {1 - full['device_ms'] / (full['step_s'] * 1e3):.3f}, "
              f"peak {readings['peak'] / 2 ** 30:.2f} GiB against "
              f"{full['peak'] / 2 ** 30:.2f} GiB; K1 {readings['k1']} and K2 "
              f"{readings['k2']} launches in 3 updates, on {smi}")
        del trainer, params, batch
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        distributed.shutdown()
    return readings


# The two-rank case: stage 1 at Valley-7B's width, cut to this many layers,
# global batch of 16 rows (8 a rank at (1, 2, 1), all 16 at (1, 1, 2)); the
# model axis's case adds full stage 2, one row of 2048 tokens
GLOO_LAYERS = 2
GLOO_UPDATES = 3
GLOO_STAGES = ("stage1", "stage2")
# The (1, 1, 2) mesh's first step against world 1 on the same weights and
# batch, every trainable gradient: full stage 2 at stage 2's bars
# (STAGE2_LOSS_TOL, STAGE2_GRAD_TOL), stage 1's gradients at TRAIN_GRAD_TOL
# and its loss at about twice its reading, where stage 1's own bar
# (TRAIN_LOSS_TOL, 1e-4) reads the rounding of K1's variants: the
# row-parallel products' partial sums are rounded to bf16 before they are
# summed over the group, one rounding more than one device's product.
# H100 reading of this script: stage 1's loss 1.76e-4.
GLOO_TP_LOSS_TOL = 3.5e-4


def gloo_train(stage: str, mesh, out: Path, rank: Optional[int]) -> dict:
    """``stage`` at Valley-7B's width cut to `GLOO_LAYERS` layers (seed 1):
    stage 1's recipe on the global batch of 16 `TrainRows` at a fixed
    geometry (512 tokens, 8 frames), or full stage 2 (valley_stage2.yaml's
    settings) on one row of 2048 tokens; with ``mesh`` None at world 1 with
    no process group, else on that mesh's rank over gloo on the one card
    (NCCL refuses two ranks on one device), each rank on its rows.
    Returns the first step's loss and full gradients of the trainable
    parameters, the losses of `GLOO_UPDATES` updates after it, the full
    trainable parameters after them and K1's and K2's launches in them."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.dataset import (
        DataCollatorForSupervisedDataset, DataLoader)
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS, TrainRows
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from valley_tpu_torch.parallel import sharding
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    cfg = cfg.replace(text=dataclasses.replace(
        cfg.text, num_hidden_layers=GLOO_LAYERS))
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                torch.bfloat16, "cuda")
    blocks = 1 if mesh is None else \
        sharding.data_size(mesh) * sharding.fsdp_size(mesh)
    rows, seq = (16, 512) if stage == "stage1" else (1, STAGE2_SEQ)
    loader = DataLoader(
        TrainRows(cfg, n=max(rows, 2), seq=seq), rows,
        DataCollatorForSupervisedDataset(pad_token_id=0, pad_to_length=seq,
                                         pad_frames_to=8, max_length=seq),
        seed=0, num_workers=1,
        process_index=0 if mesh is None else sharding.batch_rank(mesh),
        process_count=blocks)
    where = "w1" if mesh is None else "x".join(map(str, mesh.shape))
    run_dir = str(out / f"{stage}_{where}_{rank}")
    if stage == "stage1":
        tc = TrainConfig(output_dir=run_dir, learning_rate=2e-3,
                         lr_scheduler_type="cosine", warmup_ratio=0.03,
                         adam_beta1=0.9, adam_beta2=0.95, max_grad_norm=1.0,
                         gradient_checkpointing=True, freeze_backbone=True,
                         tune_mm_mlp_adapter=True, save_steps=0,
                         per_device_train_batch_size=rows // blocks)
    else:
        tc = stage2_full_config(run_dir)
    trainer = Trainer(cfg, tc, params, loader, total_steps=5, mesh=mesh)
    batch = trainer.device_batch(next(iter(loader.epoch(0))))
    with ce_widths() as widths:
        loss, _, grads = trainer.loss_and_grads(batch)
    full = {n: g.cpu() for n, g in trainer.gathered(grads).items()}
    del grads
    k1, k2 = flash_attention.launches, flash_attention_bwd.launches
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch)["loss"]
              for _ in range(GLOO_UPDATES)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (flash_attention.launches - k1,
                flash_attention_bwd.launches - k2)
    # the trained parameters of stage 1 (the embeddings and the projector;
    # stage 2's are the whole decoder, whose first step is compared)
    after = {}
    if stage == "stage1":
        trained = dict(params.named_parameters())
        after = trainer.gathered([trained[n].detach() for n in trainer.names])
    return {"loss": float(loss), "grads": full, "losses": losses,
            "params": {n: t.float().cpu() for n, t in after.items()},
            "k1": launches[0], "k2": launches[1], "seconds": seconds,
            "ce_widths": widths,
            "batch": tuple(batch["input_ids"].shape),
            "peak": torch.cuda.max_memory_allocated()}


@contextlib.contextmanager
def ce_widths():
    """Within the block, the logits' width that each cross entropy over
    the vocabulary shares reads (`TensorParallel.cross_entropy`), listed in
    the list yielded: on a (1, 1, N) mesh the loss's one call a step at
    vocab/N columns; none at world 1, whose loss takes the whole row."""
    from valley_tpu_torch.parallel import tensor

    seen = []
    ce = tensor.TensorParallel.cross_entropy

    def recording(self, logits, targets):
        seen.append(logits.shape[-1])
        return ce(self, logits, targets)

    tensor.TensorParallel.cross_entropy = recording
    try:
        yield seen
    finally:
        tensor.TensorParallel.cross_entropy = ce


def gloo_rank_main(rank: int, out: Path) -> None:
    """One rank of `gloo_fsdp_phase`, in a process of its own: stage 1 at
    (1, 2, 1), then stage 1 and full stage 2 at (1, 1, 2), over one gloo
    process group; rank 0 writes what it read to ``out/rank0.pt`` and
    ``out/tp_rank0.pt`` (with every rank's K1 and K2 launches)."""
    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import create_mesh

    distributed.initialize(f"file://{out}/store", 2, rank, device="cuda:0",
                           backend="gloo")
    try:
        got = gloo_train("stage1", create_mesh(1, 2, 1, "cuda"), out, rank)
        if rank == 0:
            torch.save(got, out / "rank0.pt")
        del got
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tp_mesh = create_mesh(1, 1, 2, "cuda")
        tp = {}
        for stage in GLOO_STAGES:
            tp[stage] = gloo_train(stage, tp_mesh, out, rank)
            every = [None, None]
            torch.distributed.all_gather_object(
                every, (tp[stage]["k1"], tp[stage]["k2"], tp[stage]["peak"]))
            tp[stage]["every_rank"] = every
            gc.collect()
            torch.cuda.empty_cache()
        tp["seconds"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(tp, out / "tp_rank0.pt")
    finally:
        distributed.shutdown()


def gloo_compare(tag: str, got: dict, ref: dict, loss_tol: float,
                 grad_tol: float, names=None) -> tuple:
    """The first step's loss against world 1's within ``loss_tol`` and
    each gradient of ``names`` (default: every trainable one) within
    ``grad_tol`` relative L2; returns (the reading's parts, the checks
    as (ok, what)), so that every reading is printed before a check
    fails."""
    diff = abs(got["loss"] - ref["loss"])
    checks = [(diff <= loss_tol, f"{tag}: first-step loss differs by "
               f"{diff}"),
              (sorted(got["grads"]) == sorted(ref["grads"]),
               f"{tag}: trainable {sorted(got['grads'])}"),
              (all(np.isfinite(got["losses"])), f"{tag}: loss not finite")]
    parts = [f"loss {got['loss']:.5f} vs {ref['loss']:.5f} (diff "
             f"{diff:.2e}, tol {loss_tol})"]
    errs = {n: rel_l2(got["grads"][n], ref["grads"][n])
            for n in names or sorted(ref["grads"])}
    checks += [(e <= grad_tol, f"{tag}: {n} grad rel L2 {e} > {grad_tol}")
               for n, e in errs.items()]
    worst = max(errs, key=errs.get)
    parts.append(f"{len(errs)} gradients rel L2 <= {errs[worst]:.2e} "
                 f"({worst}; tol {grad_tol})")
    return parts, checks


def gloo_fsdp_phase(smi: str, gen, work: Path) -> list:
    """Two ranks on the one card (gloo over CUDA tensors, a file store in
    the run's scratch directory) against world 1 with no group, in this
    process, on the same weights and global batch: at mesh (1, 2, 1) stage
    1 at stage 1's bars of PERF.md §2 (the first step's loss within
    TRAIN_LOSS_TOL, the projector's and embeddings' gradients within
    TRAIN_GRAD_TOL relative L2); at (1, 1, 2) (the model axis: each rank on
    16 of the 32 heads, K1 and K2 on them) stage 1 at the same bars and
    full stage 2 at stage 2's, every trainable gradient; each run's
    gathered trainable parameters' largest difference after
    `GLOO_UPDATES` updates, printed.  Then K1 and K2 at the rank's shapes
    timed.  Returns the kernels entries of the (1, 1, 2) run."""
    out = work / "gloo_fsdp"
    out.mkdir()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--gloo-rank",
                               str(r), "--out", str(out)])
             for r in range(2)]
    try:
        ref = {}
        for stage in GLOO_STAGES:
            ref[stage] = gloo_train(stage, None, out, None)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        rcs = [p.wait(timeout=600) for p in procs]
    gc.collect()
    torch.cuda.empty_cache()
    check(rcs == [0, 0], f"gloo: the ranks exited {rcs}")
    got = torch.load(out / "rank0.pt")
    parts, checks = gloo_compare("gloo fsdp", got, ref["stage1"],
                                 TRAIN_LOSS_TOL, TRAIN_GRAD_TOL,
                                 ["projector.w", "llama.embed"])
    check(sorted(got["grads"]) == ["llama.embed", "projector.b",
                                   "projector.w"],
          f"gloo fsdp: trainable {sorted(got['grads'])}")
    moved = {n: float((got["params"][n] - ref["stage1"]["params"][n])
                      .abs().max()) for n in got["params"]}
    check(got["k1"] == GLOO_UPDATES * 2 * GLOO_LAYERS
          and got["k2"] == GLOO_UPDATES * GLOO_LAYERS,
          f"gloo fsdp: rank 0 launched K1 {got['k1']} K2 {got['k2']}")
    r1 = ref["stage1"]
    print(f"gloo fsdp: 7B width, {GLOO_LAYERS} layers, stage 1, global batch "
          f"16x512 (rank 0's rows {got['batch']}), mesh (1, 2, 1) over gloo "
          f"against world 1: " + "; ".join(parts) + f"; losses of "
          f"{GLOO_UPDATES} updates {[round(x, 5) for x in got['losses']]} vs "
          f"{[round(x, 5) for x in r1['losses']]}; gathered trainable "
          f"parameters' largest difference after them: " + ", ".join(
              f"{n} {d:.3e}" for n, d in moved.items()) +
          f"; rank 0 launched K1 {got['k1']} and K2 {got['k2']}; "
          f"{GLOO_UPDATES} updates {got['seconds']:.2f} s at world 2 (gloo, "
          f"host-staged) vs {r1['seconds']:.2f} s at world 1, on {smi}")
    for ok, what in checks:
        check(ok, what)
    tp = torch.load(out / "tp_rank0.pt")
    # the model axis's runs in the ranks, after their (1, 2, 1) run
    print(f"phase gloo_tp (the ranks' (1, 1, 2) runs): "
          f"{tp['seconds']:.1f} s", flush=True)
    t_times = time.perf_counter()
    entries = []
    for stage in GLOO_STAGES:
        g, r = tp[stage], ref[stage]
        tols = (GLOO_TP_LOSS_TOL, TRAIN_GRAD_TOL) if stage == "stage1" \
            else (STAGE2_LOSS_TOL, STAGE2_GRAD_TOL)
        tag = f"gloo tp {stage}"
        parts, checks = gloo_compare(tag, g, r, *tols)
        moved = max(((float((g["params"][n] - r["params"][n]).abs().max()), n)
                     for n in g["params"]), default=None)
        want = (GLOO_UPDATES * 2 * GLOO_LAYERS, GLOO_UPDATES * GLOO_LAYERS)
        checks += [((k1, k2) == want, f"{tag}: rank {rank} launched K1 {k1} "
                    f"K2 {k2}, want {want}")
                   for rank, (k1, k2, _) in enumerate(g["every_rank"])]
        # the loss over the vocabulary shares: one cross entropy a step on
        # the rank's 16000 columns, never the row's 32000
        checks.append((g["ce_widths"] == [TP_VOCAB // 2] and not
                       r["ce_widths"], f"{tag}: cross entropies read "
                       f"{g['ce_widths']} columns (world 1 "
                       f"{r['ce_widths']}), want [{TP_VOCAB // 2}]"))
        print(f"{tag}: 7B width, {GLOO_LAYERS} layers, batch "
              f"{g['batch']} on each rank, mesh (1, 1, 2) over gloo (16 of "
              f"the 32 heads, 5504 of the 11008 MLP columns and 16000 of the "
              f"32000 vocabulary rows a rank; the tower's 8 of 16 heads and "
              f"the projector's 2048 of 4096 outputs; the loss over the "
              f"vocabulary shares, its cross entropies on "
              f"{g['ce_widths']} columns) against world 1: "
              + "; ".join(parts) + f"; losses of {GLOO_UPDATES} updates "
              f"{[round(x, 5) for x in g['losses']]} vs "
              f"{[round(x, 5) for x in r['losses']]}; "
              + ("" if moved is None else f"gathered trainable parameters' "
                 f"largest difference after them {moved[0]:.3e} "
                 f"({moved[1]}); ") + "K1 and K2 launches a rank "
              + ", ".join(f"rank {i} {k1}/{k2} (peak {p / 2 ** 30:.2f} GiB)"
                          for i, (k1, k2, p) in enumerate(g["every_rank"]))
              + f"; {GLOO_UPDATES} updates {g['seconds']:.2f} s (gloo, "
              f"host-staged) vs {r['seconds']:.2f} s at world 1, on {smi}")
        for ok, what in checks:
            check(ok, what)
        case = flash_train_case(gen, stage, 16)
        e1, e2, k1t, k2t = flash_train_check(case, timed=True)
        path = f"train_tp_gloo (1, 1, 2) {stage}, {GLOO_LAYERS} layers"
        entries += [{**K1_SRC, "name": "flash_fwd_train", "path": path,
                     "launches": g["k1"], "shape": case[0], **k1t},
                    {**K2_SRC, "path": path, "launches": g["k2"],
                     "shape": case[0], **k2t}]
        del case
    print(f"phase gloo_tp_kernels (K1/K2 at the ranks' shapes): "
          f"{time.perf_counter() - t_times:.1f} s", flush=True)
    print(f"gloo: {time.perf_counter() - t0:.1f} s in all")
    return entries


def profile_steps_phase(smi: str, work: Path) -> dict:
    """A short stage-1 trainer at Valley-7B's width, cut to 2 layers, with
    ``profile_steps: "1:2"``: three updates, the second traced by
    `profiling.trace` into ``<output_dir>/trace``; the trace must hold K1's
    and K2's kernels, K1 twice a layer (forward and recompute) and K2
    once.  A trace without device events is taken again, as `traced`
    takes its traces, up to `PROFILE_ATTEMPTS` runs.  Returns the
    launches counted over the traced update."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.dataset import (
        DataCollatorForSupervisedDataset, DataLoader)
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS, TrainRows
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer
    from valley_tpu_torch.utils import profiling

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    layers = 2
    cfg = cfg.replace(text=dataclasses.replace(cfg.text,
                                               num_hidden_layers=layers))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        out = work / f"profile_steps_{attempt}"
        params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(
            1), torch.bfloat16, "cuda")
        loader = DataLoader(TrainRows(cfg), 16,
                            DataCollatorForSupervisedDataset(
                                pad_token_id=0, pad_to_multiple=64),
                            seed=0, num_workers=1)
        tc = TrainConfig(output_dir=str(out), learning_rate=2e-3,
                         num_train_epochs=3, freeze_backbone=True,
                         tune_mm_mlp_adapter=True, save_steps=0,
                         per_device_train_batch_size=16,
                         profile_steps="1:2")
        trainer = Trainer(cfg, tc, params, loader)
        k1, k2 = flash_attention.launches, flash_attention_bwd.launches
        t0 = time.perf_counter()
        check(trainer.train(resume=False) == 3, "profile_steps: updates")
        k1, k2 = flash_attention.launches - k1, flash_attention_bwd.launches \
            - k2
        files = sorted(f.name for f in (out / "trace").iterdir())
        counts = profiling.kernel_counts(str(out / "trace"))
        fwd = sum(n for k, n in counts.items() if "flash_fwd_kernel" in k)
        bwd = sum(n for k, n in counts.items() if "flash_bwd_kernel" in k)
        shutil.rmtree(out, ignore_errors=True)
        del trainer, params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"profile_steps: 3 updates in {time.perf_counter() - t0:.1f} s "
              f"(K1 {k1}, K2 {k2} launches), the trace "
              f"{[f[-40:] for f in files]} under <output_dir>/trace holds "
              f"{sum(counts.values())} kernel events, K1 {fwd}, K2 {bwd}",
              flush=True)
        check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
              f"profile_steps: trace files {files}")
        check(k1 == 3 * 2 * layers and k2 == 3 * layers,
              f"profile_steps: launches K1 {k1} K2 {k2}")
        if counts:
            break
        print(f"profiler: profile_steps trace {attempt} recorded no device "
              f"events", flush=True)
    check(fwd == 2 * layers and bwd == layers, f"profile_steps: the traced "
          f"update holds K1 {fwd} and K2 {bwd} kernels, want {2 * layers} "
          f"and {layers}")
    return {"k1": fwd, "k2": bwd}


# The training shapes of K1 and K2 on a rank of a model axis (its heads:
# `TP_SHAPES`): stage 1's global batch of 16 rows of 512 (the batch world
# is 1 at (1, 1, N)) and stage 2's one row of 2048
TP_TRAIN_SHAPES = {"stage1": (16, 512), "stage2": (1, STAGE2_SEQ)}


def flash_train_case(gen, stage: str, heads: int) -> tuple:
    """(name, q, k, v, dout, kv_mask) of a training step's attention at
    ``stage``'s shape (`TP_TRAIN_SHAPES`) over ``heads`` heads of 128:
    stage 1's rows 300-512 long, stage 2's row with a padded tail."""
    b, s = TP_TRAIN_SHAPES[stage]
    q, k, v, g = (torch.randn((b, s, heads, 128), generator=gen,
                              device="cuda").bfloat16() for _ in range(4))
    if b > 1:
        lengths = torch.randint(300, s + 1, (b,), generator=gen,
                                device="cuda")
    else:
        lengths = torch.tensor([s - 58], device="cuda")
    mask = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    return f"{stage}_B{b}_S{s}_H{heads}_D128", q, k, v, g, mask


def flash_train_check(case, timed: bool) -> tuple:
    """K1's forward and K2's backward on ``case`` (causal) against their
    plain versions at `tolerance`; with ``timed`` each one's times beside
    its bound and SDPA's forward or backward.  Returns (K1's error, K2's
    error, K1's times or None, K2's times or None)."""
    from valley_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    name, q, k, v, g, mask = case
    out, lse = flash_attention(q, k, v, mask, causal=True, return_lse=True)
    ref = flash_attention_plain(q, k, v, mask, causal=True)
    e1, tol = max_err(out, ref), tolerance(ref)
    check(bool(torch.isfinite(out.float()).all()) and e1 <= tol,
          f"K1 {name}: max abs err {e1} > {tol}")
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True)
    rb = flash_attention_bwd_plain(q, k, v, mask, out, lse, g, causal=True)
    e2 = 0.0
    for what, a, r in zip(("dq", "dk", "dv"), got, rb):
        e, t = max_err(a, r), tolerance(r)
        check(bool(torch.isfinite(a.float()).all()) and e <= t,
              f"K2 {name} {what}: max abs err {e} > {t}")
        e2 = max(e2, e)
    del ref, got, rb
    if not timed:
        return e1, e2, None, None
    k1 = {"max_abs_err": e1, **kernel_times(
        lambda: flash_attention(q, k, v, mask, causal=True),
        lambda: flash_attention_plain(q, k, v, mask, causal=True), iters=5)}
    add_bound(k1, attention_bound(q, k, mask, True, 2, lse.numel() * 4),
              f"K1 {name}")
    k1["library_ms"] = library_attention_ms(q, k, v, mask, True, iters=5)
    k2 = {"max_abs_err": e2, **kernel_times(
        lambda: flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True),
        lambda: flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                          causal=True), iters=5)}
    add_bound(k2, attention_bound(
        q, k, mask, True, 5, (g.numel() + q.numel() + 2 * k.numel())
        * g.element_size() + lse.numel() * 4), f"K2 {name}")
    k2["library_ms"] = library_attention_ms(q, k, v, mask, True, dout=g,
                                            iters=5)
    print(f"K1/K2 {name}: max abs err {e1:.3e} / {e2:.3e}; K1 "
          f"{fmt_times(k1)}, bound {k1['bound_ms']:.4f} ms, library "
          f"{k1['library_ms']:.4f} ms; K2 {fmt_times(k2)}, bound "
          f"{k2['bound_ms']:.4f} ms, library {k2['library_ms']:.4f} ms")
    return e1, e2, k1, k2


def flash_stage2_phase(gen, mask) -> tuple:
    """K1 and K2 at the stage-2 shape (B1 S2048 H32 D128, causal, the
    training batch's own kv mask) against their plain versions, each with
    a planted fault (causality ignored), timed beside its bound and SDPA's
    time.  Returns (K1's entry, K2's entry)."""
    from valley_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    name = f"stage2_B1_S{STAGE2_SEQ}_H32_D128"
    q, k, v, g = (torch.randn((1, STAGE2_SEQ, 32, 128), generator=gen,
                              device="cuda").bfloat16() for _ in range(4))
    check(not bool(mask.all()), "K1/K2 stage 2: the batch's mask has no hole")
    out, lse = flash_attention(q, k, v, mask, causal=True, return_lse=True)
    ref = flash_attention_plain(q, k, v, mask, causal=True)
    err, tol = max_err(out, ref), tolerance(ref)
    check(bool(torch.isfinite(out.float()).all()) and err <= tol,
          f"K1 {name}: max abs err {err} > {tol}")
    # planted fault: a kernel attending the keys after each query
    fault = max_err(flash_attention(q, k, v, mask, causal=False), ref) / tol
    check(fault > 1.0, f"K1 {name}: attending later keys moved out by "
          f"{fault:.3f} of the tolerance only")
    k1 = {"max_abs_err": err, **kernel_times(
        lambda: flash_attention(q, k, v, mask, causal=True),
        lambda: flash_attention_plain(q, k, v, mask, causal=True), iters=5)}
    add_bound(k1, attention_bound(q, k, mask, True, 2, lse.numel() * 4),
              f"K1 {name}")
    k1["library_ms"] = library_attention_ms(q, k, v, mask, True, iters=5)
    print(f"K1 flash_fwd {name} ({int(mask.sum())} valid): max_abs_err "
          f"{err:.3e} (tol {tol:.3e}; attending later keys {fault:.1f}x, "
          f"must fail) {fmt_times(k1)}; bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}), library {k1['library_ms']:.4f} ms"
          + attention_rates(k1))
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True)
    rb = flash_attention_bwd_plain(q, k, v, mask, out, lse, g, causal=True)
    k2_err = 0.0
    for what, a, r in zip(("dq", "dk", "dv"), got, rb):
        e, t = max_err(a, r), tolerance(r)
        check(bool(torch.isfinite(a.float()).all()) and e <= t,
              f"K2 {name} {what}: max abs err {e} > {t}")
        k2_err = max(k2_err, e)
    bad = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=False)
    fault2 = max(max_err(a, r) / tolerance(r) for a, r in zip(bad, rb))
    check(fault2 > 1.0, f"K2 {name}: attending later keys moved the "
          f"gradients by {fault2:.3f} of the tolerance only")
    k2 = {"max_abs_err": k2_err, **kernel_times(
        lambda: flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True),
        lambda: flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                          causal=True), iters=5)}
    add_bound(k2, attention_bound(
        q, k, mask, True, 5, (g.numel() + q.numel() + 2 * k.numel())
        * g.element_size() + lse.numel() * 4), f"K2 {name}")
    k2["library_ms"] = library_attention_ms(q, k, v, mask, True, dout=g,
                                            iters=5)
    print(f"K2 flash_bwd {name}: max_abs_err {k2_err:.3e} (attending later "
          f"keys {fault2:.1f}x, must fail) {fmt_times(k2)}; bound "
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}), library "
          f"{k2['library_ms']:.4f} ms" + attention_rates(k2))
    del q, k, v, g, out, lse, ref, got, rb, bad
    return k1, k2


def train_path(smi: str, gen, work: Path) -> list:
    """K2 (and K1 at the training shape) against the plain versions, then
    the training slices: stage 1, with full remat and ``"dots"``; a short
    trainer with ``profile_steps``; LoRA stage 2 (through `Trainer`, then
    the entry point, the adapter's merge and serving, the generate-eval);
    full stage 2, on the device, with the optimizer offloaded and through
    the sharded path at world 1 over NCCL (valley_stage2_zero3.yaml); stage
    1 on two ranks of the one card over gloo against world 1 at (1, 2, 1),
    then stage 1 and full stage 2 at (1, 1, 2) (the model axis); then K1
    and K2 at stage 2's shape.  Returns its kernels entries."""
    k2_err, k2_t, k1_train = k2_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    train_k1, train_k2, train_delta, dots = train_phase(smi)
    prof = profile_steps_phase(smi, work)
    corpus = write_stage2_corpus(work / "stage2_corpus")
    lora_r, mask = stage2_lora_phase(smi, corpus)
    out = stage2_entry_phase(smi, corpus, work)
    stage2_merge_phase(smi, corpus, out)
    full_r, host = stage2_full_phase(smi, corpus)
    off_r = stage2_offload_phase(smi, corpus, full_r, host)
    zero3_r = stage2_zero3_phase(smi, corpus, full_r, host, work)
    del host
    gloo_entries = gloo_fsdp_phase(smi, gen, work)
    k1_s2, k2_s2 = flash_stage2_phase(gen, mask)
    return [{**K1_SRC, "name": "flash_fwd_train", "path": "train",
             "launches": train_k1, **k1_train},
            {**K2_SRC, "name": "flash_bwd", "path": "train",
             "launches": train_k2, "delta_launches": train_delta,
             "max_abs_err": k2_err, **k2_t},
            {**K1_SRC, "name": "flash_fwd_stage2", "path": "train_lora",
             "launches": lora_r["k1"], **k1_s2},
            {**K2_SRC, "name": "flash_bwd_stage2", "path": "train_lora",
             "launches": lora_r["k2"], **k2_s2},
            {**K1_SRC, "name": "flash_fwd_stage2", "path": "train_full",
             "launches": full_r["k1"], **k1_s2},
            {**K2_SRC, "name": "flash_bwd_stage2", "path": "train_full",
             "launches": full_r["k2"], **k2_s2},
            {**K1_SRC, "name": "flash_fwd_stage2", "path": "train_offload",
             "launches": off_r["k1"], **k1_s2},
            {**K2_SRC, "name": "flash_bwd_stage2", "path": "train_offload",
             "launches": off_r["k2"], **k2_s2},
            {**K1_SRC, "name": "flash_fwd_stage2", "path": "train_zero3",
             "launches": zero3_r["k1"], **k1_s2},
            {**K2_SRC, "name": "flash_bwd_stage2", "path": "train_zero3",
             "launches": zero3_r["k2"], **k2_s2},
            {**K1_SRC, "name": "flash_fwd_train", "path": "train_dots",
             "launches": dots[0], **k1_train},
            {**K2_SRC, "name": "flash_bwd", "path": "train_dots",
             "launches": dots[1], "max_abs_err": k2_err, **k2_t},
            {**K1_SRC, "name": "flash_fwd_train",
             "path": "train_profile_steps (2 layers, the traced update)",
             "launches": prof["k1"], **k1_train},
            {**K2_SRC, "name": "flash_bwd",
             "path": "train_profile_steps (2 layers, the traced update)",
             "launches": prof["k2"], "max_abs_err": k2_err, **k2_t}
            ] + gloo_entries


# The serve_variants process: K8, the quantized tower, the learned pooling
# at full width, and Valley-13B served int4gpa8 with an int8a8 tower and
# transformer pooling.
# Valley-13B's fused int4gpa8 projections, (name, K, F): each prefill chunk
# runs each of them once a layer through K8
K8_SHAPES_13B = (("wqkv", 5120, 15360), ("wo", 5120, 5120),
                 ("w_gateup", 5120, 27648), ("w_down", 13824, 5120))
# K8's rows: bench's 512 bucket, and the a8 gate's 128
K8_ROWS = (512, 128)
K8_SRC = dict(route="cuda", source="valley_tpu_torch/csrc/w4a8_group_gemm.cu",
              replaces="valley_tpu/models/llama.py:210")
K8Q_SRC = dict(K8_SRC, replaces="valley_tpu/models/llama.py:232")
# K8 at ragged rows and outputs and at every group size but int4gpa8's,
# (T, K, F, group), fp32 and bf16 out; the last, 13B's wqkv grouped by 64,
# runs the general main loop at a width the card serves
K8_EDGE = ((130, 1024, 130, 32), (200, 256, 130, 64), (513, 512, 130, 256),
           (300, 2048, 384, 128), (512, 5120, 15360, 64))
# The H100 SXM's dense int8 tensor-core peak (NVIDIA's datasheet), K8's
# bound for its operations
INT8_OPS_PER_S = 1979e12
# K8's times: its device time, its plain version's and the yardsticks'
# (the int8 library product looped over the groups with the rescale, and
# one ungrouped int8 product) by CUDA events, and its bound
K8_TIME_KEYS = ("ms", "plain_ms", "bound_ms", "library_ms",
                "int_mm_loop_ms", "int_mm_ms")


def w4a8_inputs(gen, t: int, k: int, f: int, group: int = 128) -> tuple:
    """K8's inputs at (T, K, F): per-token int8 activations of N(0, 1)
    values with their absmax-times-1/127 scales, as `llama._w4a8_group_dot`
    quantizes them (the plain version, `w4a8.quantize_tokens_plain`), and
    an int4 weight with scales of ``group`` inputs (`int4_weight`)."""
    from valley_tpu_torch.ops.w4a8 import quantize_tokens_plain

    xq, a = quantize_tokens_plain(
        torch.randn((t, k), generator=gen, device="cuda"))
    return (xq, a.reshape(-1)) + int4_weight(gen, f, k, group)


def int_mm_yardsticks(xq, w, scale, iters: int) -> dict:
    """Milliseconds a call (CUDA events around ``iters`` calls) of the
    library's int8 product on K8's values (the weight unpacked to int8
    beforehand): looped over the K/128 groups with the fp32 rescale and
    sum (what no single call computes), and one ungrouped product over the
    same bytes.  Yardsticks only: the port never calls them."""
    from valley_tpu_torch.ops.quant import unpack_int4

    w8 = unpack_int4(w)
    n = scale.shape[1]
    xs = [xq[:, g * 128:(g + 1) * 128].contiguous() for g in range(n)]
    ws = [w8[:, g * 128:(g + 1) * 128].contiguous() for g in range(n)]
    s = scale.float()

    def looped():
        acc = torch._int_mm(xs[0], ws[0].t()).float() * s[:, 0]
        for g in range(1, n):
            acc += torch._int_mm(xs[g], ws[g].t()).float() * s[:, g]
        return acc

    return {"int_mm_loop_ms": time_ms(looped, iters, 1),
            "int_mm_ms": time_ms(lambda: torch._int_mm(xq, w8.t()), iters,
                                 1)}


def k8_phase(gen) -> tuple:
    """K8 against its plain version at Valley-13B's four fused projections
    at 512 and 128 rows (each bit-equal to the plain version, whose
    arithmetic it repeats; a planted fault: the group scales shifted by
    one group), each timed (its device time by the profiler; the plain
    version and the library yardsticks by CUDA events) beside its bound
    (the int8 operations at 1979 TOPS, or the bytes at 3.35 TB/s); then
    at `K8_EDGE` (ragged rows and outputs, groups of 32, 64, 128 and 256),
    bit-equal in fp32 and bf16.  Returns (max error, {rows: times per call
    averaged over one layer's four products}, {rows: launches})."""
    from valley_tpu_torch.ops.w4a8 import w4a8_group_gemm, w4a8_group_plain

    err_max, avg, launches = 0.0, {}, {}
    for rows in K8_ROWS:
        per_shape = {}
        w4a8_group_gemm.launches = 0
        for name, k, f in K8_SHAPES_13B:
            xq, a, w, scale = w4a8_inputs(gen, rows, k, f)
            out = w4a8_group_gemm(xq, a, w, scale, torch.bfloat16)
            torch.cuda.synchronize()
            ref = w4a8_group_plain(xq, a, w, scale, torch.bfloat16)
            err, tol = max_err(out, ref), tolerance(ref)
            check(out.dtype == torch.bfloat16 and tuple(out.shape) == (rows, f)
                  and bool(torch.isfinite(out).all()),
                  f"K8 {name} T{rows}: dtype, shape or not finite")
            check(err <= tol, f"K8 {name} T{rows}: max abs err {err} > {tol}")
            check(torch.equal(out, ref), f"K8 {name} T{rows}: max abs err "
                  f"{err}, not bit-equal to the plain version")
            err_max = max(err_max, err)
            line = (f"K8 w4a8_group_gemm 13b_{name} T{rows} ({f}x{k}): "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}; bit-equal to the "
                    f"plain version: {torch.equal(out, ref)})")
            if name == "wqkv" and rows == K8_ROWS[0]:
                fault = max_err(w4a8_group_gemm(
                    xq, a, w, scale.roll(1, dims=1).contiguous(),
                    torch.bfloat16), ref)
                check(fault > tol, f"K8 {name}: shifted group scales moved "
                      f"the output by {fault} only, within {tol}")
                line += f"; scales shifted by one group: {fault:.3e} " \
                    "(must fail)"
            t = {"ms": profile_device(lambda: w4a8_group_gemm(
                xq, a, w, scale, torch.bfloat16), 10)[0],
                 "plain_ms": time_ms(lambda: w4a8_group_plain(
                     xq, a, w, scale, torch.bfloat16), 3, 1)}
            # bytes: x and its scales, the packed weight and its scales, the
            # bf16 output, once each; the int8 operations at the int8 peak
            n_bytes = xq.numel() + 4 * rows + w.numel() + \
                2 * scale.numel() + 2 * rows * f
            add_bound(t, bound(n_bytes, 2 * rows * f * k, INT8_OPS_PER_S),
                      f"K8 {name} T{rows}")
            t["library_ms"] = None
            t.update(int_mm_yardsticks(xq, w, scale, 10))
            per_shape[name] = t
            line += (f" device {t['ms']:.4f} ms vs plain (CUDA events) "
                     f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                     f"({t['bound_by']}), {bound_share(t)}, "
                     f"{2 * rows * f * k / t['ms'] / 1e9:.1f} TOPS; "
                     f"yardsticks by CUDA events: torch._int_mm over the "
                     f"groups with the "
                     f"rescale {t['int_mm_loop_ms']:.4f} ms, one ungrouped "
                     f"torch._int_mm {t['int_mm_ms']:.4f} ms")
            print(line)
            del xq, a, w, scale, out, ref
        launches[rows] = w4a8_group_gemm.launches
        layer = {key: None if any(t[key] is None for t in per_shape.values())
                 else sum(t[key] for t in per_shape.values())
                 for key in K8_TIME_KEYS}
        avg[rows] = {key: None if v is None else v / len(K8_SHAPES_13B)
                     for key, v in layer.items()}
        avg[rows]["bound_by"] = max(
            ("bytes", "operations"), key=lambda b: sum(
                t["bound_ms"] for t in per_shape.values()
                if t["bound_by"] == b))
        avg[rows]["rows"] = rows
        avg[rows]["per_projection_ms"] = {n: t["ms"]
                                          for n, t in per_shape.items()}
        print(f"K8 w4a8_group_gemm per layer at T{rows} (wqkv, wo, w_gateup, "
              f"w_down): device {layer['ms']:.4f} ms vs plain "
              f"{layer['plain_ms']:.4f} ms; bound {layer['bound_ms']:.4f} ms "
              f"({100 * layer['bound_ms'] / layer['ms']:.1f}%); torch._int_mm "
              f"looped {layer['int_mm_loop_ms']:.4f} ms, ungrouped "
              f"{layer['int_mm_ms']:.4f} ms")
    for t_, k, f, group in K8_EDGE:
        xq, a, w, scale = w4a8_inputs(gen, t_, k, f, group)
        for dtype in (torch.float32, torch.bfloat16):
            out = w4a8_group_gemm(xq, a, w, scale, dtype)
            ref = w4a8_group_plain(xq, a, w, scale, dtype)
            check(torch.equal(out, ref), f"K8 T{t_} K{k} F{f} group {group} "
                  f"{dtype}: max abs err {max_err(out, ref)}, not bit-equal")
        print(f"K8 w4a8_group_gemm T{t_} K{k} F{f} group {group}: fp32 and "
              f"bf16 bit-equal to the plain version")
    return err_max, avg, launches


# K8q's shapes: the 13B projections' inputs at bench's 512 rows (hidden
# 5120 and w_down's 13824) and the gate's 128, bf16 as the decoder gives
# them
K8Q_SHAPES = ((512, 5120), (512, 13824), (128, 5120))


def k8q_phase(gen) -> dict:
    """K8q against the plain quantization (`w4a8.quantize_tokens_plain`),
    bit for bit in xq and a: on exact .5 ties (fp32 and bf16), all-zero
    rows (the 1e-6 clamp) and a subnormal absmax, on the card and on the
    CPU, then at `K8Q_SHAPES` on the card, each timed (the profiler; the
    plain version by CUDA events) beside its bytes bound (x read, xq and a
    written, once each).  Returns the times at 512 rows of hidden 5120 and
    ``max_abs_err``, the largest difference in xq or a over every case."""
    from valley_tpu_torch.ops.w4a8 import (quantize_tokens,
                                           quantize_tokens_plain)

    ties = torch.zeros((4, 256), device="cuda")
    ties[:, 0] = 127.0       # a scale of 1.0: the values are .5 ties
    ties[:, 1:] = (torch.arange(255, device="cuda") % 254 - 126.5)[None]
    ties[1] *= -1
    sub = torch.full((2, 256), 1e-40, device="cuda")
    sub[1, 3] = -2e-39
    edges = {"ties fp32": ties, "ties bf16": ties.bfloat16(),
             "zeros": torch.zeros((2, 256), device="cuda"),
             "subnormal absmax": sub}
    def err(xq, a, rq, ra) -> float:
        return max(max_err(xq.cpu(), rq.cpu()), max_err(a.cpu(), ra.cpu()))

    err_max = 0.0
    for label, x in edges.items():
        xq, a = quantize_tokens(x)
        for rq, ra in (quantize_tokens_plain(x),
                       quantize_tokens_plain(x.cpu())):
            check(torch.equal(xq.cpu(), rq.cpu()) and
                  torch.equal(a.cpu(), ra.cpu()),
                  f"K8q {label}: not bit-equal to the plain version")
            err_max = max(err_max, err(xq, a, rq, ra))
    print("K8q quantize_tokens: exact .5 ties (fp32, bf16), all-zero rows "
          "and a subnormal absmax bit-equal to the plain version on the card "
          "and on the CPU")
    out = None
    for t_, k in K8Q_SHAPES:
        x = torch.randn((t_, k), generator=gen, device="cuda").bfloat16()
        xq, a = quantize_tokens(x)
        rq, ra = quantize_tokens_plain(x)
        check(torch.equal(xq, rq) and torch.equal(a, ra),
              f"K8q T{t_} K{k}: not bit-equal to the plain version")
        err_max = max(err_max, err(xq, a, rq, ra))
        t = {"ms": profile_device(lambda: quantize_tokens(x), 20)[0],
             "plain_ms": time_ms(lambda: quantize_tokens_plain(x), 20, 2)}
        add_bound(t, bound(2 * x.numel() + xq.numel() + 4 * t_, 0),
                  f"K8q T{t_} K{k}")
        t["library_ms"] = None
        print(f"K8q quantize_tokens T{t_} K{k} bf16: bit-equal to the plain "
              f"version (xq and a); device {t['ms']:.4f} ms vs plain (CUDA "
              f"events, about seven launches) {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {bound_share(t)}")
        if out is None:
            out = t
    return {**out, "max_abs_err": err_max}


# The learned pooling on the card against the same function on the CPU,
# both fp32 (TF32 off), at Valley-7B's and 13B's widths: summation order
# only.  The CPU tests hold the port to JAX within 1e-5 of the largest
# output at tiny widths; 1e-4 leaves room for sums over 4096-5120 inputs.
POOL_TOL = 1e-4
POOL_FRAMES, POOL_VALID = 8, 6


def pooling_phase(gen) -> dict:
    """Both learned pooling variants at Valley-7B and 13B widths (T 8,
    P 256, H 4096 and 5120; random fp32 parameters and features from the
    run's generator), with no mask and with the last two frames masked,
    on the card against the CPU; each timed on the card.  Returns {label:
    device ms per call}."""
    from valley_tpu_torch import valley_7b, valley_13b
    from valley_tpu_torch.models import temporal

    out = {}
    for model, make in (("7b", valley_7b), ("13b", valley_13b)):
        for method in ("temporal_importance", "temporal_transformer"):
            cfg = make(patch_pooling_method=method)
            tp = temporal.init_params(cfg, gen, torch.float32, "cuda")
            tp_cpu = temporal.TemporalWeights(
                {n: p.data.cpu() for n, p in tp.named_parameters()})
            x = torch.randn((POOL_FRAMES, cfg.num_patches,
                             cfg.text.hidden_size), generator=gen,
                            device="cuda")
            mask = torch.arange(POOL_FRAMES, device="cuda") < POOL_VALID
            for m in (None, mask):
                with torch.no_grad():
                    got = temporal.pool_patches(tp, cfg, x, m)
                    ref = temporal.pool_patches(
                        tp_cpu, cfg, x.cpu(), None if m is None else m.cpu())
                err = max_err(got.cpu(), ref)
                tol = POOL_TOL * ref.abs().max().item()
                label = f"{method} {model} {'masked' if m is not None else 'all'}"
                check(tuple(got.shape) == tuple(x.shape[1:])
                      and bool(torch.isfinite(got).all()),
                      f"pooling {label}: shape or not finite")
                check(err <= tol, f"pooling {label}: card vs CPU {err} > "
                      f"{tol}")
                with torch.no_grad():
                    ms = profile_device(
                        lambda: temporal.pool_patches(tp, cfg, x, m), 5)[0]
                out[label] = ms
                print(f"pooling {label} (T {POOL_FRAMES}, P "
                      f"{cfg.num_patches}, H {cfg.text.hidden_size}, fp32"
                      f"{f', {POOL_VALID} valid' if m is not None else ''}): "
                      f"card vs CPU max abs diff {err:.3e} (tol {tol:.3e}); "
                      f"device {ms:.4f} ms per call")
            del tp, tp_cpu, x
    return out


# The int8 towers against the bf16 tower on the same weights and frames,
# relative L2 over the output: per-channel int8 weights (and, for W8A8,
# per-token int8 activations) through 23 layers.  A product that read its
# weight transposed or skipped its scale would err by about 1 or more.
VISION_QUANT_REL = 0.25


def vision_quant_phase(gen) -> dict:
    """The CLIP ViT-L/14 tower over 8 frames (2056 rows) in bf16, int8 and
    int8a8 (the same random weights, quantized on the card), each timed
    (device ms by the profiler and wall) and the quantized outputs against
    the bf16 tower's.  Returns {mode: device ms}."""
    from valley_tpu_torch import valley_13b
    from valley_tpu_torch.models import Weights, clip_vit
    from valley_tpu_torch.ops.quant import quantize_vision_params

    class Tower(Weights):
        NAMES = ("vision",)

    vcfg = valley_13b().vision
    size = vcfg.image_size
    frames = torch.randn((8, 3, size, size), generator=gen,
                         device="cuda").bfloat16()
    out, ref = {}, None
    for mode in (None, "int8", "int8a8"):
        tower = Tower({"vision": clip_vit.init_params(
            vcfg, torch.Generator("cuda").manual_seed(1), torch.bfloat16,
            "cuda")})
        if mode:
            quantize_vision_params(tower, act8=mode == "int8a8")
        fn = lambda: clip_vit.encode(tower["vision"], vcfg, frames)  # noqa
        with torch.no_grad():
            y = fn()
            ms = profile_device(fn, 3)[0]
            wall = time_ms(fn, 3, 1)
        check(tuple(y.shape) == (8, vcfg.num_positions, vcfg.hidden_size)
              and bool(torch.isfinite(y).all()),
              f"tower {mode}: shape or not finite")
        label = mode or "bf16"
        line = (f"vision tower {label} (ViT-L/14, 8 frames of "
                f"{vcfg.num_positions} tokens, to the -2 tap): device "
                f"{ms:.3f} ms, wall {wall:.3f} ms")
        if ref is None:
            ref = y.float()
        else:
            rel = rel_l2(y.float(), ref)
            check(rel <= VISION_QUANT_REL, f"tower {label}: relative L2 "
                  f"{rel} from the bf16 tower over {VISION_QUANT_REL}")
            line += f"; relative L2 from the bf16 tower {rel:.4f}"
        print(line)
        out[label] = ms
        del tower, y
    return out


# The 13B int4gpa8 slice's prefill logits through the kernels (K1, K8)
# against the same prefill on their plain versions.  Not measured before
# this process was written; set as the int8 slice's bar (W8A8 prefill,
# whose kernels-vs-plain readings were 0.155 at the prefill: a one-ulp
# difference moves a quantized activation one int8 step).
W4A8_LOGIT_TOL = 0.3


def variant_slice(cfg, params, smi: str) -> dict:
    """bench's request through Valley-13B int4gpa8 (an int8a8 tower,
    transformer pooling, an int8 KV cache) by CUDA graph: launches of K1,
    K3-int8, K5 and K8 (counts set to 0 just before the request), its 64
    greedy tokens, first-token wall and decode ms/token; the eager step's
    first 16 tokens and launches against the graph's; the prefill's device
    time by kernel; the prefill logits through the kernels against the
    plain versions within `W4A8_LOGIT_TOL`.  Returns the launches and
    walls."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.ops.attention import PLAIN
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int4_matvec, int8_matvec
    from valley_tpu_torch.ops.w4a8 import quantize_tokens, w4a8_group_gemm

    tag = "variant slice"
    layers, new = cfg.text.num_hidden_layers, NEW_TOKENS
    steps = new - 1
    kernels = {"K1": (flash_attention, layers),
               "K3-int8": (decode_attention_stacked, layers * steps),
               "K5": (int4_matvec, 4 * layers * steps + new),
               "K8": (w4a8_group_gemm, 4 * layers),
               "K8q": (quantize_tokens, 4 * layers),
               "K4": (int8_matvec, 0), "K6": (bf16_matvec, 0)}
    prompt, frames = bench_request(cfg, BUCKET)
    gcfg = GenerationConfig(max_new_tokens=new, do_sample=False)
    engine = Engine(cfg, params, buckets=(BUCKET,), max_new_tokens=new,
                    steps_per_call=steps, cache_dtype=torch.int8)
    eager_engine = Engine(cfg, params, buckets=(BUCKET,), max_new_tokens=new,
                          steps_per_call=steps, cache_dtype=torch.int8,
                          decode_ramp=(EAGER_NEW - 1,))

    def run(eager=False, n=new):
        t0 = time.perf_counter()
        t_first, toks = None, []
        eng = eager_engine if eager else engine
        for t in eng.generate_tokens(
                [prompt], frames, GenerationConfig(max_new_tokens=n),
                eos_ids=[-1], eager=eager):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(int(t[0]))
        return t_first, time.perf_counter() - t0, toks

    run()   # warm-up: the decode graph's capture
    for fn, _ in kernels.values():
        fn.launches = 0
    t_first, total, toks = run()
    counts = {k: fn.launches for k, (fn, _) in kernels.items()}
    check(len(toks) == new and all(0 <= t < cfg.text.vocab_size
                                   for t in toks), f"{tag}: tokens")
    for k, (_, want) in kernels.items():
        check(counts[k] == want, f"{tag}: {k} launched {counts[k]} times, "
              f"want {want}")
    decode_ms = (total - t_first) / steps * 1e3
    print(f"{tag}: Valley-13B int4gpa8 (fused, group-128 scales, W4A8 "
          f"prefill), int8a8 tower, temporal_transformer pooling, int8 KV "
          f"cache; prompt {len(prompt)} tokens in bucket {BUCKET}, 8 frames, "
          f"{new} greedy tokens by one replay of a {steps}-step CUDA graph; "
          f"launches " + " ".join(f"{k} {n}" for k, n in counts.items()))
    print(f"{tag}: video->first-token {t_first * 1e3:.2f} ms, decode "
          f"{decode_ms:.3f} ms/token on {smi}")
    run(eager=True, n=EAGER_NEW)
    for fn, _ in kernels.values():
        fn.launches = 0
    e_first, e_total, e_toks = run(eager=True, n=EAGER_NEW)
    e_counts = {k: fn.launches for k, (fn, _) in kernels.items()}
    check(e_toks == toks[:EAGER_NEW], f"{tag}: the graph's tokens differ "
          f"from the eager step's")
    e_want = eager_launches(counts, steps, EAGER_NEW - 1)
    check(e_counts == e_want, f"{tag}: eager launches {e_counts}, want "
          f"{e_want}")
    print(f"{tag}: the eager step gives the graph's first {EAGER_NEW} tokens "
          f"and its launches; decode {(e_total - e_first) / (EAGER_NEW - 1) * 1e3:.3f} "
          f"ms/token eager")
    prefill_ms, top, _ = profile_device(
        lambda: engine.prefill([prompt], frames, gcfg))
    k8_ms = sum(t for name, t in top if "w4a8_group_gemm" in name)
    k8q_ms = sum(t for name, t in top if "quantize_tokens" in name)
    k1_ms = sum(t for name, t in top if "flash_fwd_kernel" in name)
    check(k8_ms > 0, f"{tag}: the profiler saw no K8 in the prefill")
    check(k8q_ms > 0, f"{tag}: the profiler saw no K8q in the prefill")
    print(f"{tag} breakdown: prefill device {prefill_ms:.2f} ms: K8 "
          f"{k8_ms:.2f} ms ({100 * k8_ms / prefill_ms:.1f}%), K8q "
          f"{k8q_ms:.3f} ms ({100 * k8q_ms / prefill_ms:.1f}%), K1 "
          f"{k1_ms:.2f} ms; top kernels: " + ", ".join(
              f"{name[:48]} {ms:.2f} ms" for name, ms in top[:10]))
    plain = Engine(cfg, params, buckets=(BUCKET,), max_new_tokens=new,
                   steps_per_call=steps, cache_dtype=torch.int8,
                   attention=PLAIN)
    lk, lp = (e.prefill([prompt], frames, gcfg).logits[0]
              for e in (engine, plain))
    check(bool(torch.isfinite(lk).all()) and lk.shape == (cfg.text.vocab_size,),
          f"{tag}: prefill logits not finite or misshapen")
    diff = max_err(lk, lp)
    top2 = torch.topk(lp, 2).values
    print(f"{tag}: prefill logits kernels vs plain max abs diff {diff:.4e} "
          f"(tol {W4A8_LOGIT_TOL}; max |logit| {lp.abs().max().item():.3f}), "
          f"greedy token {'agrees' if int(lk.argmax()) == int(lp.argmax()) else 'differs'} "
          f"(plain top-2 margin {(top2[0] - top2[1]).item():.4f}, not "
          f"checked)")
    check(diff <= W4A8_LOGIT_TOL, f"{tag}: prefill logits beyond tolerance")
    del engine, eager_engine, plain
    return {"counts": counts, "first_token_ms": t_first * 1e3,
            "decode_ms_per_token": decode_ms, "prefill_device_ms": prefill_ms,
            "k8_prefill_ms": k8_ms, "k8q_prefill_ms": k8q_ms}


def serve_variants_path(smi: str, gen, work: Path) -> list:
    """The weight formats and pooling of the fourteenth slice: K8 at the
    13B projections (and ragged shapes and other group sizes) and K8q
    against their plain versions, the tensor-parallel shard shapes of every
    serving kernel (`tp_shard_phase`), the pooling variants at 7B
    and 13B widths against the CPU, the int8 and int8a8 towers beside the
    bf16 one, then Valley-13B served int4gpa8 with an int8a8 tower and
    transformer pooling (`variant_slice`).  Returns its kernels
    entries."""
    from valley_tpu_torch import SpecialTokens, valley_13b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
    from valley_tpu_torch.models.llama import fuse_llama_params
    from valley_tpu_torch.ops.quant import (quantize_llama_params,
                                            quantize_vision_params)

    k8_err, k8_t, k8_n = k8_phase(gen)
    k8q_t = k8q_phase(gen)
    tp_entries = tp_shard_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    pooling_phase(gen)
    vision_quant_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = valley_13b(tokens=SpecialTokens(**BENCH_TOKENS),
                     patch_pooling_method="temporal_transformer")
    cfg = serving_depth(cfg, "valley_13b")
    params = random_weights(cfg, "valley_13b")
    t0 = time.perf_counter()
    params = quantize_llama_params(fuse_llama_params(params), act8=True,
                                   bits=4, group_size=128)
    params = quantize_vision_params(params, act8=True)
    torch.cuda.synchronize()
    print(f"variant slice: fused and quantized (int4gpa8, int8a8 tower) in "
          f"{time.perf_counter() - t0:.1f} s")
    sl = variant_slice(cfg, params, smi)
    return [{**K8_SRC, "name": "w4a8_group_gemm", "path": "serve_variants",
             "launches": sl["counts"]["K8"], "max_abs_err": k8_err,
             **k8_t[K8_ROWS[0]],
             "request_first_token_ms": sl["first_token_ms"],
             "request_decode_ms_per_token": sl["decode_ms_per_token"],
             "request_prefill_device_ms": sl["prefill_device_ms"],
             "request_k8_prefill_ms": sl["k8_prefill_ms"]},
            {**K8_SRC, "name": "w4a8_group_gemm_T128",
             "path": "serve_variants, K8 phase only (the a8 gate's 128 rows)",
             "launches": k8_n[K8_ROWS[1]], "max_abs_err": k8_err,
             **k8_t[K8_ROWS[1]]},
            {**K8Q_SRC, "name": "quantize_tokens", "path": "serve_variants",
             "launches": sl["counts"]["K8q"],
             "shape": f"T{K8Q_SHAPES[0][0]} K{K8Q_SHAPES[0][1]} bf16",
             "request_k8q_prefill_ms": sl["k8q_prefill_ms"], **k8q_t}
            ] + tp_entries


# -- tensor parallelism in serving (the mesh's model axis) -----------------

# The per-rank shapes of Valley-7B and -13B cut over 2 and 4 ranks: (model,
# ranks) -> (hidden, ffn, heads).  Column-parallel wqkv and w_gateup keep
# their inputs and take 1/N of their outputs; row-parallel wo and w_down
# take 1/N of their inputs (K split); lm_head 1/N of the vocabulary
TP_SHAPES = {("7b", 2): (4096, 11008, 32), ("7b", 4): (4096, 11008, 32),
             ("13b", 2): (5120, 13824, 40), ("13b", 4): (5120, 13824, 40)}
TP_VOCAB = 32000
TP_GROUP = 128
TP_ROWS = 512


def tp_weights(h: int, f: int, n: int) -> tuple:
    """(name, F, K, kf) of one rank's decode GEMVs at (hidden ``h``, ffn
    ``f``) over ``n`` ranks; kf: the bf16 lm_head's (K, F) layout."""
    return (("wqkv", 3 * h // n, h, False), ("wo", h, h // n, False),
            ("w_gateup", 2 * f // n, h, False), ("w_down", h, f // n, False),
            ("lm_head", TP_VOCAB // n, h, True))


# the bytes of weight copies a shard-shape GEMV walks, 10x the 50 MB L2
TP_WALK_BYTES = 500_000_000


def tp_walk(w: torch.Tensor):
    """A function giving ``w`` or one of its copies in turn, past what the
    L2 keeps of a cyclic walk (as the GEMV phases time their weights)."""
    ws = [w] + [w.clone() for _ in range(
        -(-TP_WALK_BYTES // (w.numel() * w.element_size())) - 1)]
    it = iter(range(10 ** 9))
    return lambda: ws[next(it) % len(ws)]


def tp_timed(tag: str, fn, plain_fn, b: dict, library=None) -> dict:
    """A shard-shape case's times: device time of the kernel and its plain
    version (`kernel_times`), the bound ``b`` beside them, and the device
    time of the library call ``library()`` (None where there is none)."""
    t = kernel_times(fn, plain_fn, iters=10)
    add_bound(t, b, tag)
    t["library_ms"] = None if library is None else library()
    return t


def tp_shard_phase(gen) -> list:
    """K1, K3 (bf16 and int8 cache), K4, K5, K6, K8 and K8q at the per-rank
    shapes of Valley-7B and -13B over 2 and 4 ranks, and K1 and K2 at the
    training shapes there (`TP_TRAIN_SHAPES`), each against its plain
    version at the tolerance of its own phase (`tolerance`; K8 and K8q
    bit-equal); the first case of each serving kernel (7B over 2 ranks)
    timed.  A
    grouped-int4 shard that would cut a group of 128 is the one the
    engine refuses (`sharding._model_cut`), and is skipped with a line.
    Returns the entries, with the launches this check made."""
    from valley_tpu_torch.models.llama import _quantize_kv
    from valley_tpu_torch.ops.decode_attention import (
        decode_attention_plain, decode_attention_stacked)
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd,
                                                      flash_attention_plain)
    from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain
    from valley_tpu_torch.ops.quant import (int4_matvec, int4_matvec_plain,
                                            int8_matvec, int8_matvec_plain)
    from valley_tpu_torch.ops.w4a8 import (quantize_tokens,
                                           quantize_tokens_plain,
                                           w4a8_group_gemm, w4a8_group_plain)

    wrappers = {"K1": flash_attention, "K2": flash_attention_bwd,
                "K3": decode_attention_stacked,
                "K4": int8_matvec, "K5": int4_matvec, "K6": bf16_matvec,
                "K8": w4a8_group_gemm, "K8q": quantize_tokens}
    for w in wrappers.values():
        w.launches = 0
    errs = {k: 0.0 for k in ("K1", "K3", "K3-int8", "K4", "K5", "K6", "K8",
                             "K8q")}
    train_errs = {"K1": 0.0, "K2": 0.0}
    times, where, skipped = {}, {}, []

    def note(kind, name, err, tol, timed=None):
        check(err <= tol, f"tp shard {kind} {name}: max abs err {err} > "
              f"{tol}")
        errs[kind] = max(errs[kind], err)
        if timed is not None and kind not in times:
            times[kind], where[kind] = timed(), name

    for (model, n), (h, f, heads) in TP_SHAPES.items():
        hl, tag = heads // n, f"{model}/{n}"
        for wname, fo, k, kf in tp_weights(h, f, n):
            name = f"{tag} {wname} {fo}x{k}"
            x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
            wb = bf16_weight(gen, k, fo, kf)
            ref = bf16_matvec_plain(x, wb, kf)

            def k6_times():
                walk = tp_walk(wb)
                return tp_timed(
                    f"K6 {name}", lambda: bf16_matvec(x, walk(), kf),
                    lambda: bf16_matvec_plain(x, walk(), kf),
                    bound(2 * wb.numel() + 2 * k + 4 * fo, 2 * k * fo),
                    lambda: library_linear_ms(x, [walk() for _ in range(
                        -(-TP_WALK_BYTES // (2 * wb.numel())))], kf, 10))

            note("K6", name, max_err(bf16_matvec(x, wb, kf), ref),
                 tolerance(ref), k6_times)
            del wb
            w8, s8 = int8_weight(gen, fo, k)
            ref = int8_matvec_plain(x, w8, s8)

            def k4_times():
                walk = tp_walk(w8)
                return tp_timed(
                    f"K4 {name}", lambda: int8_matvec(x, walk(), s8),
                    lambda: int8_matvec_plain(x, walk(), s8),
                    bound(fo * k + 2 * k + 2 * fo + 4 * fo, 2 * k * fo),
                    lambda: library_matvec_ms(x, [walk() for _ in range(
                        -(-TP_WALK_BYTES // w8.numel()))], s8, 10)[0])

            note("K4", name, max_err(int8_matvec(x, w8, s8), ref),
                 tolerance(ref), k4_times)
            del w8, s8
            group = 0 if wname == "lm_head" else TP_GROUP
            if group and k % group:
                skipped.append(f"{name} (K {k} is not whole groups of "
                               f"{group}: the engine refuses this cut)")
                continue
            w4, s4 = int4_weight(gen, fo, k, group)
            ref = int4_matvec_plain(x, w4, s4)

            def k5_times():
                walk = tp_walk(w4)
                return tp_timed(
                    f"K5 {name}", lambda: int4_matvec(x, walk(), s4),
                    lambda: int4_matvec_plain(x, walk(), s4),
                    bound(fo * k // 2 + 2 * s4.numel() + 2 * k + 4 * fo,
                          2 * k * fo),
                    lambda: library_int4_matvec_ms(
                        x, w4, s4, -(-TP_WALK_BYTES // w4.numel()), 10,
                        ref)[0])

            note("K5", name, max_err(int4_matvec(x, w4, s4), ref),
                 tolerance(ref), k5_times)
            if wname != "lm_head":
                xq, a = quantize_tokens_plain(torch.randn(
                    (TP_ROWS, k), generator=gen, device="cuda"))
                a = a.reshape(-1)
                got = w4a8_group_gemm(xq, a, w4, s4)
                ref = w4a8_group_plain(xq, a, w4, s4)
                # no single library call computes the grouped product
                note("K8", name, max_err(got, ref), 0.0, lambda: tp_timed(
                    f"K8 {name}", lambda: w4a8_group_gemm(xq, a, w4, s4),
                    lambda: w4a8_group_plain(xq, a, w4, s4),
                    bound(xq.numel() + 4 * TP_ROWS + w4.numel()
                          + 2 * s4.numel() + 4 * TP_ROWS * fo,
                          2 * TP_ROWS * k * fo, INT8_OPS_PER_S)))
            del w4, s4
        # K8q on a rank's share of the inputs of a row-parallel product,
        # quantized by the token's absmax over every rank's share
        for k in (h // n, f // n):
            x = torch.randn((TP_ROWS, k), generator=gen,
                            device="cuda").bfloat16()
            amax = torch.maximum(x.float().abs().amax(-1), torch.rand(
                (TP_ROWS,), generator=gen, device="cuda") * 4)
            got, ref = quantize_tokens(x, amax), \
                quantize_tokens_plain(x, amax)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"tp shard K8q {tag} K {k}: not bit-equal to the plain")
            note("K8q", f"{tag} K {k}", 0.0, 0.0, lambda: tp_timed(
                f"K8q {tag} K {k}", lambda: quantize_tokens(x, amax),
                lambda: quantize_tokens_plain(x, amax),
                bound(3 * x.numel() + 8 * TP_ROWS, x.numel())))
        # K1 at the rank's heads: a prompt of 473 in the 512 bucket
        name, q, k, v, mask, causal = flash_cases(gen, heads=hl,
                                                  model=tag)[0]
        ref = flash_attention_plain(q, k, v, mask, causal=causal)
        note("K1", name, max_err(flash_attention(q, k, v, mask,
                                                 causal=causal), ref),
             tolerance(ref), lambda: tp_timed(
                 f"K1 {name}",
                 lambda: flash_attention(q, k, v, mask, causal=causal),
                 lambda: flash_attention_plain(q, k, v, mask, causal=causal),
                 attention_bound(q, k, mask, causal, 2, 0),
                 lambda: library_attention_ms(q, k, v, mask, causal,
                                              iters=10)))
        del q, k, v
        # K1 and K2 at the rank's heads at the training shapes (timed on
        # the path that trains at them: `gloo_fsdp_phase`)
        for stage in TP_TRAIN_SHAPES:
            case = flash_train_case(gen, stage, hl)
            e1, e2, _, _ = flash_train_check(case, timed=False)
            train_errs["K1"] = max(train_errs["K1"], e1)
            train_errs["K2"] = max(train_errs["K2"], e2)
            del case
        # K3 at the rank's heads over bench's cache (bf16, and int8)
        valid = torch.zeros((1, SMAX), dtype=torch.bool, device="cuda")
        valid[:, :PROMPT_LEN] = True
        valid[:, BUCKET:BUCKET + 40] = True
        q = torch.randn((1, 1, hl, 128), generator=gen,
                        device="cuda").bfloat16()
        kv = [torch.randn((2, 1, SMAX, hl, 128), generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
        need = 2 * int(valid.sum()) * hl * 128 * 2 + 4 * q.numel()
        ref = decode_attention_plain(q, kv[0], kv[1], 1, valid)
        note("K3", f"{tag} H{hl}", max_err(decode_attention_stacked(
            q, kv[0], kv[1], 1, valid), ref), tolerance(ref),
            lambda: tp_timed(
                f"K3 {tag}", lambda: decode_attention_stacked(
                    q, kv[0], kv[1], 1, valid),
                lambda: decode_attention_plain(q, kv[0], kv[1], 1, valid),
                bound(need, 4 * 128 * int(valid.sum()) * hl),
                lambda: library_attention_ms(q, kv[0][1], kv[1][1], valid,
                                             False, iters=10)))
        # each its own buffer, aligned as the cache's are
        (kq, vq), (ks, vs) = ([t.clone() for t in pair]
                              for pair in _quantize_kv(torch.stack(kv)))
        ref = decode_attention_plain(q, kq, vq, 1, valid, ks, vs)
        note("K3-int8", f"{tag} H{hl}", max_err(decode_attention_stacked(
            q, kq, vq, 1, valid, ks, vs), ref), tolerance(ref),
            lambda: tp_timed(
                f"K3-int8 {tag}", lambda: decode_attention_stacked(
                    q, kq, vq, 1, valid, ks, vs),
                lambda: decode_attention_plain(q, kq, vq, 1, valid, ks, vs),
                bound(need // 2 + 4 * int(valid.sum()) * hl,
                      4 * 128 * int(valid.sum()) * hl)))
        del kv, kq, vq
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print("tp shard check (7B and 13B over 2 and 4 ranks): max abs err "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + "; timed at " + "; ".join(
              f"{k} {where[k]} {fmt_times(t)}, bound {t['bound_ms']:.4f} ms"
              + ("" if t["library_ms"] is None else
                 f", library {t['library_ms']:.4f} ms")
              for k, t in times.items())
          + f"; launches {launches}; skipped: " + "; ".join(skipped)
          + "; K1 forward and K2 backward at the training shapes "
          + ", ".join(f"{k} {e:.3e}" for k, e in train_errs.items()))
    srcs = {"K1": K1_SRC, "K3": dict(K3_SRC, name="decode_attn"),
            "K3-int8": dict(K3_SRC, name="decode_attn_int8"),
            "K4": dict(K4_SRC, name="int8_matvec"),
            "K5": K5_SRC, "K6": K6_SRC,
            "K8": dict(K8_SRC, name="w4a8_group_gemm"),
            "K8q": dict(K8Q_SRC, name="quantize_tokens")}
    wrap = {"K3-int8": "K3"}
    return [{**srcs[k], "name": srcs[k]["name"] + "_tp_shards",
             "path": f"tp shard-shape check only ({where[k]} timed)",
             "launches": launches[wrap.get(k, k)],
             "max_abs_err": errs[k], **times[k]} for k in errs]


# The serving slice over two ranks on the one card: Valley-7B's width at
# TP_LAYERS of its 32 layers, fused, bf16 (K1, K3, K6) and int8a8 with an
# int8 cache (K1, K3-int8, K4), as rank processes of this script over gloo
# (NCCL refuses two ranks on one device; gloo's collectives go through the
# host, so the engine decodes eagerly, by its rule), against world 1 on the
# same weights in the path's own process
TP_LAYERS = 4
TP_RANKS = 2
TP_NEW = 16
TP_TEACHER = (319, 1576, 29871)
# The TP logits against world 1's, at the prefill and the teacher-forced
# decode steps: the row-parallel products' partial sums add in another
# order (bf16 partial sums in prefill, fp32 in decode; W8A8's int32 sums
# exactly, so int8a8's prefill is world 1's bit for bit).  Readings of
# this script on an H100 80GB HBM3 at 700 W: bf16 0.0410 / 0.0311 /
# 0.0253 / 0.0261 (largest logit 4.43), int8a8 0 / 0.0026 / 0.0270 /
# 0.0239 (largest 4.42); the bars are about twice them.
TP_LOGIT_TOL = 0.08
TP_INT8_LOGIT_TOL = 0.06
# The request's vision features (the pooled patches and the frames' CLS,
# after the projector's gather) against world 1's, of the largest: the cut
# tower's row-parallel partial sums (o, fc2) add in bf16 over the ranks;
# W8A8's int32 partials add exactly.  Readings of this script on an H100
# 80GB HBM3 at 700 W: bf16 1.290e-2, the W8A8 tower 0 (bit-equal); the
# bf16 bar is about twice its reading, the W8A8 one a margin over 0.
TP_FEATURE_TOL = {"bf16": 0.03, "int8a8": 1e-3}


def tp_config():
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    return cfg.replace(text=dataclasses.replace(
        cfg.text, num_hidden_layers=TP_LAYERS))


def tp_engine(cfg, mode: str, mesh):
    """The slice's engine in ``mode`` (bf16, or int8a8 with a W8A8 tower),
    its random weights from seed 3 fused (and quantized) on the card, cut
    by ``mesh`` (the decoder, the tower and the projector)."""
    from valley_tpu_torch.inference.engine import Engine
    from valley_tpu_torch.models import llama, valley
    from valley_tpu_torch.ops.quant import (quantize_llama_params,
                                            quantize_vision_params)

    params = llama.fuse_llama_params(valley.init_params(
        cfg, torch.Generator("cuda").manual_seed(3), torch.bfloat16,
        "cuda"))
    if mode == "int8a8":
        # and the tower W8A8, as the worker's --quantize-vision int8a8
        params = quantize_vision_params(quantize_llama_params(
            params, act8=True), act8=True)
    return Engine(cfg, params, buckets=(BUCKET,), max_new_tokens=TP_NEW,
                  cache_dtype=torch.int8 if mode == "int8a8"
                  else torch.bfloat16, mesh=mesh)


def tp_drive(engine, cfg) -> dict:
    """bench's request through ``engine``: the prefill's logits, the
    teacher-forced steps' logits on its cache, and TP_NEW greedy tokens
    decoded eagerly, with each wrapper's launches during them; then the
    request's vision features (`valley.encode_images`) and the shapes of
    this rank's tower and projector weights."""
    from valley_tpu_torch.inference.engine import GenerationConfig
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
    from valley_tpu_torch.ops.flash_attention import flash_attention
    from valley_tpu_torch.ops.matvec import bf16_matvec
    from valley_tpu_torch.ops.quant import int8_matvec

    prompt, frames = bench_request(cfg, BUCKET)
    gcfg = GenerationConfig(max_new_tokens=TP_NEW, do_sample=False)

    def run():
        pre = engine.prefill([prompt], frames, gcfg)
        steps = decode_logits(engine, pre.cache, pre.valid, pre.bucket,
                              len(prompt), TP_TEACHER)
        s0 = engine.steps_run
        toks = [int(t[0]) for t in engine.generate_tokens(
            [prompt], frames, gcfg, eos_ids=[-1], eager=True)]
        return [pre.logits[0]] + steps, toks, engine.steps_run - s0

    t0 = time.perf_counter()
    (logits, toks, decoded), counts = counted(
        {"K1": flash_attention, "K3": decode_attention_stacked,
         "K6": bf16_matvec, "K4": int8_matvec}, run)
    seconds = time.perf_counter() - t0
    with torch.inference_mode():
        feats = valley.encode_images(engine.params, cfg, torch.from_numpy(
            frames).to("cuda"))
    vision = engine.params["vision"]
    return {"logits": torch.stack(logits).float().cpu(), "tokens": toks,
            "features": (feats.pooled.float().cpu(),
                         feats.frame_cls.float().cpu()),
            "tower": {"heads": getattr(vision, "tp", None) and vision.tp.heads,
                      **{n: tuple(vision["layers"][n].shape)
                         for n in ("wq", "wo", "fc1", "fc2")},
                      "projector.w": tuple(
                          engine.params["projector"]["w"].shape)},
            "counts": counts, "seconds": seconds,
            # the decode steps run: the teacher-forced ones and the
            # request's (its last chunk padded to a scheduled size)
            "steps": len(TP_TEACHER) + decoded}


def tp_rank_kernels(engine, mode: str, gen) -> dict:
    """This rank's kernels against their plain versions on its own shares:
    K1 on its heads at the prefill shape, K3 over its cache's kv heads,
    the decode GEMV of each of its weights (K6 bf16, K4 int8) at one
    row.  Returns the largest errors."""
    from valley_tpu_torch.ops.decode_attention import (
        decode_attention_plain, decode_attention_stacked)
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from valley_tpu_torch.ops.matvec import matvec, matvec_plain

    errs = {}
    heads, d = engine.tp.heads, engine.cfg.text.head_dim
    name, q, k, v, mask, causal = flash_cases(gen, heads=heads)[0]
    ref = flash_attention_plain(q, k, v, mask, causal=causal)
    errs["K1"] = max_err(flash_attention(q, k, v, mask, causal=causal), ref)
    check(errs["K1"] <= tolerance(ref), f"tp {mode} K1 {name}: {errs}")
    cache = engine.init_cache(1, SMAX)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda")
                .to(t.dtype) if t.dtype != torch.int8 else torch.randint(
                    -127, 128, t.shape, generator=gen, device="cuda",
                    dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda") / 64)
    valid = torch.zeros((1, SMAX), dtype=torch.bool, device="cuda")
    valid[:, :PROMPT_LEN] = True
    valid[:, BUCKET:BUCKET + 8] = True
    q = torch.randn((1, 1, heads, d), generator=gen, device="cuda").bfloat16()
    args = (q, cache.k, cache.v, 1, valid, cache.k_scale, cache.v_scale)
    ref = decode_attention_plain(*args)
    k3 = "K3-int8" if mode == "int8a8" else "K3"
    errs[k3] = max_err(decode_attention_stacked(*args), ref)
    check(errs[k3] <= tolerance(ref), f"tp {mode} {k3}: {errs}")
    gemv = "K4" if mode == "int8a8" else "K6"
    errs[gemv] = 0.0
    lp, top = engine.params["llama"]["layers"], engine.params["llama"]
    weights = []
    for n in ("wqkv", "wo", "w_gateup", "w_down"):
        scale = lp.get(n + "_scale_a8")
        weights.append((lp[n][0], None if scale is None else scale[0],
                        False))
    weights.append((top["lm_head"], top.get("lm_head_scale"),
                    mode != "int8a8"))
    for w, scale, kf in weights:
        x = torch.randn((1, w.shape[0] if kf else w.shape[-1]),
                        generator=gen, device="cuda").bfloat16()
        s = None if scale is None else scale.reshape(-1)
        ref = matvec_plain(x, w, s, kf)
        err = max_err(matvec(x, w, s, kf), ref)
        check(err <= tolerance(ref), f"tp {mode} {gemv} "
              f"{tuple(w.shape)}: {err}")
        errs[gemv] = max(errs[gemv], err)
    return errs


def tp_rank_main(rank: int, out: Path) -> None:
    """One rank of `serve_tp_path`, in a process of its own: the slice in
    both modes over a (1, 1, 2) mesh on the one card, this rank's kernels
    against their plain versions; rank 0 then (once the path's process has
    its world-1 references) times the kernels at its shapes.  Each rank
    writes what it read to ``out/rank<r>.pt``."""
    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import create_mesh

    distributed.initialize(f"file://{out}/store", TP_RANKS, rank,
                           device="cuda:0", backend="gloo")
    mesh = create_mesh(1, 1, TP_RANKS, "cuda")
    cfg = tp_config()
    gen = torch.Generator("cuda").manual_seed(11 + rank)
    got = {}
    for mode in ("bf16", "int8a8"):
        engine = tp_engine(cfg, mode, mesh)
        check(not engine.use_graphs, "tp: graphs over gloo")
        got[mode] = tp_drive(engine, cfg)
        got[mode]["errs"] = tp_rank_kernels(engine, mode, gen)
        got[mode]["shapes"] = {n: tuple(p.shape) for n, p in engine.params[
            "llama"]["layers"].named_parameters()}
        got[mode]["heads"] = (engine.tp.heads, engine.kv_heads)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    distributed.barrier()
    distributed.shutdown()
    if rank == 0:
        # the path's process is idle once its references are written
        while not (out / "ref_done").exists():
            time.sleep(0.2)
        got["times"] = tp_times(gen)
    torch.save(got, out / f"rank{rank}.pt")


def tp_times(gen) -> dict:
    """K1, K3, K3-int8, K4 and K6 timed at this rank's shapes (7B over 2
    ranks: 16 heads, the fused weights' shares), by `kernel_times`, with
    their bounds and library calls."""
    from valley_tpu_torch.ops.decode_attention import (
        decode_attention_plain, decode_attention_stacked)
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd,
                                                      flash_attention_plain)
    from valley_tpu_torch.ops.matvec import bf16_matvec, bf16_matvec_plain
    from valley_tpu_torch.ops.quant import int8_matvec, int8_matvec_plain

    h, f, heads = TP_SHAPES[("7b", TP_RANKS)]
    hl = heads // TP_RANKS
    out = {}
    name, q, k, v, mask, causal = flash_cases(gen, heads=hl)[0]
    out["K1"] = tp_timed(
        f"tp K1 {name}", lambda: flash_attention(q, k, v, mask,
                                                 causal=causal),
        lambda: flash_attention_plain(q, k, v, mask, causal=causal),
        attention_bound(q, k, mask, causal, 2, 0),
        lambda: library_attention_ms(q, k, v, mask, causal, iters=10))
    valid = torch.zeros((1, SMAX), dtype=torch.bool, device="cuda")
    valid[:, :PROMPT_LEN] = True
    valid[:, BUCKET:BUCKET + 8] = True
    qd = torch.randn((1, 1, hl, 128), generator=gen,
                     device="cuda").bfloat16()
    kv = [torch.randn((TP_LAYERS, 1, SMAX, hl, 128), generator=gen,
                      device="cuda").bfloat16() for _ in range(2)]
    n_valid = int(valid.sum())
    need = 2 * n_valid * hl * 128 * 2 + 4 * qd.numel()
    it = iter(range(10 ** 9))
    out["K3"] = tp_timed(
        "tp K3", lambda: decode_attention_stacked(
            qd, kv[0], kv[1], next(it) % TP_LAYERS, valid),
        lambda: decode_attention_plain(qd, kv[0], kv[1],
                                       next(it) % TP_LAYERS, valid),
        bound(need, 4 * 128 * n_valid * hl),
        lambda: library_attention_ms(qd, kv[0][0], kv[1][0], valid, False,
                                     iters=10))
    from valley_tpu_torch.models.llama import _quantize_kv

    (kq, vq), (ks, vs) = ([t.clone() for t in pair]
                          for pair in _quantize_kv(torch.stack(kv)))
    out["K3-int8"] = tp_timed(
        "tp K3-int8", lambda: decode_attention_stacked(
            qd, kq, vq, next(it) % TP_LAYERS, valid, ks, vs),
        lambda: decode_attention_plain(qd, kq, vq, next(it) % TP_LAYERS,
                                       valid, ks, vs),
        bound(need // 2 + 4 * n_valid * hl, 4 * 128 * n_valid * hl))
    # the GEMVs: per call, averaged over one decode step's (layers x the
    # four fused weights, then lm_head)
    for kind in ("K6", "K4"):
        step = {}
        for wname, fo, k, kf in tp_weights(h, f, TP_RANKS):
            x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
            if kind == "K6":
                w = bf16_weight(gen, k, fo, kf)
                walk = tp_walk(w)
                t = tp_timed(
                    f"tp K6 {wname}", lambda: bf16_matvec(x, walk(), kf),
                    lambda: bf16_matvec_plain(x, walk(), kf),
                    bound(2 * w.numel() + 2 * k + 4 * fo, 2 * k * fo),
                    lambda: library_linear_ms(x, [walk() for _ in range(
                        -(-TP_WALK_BYTES // (2 * w.numel())))], kf, 10))
            else:
                w, s = int8_weight(gen, fo, k)
                walk = tp_walk(w)
                t = tp_timed(
                    f"tp K4 {wname}", lambda: int8_matvec(x, walk(), s),
                    lambda: int8_matvec_plain(x, walk(), s),
                    bound(fo * k + 2 * k + 4 * fo + 4 * fo, 2 * k * fo),
                    lambda: library_matvec_ms(x, [walk() for _ in range(
                        -(-TP_WALK_BYTES // w.numel()))], s, 10)[0])
            step[wname] = t
            del w, walk
        calls = 4 * TP_LAYERS + 1
        avg = {}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            vals = [step[n][key] * (1 if n == "lm_head" else TP_LAYERS)
                    for n in step]
            avg[key] = None if None in vals else sum(vals) / calls
        avg["bound_by"] = "bytes"
        out[kind] = avg
    return out


def native_video_phase(work: Path) -> None:
    """bench's 8 frames from an mp4 (64 frames of 320x240 from seed 9,
    mp4v) through the port's `load_video` as the serving path reads them
    (raw uint8, 224 px): the decoder that served (the native one, built
    here with g++ against libav, or OpenCV where it does not build or
    load), its seconds, and the frames' shape."""
    import cv2

    from valley_tpu_torch.data import video

    path = work / "native_video.mp4"
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 16,
                          (320, 240))
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:240, 0:320]
    for t in range(64):
        base = np.stack([(xx + 3 * t) % 256, (yy + 5 * t) % 256,
                         (xx + yy + 7 * t) % 256], axis=-1)
        out.write(np.clip(base + rng.integers(-6, 7, base.shape), 0, 255)
                  .astype(np.uint8))
    out.release()
    t0 = time.perf_counter()
    frames = video.load_video(str(path), fixed_frame_number=8,
                              raw_pixels=True)
    first = time.perf_counter() - t0
    decoder = video.last_decoder
    t0 = time.perf_counter()
    video.load_video(str(path), fixed_frame_number=8, raw_pixels=True)
    again = time.perf_counter() - t0
    print(f"native video: bench's 8 frames of a 64-frame 320x240 mp4 "
          f"through load_video: decoder {decoder}, {first:.3f} s the first "
          f"call (with the build), {again:.3f} s the second, frames "
          f"{tuple(frames.shape)} {frames.dtype}", flush=True)
    check(frames.shape == (3, 8, 224, 224) and frames.dtype == np.uint8,
          f"native video: frames {frames.shape} {frames.dtype}")


def serve_tp_path(smi: str, gen, work: Path) -> list:
    """Tensor parallelism in serving: two rank processes of this script on
    the one card over gloo, a (1, 1, 2) mesh, against world 1 in this
    process on the same weights, in bf16 (K1, K3, K6) and int8a8 with an
    int8 cache and a W8A8 tower (K1, K3-int8, K4), the decoder, the tower
    and the projector cut: the TP logits at the prefill and the
    teacher-forced steps within the bars, the request's vision features
    within `TP_FEATURE_TOL`, the greedy tokens equal to world 1's up to
    the first step whose world-1 top-2 margin is under BATCH_MARGIN_BAR,
    each rank's launches (each kernel launched, as one device's path
    launches it a layer) and each rank's kernels against their plain
    versions.  First, `native_video_phase`.  Returns rank 0's entries."""
    native_video_phase(work)
    out = work / "serve_tp"
    out.mkdir()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--tp-rank",
                               str(r), "--out", str(out)])
             for r in range(TP_RANKS)]
    cfg = tp_config()
    ref, engines = {}, {}
    try:
        for mode in ("bf16", "int8a8"):
            engines[mode] = tp_engine(cfg, mode, None)
            ref[mode] = tp_drive(engines[mode], cfg)
        (out / "ref_done").touch()
    finally:
        rcs = [p.wait(timeout=600) for p in procs]
    check(rcs == [0] * TP_RANKS, f"serve_tp: the ranks exited {rcs}")
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(TP_RANKS)]
    layers = TP_LAYERS
    entries = []
    prompt, frames = bench_request(cfg, BUCKET)
    for mode, tol, gemv in (("bf16", TP_LOGIT_TOL, "K6"),
                            ("int8a8", TP_INT8_LOGIT_TOL, "K4")):
        want = ref[mode]
        got = ranks[0][mode]
        k3 = "K3-int8" if mode == "int8a8" else "K3"
        steps = want["steps"]
        # two prefills (each one lm_head row by the GEMV), the decode steps
        expect = {"K1": 2 * layers, "K3": steps * layers,
                  gemv: steps * (4 * layers + 1) + 2}
        for r, rk in enumerate(ranks):
            check(rk[mode]["tokens"] == got["tokens"] and torch.equal(
                rk[mode]["logits"], got["logits"]),
                f"serve_tp {mode}: rank {r} parts from rank 0")
            for kname, n in expect.items():
                check(rk[mode]["counts"][kname] == n, f"serve_tp {mode}: "
                      f"rank {r} launched {kname} {rk[mode]['counts']}, "
                      f"want {n}")
        diffs = (got["logits"] - want["logits"]).abs().amax(dim=-1).tolist()
        feat = max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got["features"], want["features"]))
        tower = got["tower"]
        print(f"serve_tp {mode}: the cut tower{' (W8A8)' if mode == 'int8a8' else ''}"
              f" and projector's features against world 1: {feat:.3e} of "
              f"the largest (bar {TP_FEATURE_TOL[mode]}); rank 0 holds "
              f"{tower}", flush=True)
        check(feat <= TP_FEATURE_TOL[mode], f"serve_tp {mode}: the features "
              f"differ from world 1's by {feat} of the largest")
        check(tower["heads"] == cfg.vision.num_attention_heads // TP_RANKS
              and tower["projector.w"][1] == cfg.text.hidden_size // TP_RANKS,
              f"serve_tp {mode}: rank 0's tower share {tower}")
        check(max(diffs) <= tol, f"serve_tp {mode}: TP logits differ from "
              f"world 1 by {diffs} (bar {tol})")
        tokens = first_divergence(f"serve_tp {mode}", engines[mode], prompt,
                                  frames, want["tokens"], got["tokens"],
                                  BATCH_MARGIN_BAR)
        heads, kv_heads = got["heads"]
        print(f"serve_tp {mode}: Valley-7B width at {layers} layers, fused"
              f"{', int8 cache' if mode == 'int8a8' else ''}, (1, 1, 2) over "
              f"gloo on one card against world 1: logits max abs diff at the "
              f"prefill and {len(TP_TEACHER)} teacher-forced steps "
              f"{[round(x, 4) for x in diffs]} (bar {tol}; largest logit "
              f"{want['logits'].abs().max().item():.3f}); greedy: {tokens}; "
              f"each rank {heads} heads, {kv_heads} cached kv heads, wqkv "
              f"{got['shapes']['wqkv']}, w_down {got['shapes']['w_down']}; "
              f"launches rank 0 {got['counts']}, rank 1 "
              f"{ranks[1][mode]['counts']} (want {expect}); kernels vs plain "
              f"on each rank's shares: rank 0 {got['errs']}, rank 1 "
              f"{ranks[1][mode]['errs']}; the TP request {got['seconds']:.2f}"
              f" s eager (gloo, host-staged) vs {want['seconds']:.2f} s at "
              f"world 1 eager; on {smi}")
        times = ranks[0]["times"]
        err = {k: max(rk[mode]["errs"][k] for rk in ranks)
               for k in got["errs"]}
        srcs = {"K1": K1_SRC, k3: dict(K3_SRC, name="decode_attn"
                                       + ("_int8" if k3 != "K3" else "")),
                "K6": K6_SRC, "K4": dict(K4_SRC, name="int8_matvec")}
        for kname in ("K1", k3, gemv):
            entries.append({
                **srcs[kname], "name": srcs[kname]["name"] + f"_tp_{mode}",
                "path": f"serve_tp {mode}, rank 0 of 2",
                "launches": got["counts"]["K3" if kname == k3 else kname],
                "max_abs_err": err[kname], **times[kname]})
    print(f"serve_tp: {time.perf_counter() - t0:.1f} s in all")
    return entries


def _timed(fn):
    """``fn``, printing its seconds when it returns (the script's time
    budget is kept phase by phase)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return run


for _name in ("k8q_phase", "k1_phase", "k2_phase", "k3_phase", "k3_int8_phase",
              "k4_phase", "k5_phase", "k6_phase", "k6_checks", "k7_phase",
              "random_weights", "serve_slice", "spec_slice",
              "full_acceptance", "spec_conv", "conv_slice", "lab_phase",
              "batch_slice", "spec_pool_slice", "train_phase",
              "write_checkpoint", "load_checkpoint", "stage2_lora_phase",
              "stage2_entry_phase", "stage2_merge_phase",
              "stage2_full_phase", "stage2_offload_phase",
              "stage2_zero3_phase", "gloo_fsdp_phase",
              "profile_steps_phase", "flash_stage2_phase", "k8_phase",
              "pooling_phase", "vision_quant_phase", "variant_slice",
              "web_ui_phase", "tp_shard_phase", "tp_drive", "tp_times",
              "native_video_phase"):
    globals()[_name] = _timed(globals()[_name])


# Each path runs in a process of its own, one after the other: each frees
# its model by exiting, and each gets a fresh profiler (on an H100 with
# torch 2.11, traces taken in one process after both serving paths came
# back short of events, then empty; so did the lab's, run after the
# conversation in the int4 path's process).  Each is given the run's
# scratch directory.
PATHS = {"serve": serve_path, "serve_batch": serve_batch_path,
         "serve_int8": serve_int8_path, "serve_worker": serve_worker_path,
         "serve_int4": serve_int4_path,
         "lab_conv": lab_conv_path, "lab_tools": lab_tools_path,
         "train": train_path, "serve_variants": serve_variants_path,
         "serve_tp": serve_tp_path}
# Where the int4 path leaves the conversation's cache for the lab's process,
# in the run's scratch directory
CONV_CACHE = "conv_cache.pt"
# The port's modules a path process imports while the path before it runs
# (it touches the card only once its turn has come)
PRELOAD = ("valley_tpu_torch.models.valley",
           "valley_tpu_torch.inference.engine",
           "valley_tpu_torch.inference.continuous",
           "valley_tpu_torch.inference.speculative",
           "valley_tpu_torch.serve.model_worker",
           "valley_tpu_torch.train.train", "valley_tpu_torch.train.trainer",
           "valley_tpu_torch.parallel.sharding")


def wait_turn(go: Path, parent: int) -> None:
    """Import `PRELOAD`, then wait until ``go`` exists; exit if the script
    that started this process is gone."""
    import importlib

    for name in PRELOAD:
        importlib.import_module(name)
    while not go.exists():
        if os.getppid() != parent:
            sys.exit(3)
        time.sleep(0.05)


def start_path(name: str, tmp: str) -> subprocess.Popen:
    """``name``'s process, importing while it waits for ``<name>.go``."""
    return subprocess.Popen([sys.executable, __file__, "--path", name,
                             "--out", f"{tmp}/{name}.json", "--go",
                             f"{tmp}/{name}.go", "--parent",
                             str(os.getpid())])


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
    parser.add_argument("--gloo-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--go", help=argparse.SUPPRESS)
    parser.add_argument("--parent", type=int, help=argparse.SUPPRESS)
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

    if args.gloo_rank is not None:
        gloo_rank_main(args.gloo_rank, Path(args.out))
        return 0
    if args.tp_rank is not None:
        tp_rank_main(args.tp_rank, Path(args.out))
        check("jax" not in sys.modules, "the port imported jax")
        return 0
    if args.path:
        if args.go:
            wait_turn(Path(args.go), args.parent)
        entries = PATHS[args.path](nvidia_smi(),
                                   torch.Generator("cuda").manual_seed(0),
                                   Path(args.out).parent)
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
    # each path's process starts (and imports) while the one before runs;
    # its wall counts from its turn
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        names = list(PATHS)
        ahead = start_path(names[0], tmp)
        try:
            for i, name in enumerate(names):
                proc = ahead
                t0 = time.perf_counter()
                Path(f"{tmp}/{name}.go").touch()
                ahead = start_path(names[i + 1], tmp) \
                    if i + 1 < len(names) else None
                rc = proc.wait()
                if rc:
                    raise subprocess.CalledProcessError(rc, proc.args)
                print(f"path {name}: {time.perf_counter() - t0:.1f} s wall",
                      flush=True)
                with open(f"{tmp}/{name}.json") as f:
                    kernels += json.load(f)
        finally:
            if ahead is not None and ahead.poll() is None:
                ahead.kill()
                ahead.wait()
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_cuda.py",
                    "-m", "cuda", "--noconftest", "-q", "-p",
                    "no:cacheprovider"], check=True,
                   cwd=Path(__file__).resolve().parent)
    print(f"card tests: {time.perf_counter() - t0:.1f} s wall", flush=True)
    # the decode GEMVs against the read rate K7 measured (the faster of
    # K7 and torch.sum on 2.15 GB): ``ceiling_bound_ms`` is the bound at
    # that rate, beside ``bound_ms`` at the datasheet's 3.35 TB/s
    probe = next(e for e in kernels if e["name"] == "read_sum")
    ceiling = max(probe["read_gb_per_s"], probe["library_read_gb_per_s"])
    for e in kernels:
        if e["name"] in GEMV_NAMES or "lab" in e["path"]:
            e["ceiling_bound_ms"] = e["bound_ms"] * HBM_BYTES_PER_S / (
                ceiling * 1e9)
            print(f"{e['name']} ({e['path']}): device {e['ms']:.4f} ms per "
                  f"call, {e['bound_ms'] / e['ms']:.3f} of the bound at 3.35 "
                  f"TB/s, {e['ceiling_bound_ms'] / e['ms']:.3f} of the bound "
                  f"at the measured {ceiling:.1f} GB/s")
    # the 13B first token of int4gp (dequantized prefill products) and of
    # int4gpa8 (W4A8 prefill through K8) in this run
    walls = {e["path"]: e for e in kernels if "request_first_token_ms" in e}
    if {"serve_int4", "serve_variants"} <= set(walls):
        a, b = walls["serve_int4"], walls["serve_variants"]
        print(f"Valley-13B first token: int4gp {a['request_first_token_ms']:.2f}"
              f" ms (serve_int4), int4gpa8 with an int8a8 tower and transformer "
              f"pooling {b['request_first_token_ms']:.2f} ms (serve_variants); "
              f"decode {a['request_decode_ms_per_token']:.3f} and "
              f"{b['request_decode_ms_per_token']:.3f} ms/token")
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
