"""K1 and K2 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) on the card:
what ptxas reports of their builds, and their device times at the shapes
of the port's paths beside their bound, and beside other builds of them.

    python -m valley_tpu_torch.tools.flash_check [--out FILE]
        [--against NAME=DIR[,old] ...]

Each ``--against`` directory holds another flash_fwd.cu and flash_bwd.cu
(with the headers they include: an earlier design, or a copy of the
shipped sources with a change), built beside the shipped ones and timed in
turns with them at every shape (other, shipped, shipped, other); ``old``
marks the C interface before the planted faults' argument (the sources
of the earlier mma.sync design).  The times are device time from the profiler, whose trace must
hold as many of the kernel's events as its wrapper launched (CUDA events
around the loop after three traces that do not), one line a shape, and
with ``--out`` a JSON file of them.  A first launch that has not finished
in `HANG_S` seconds stops the process (exit 3) rather than hold the card.
The kernels' checks against their plain versions, at the edges of their
tiles and with planted faults, are the card tests
(``tests/test_torch_cuda.py -m cuda -k flash``); the library's attention,
their yardstick, is timed by ``chip_smoke.py`` at the same shapes.  It
needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_bwd)

HANG_S = 30.0
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# (name, batch, sequence, heads, valid keys a row or None for 300-512
# drawn, with K2): the shapes the port's paths give K1 and K2 (chip_smoke.py
# and tools/tp_train_check.py), head dim 128, causal
SHAPES = (
    ("serve 7B B1 S512 H32, 473 valid", 1, 512, 32, 473, False),
    ("batch 7B B4 S512 H32, 473 valid", 4, 512, 32, 473, False),
    ("serve 13B B1 S512 H40, 473 valid", 1, 512, 40, 473, False),
    ("worker 7B B1 S512 H32, 340 valid", 1, 512, 32, 340, False),
    ("serve 7B over 2 ranks B1 S512 H16, 473 valid", 1, 512, 16, 473, False),
    ("stage 1 B16 S512 H32", 16, 512, 32, None, True),
    ("stage 2 B1 S2048 H32, 2008 valid", 1, 2048, 32, 2008, True),
    ("stage 1 7B over 2 ranks B16 S512 H16", 16, 512, 16, None, True),
    ("stage 2 7B over 2 ranks B1 S2048 H16, 1990 valid", 1, 2048, 16, 1990,
     True),
    ("stage 2 13B over 4 ranks B1 S2048 H10, 1990 valid", 1, 2048, 10, 1990,
     True),
    ("stage 2 13B over 2 ranks B1 S2048 H20, 1990 valid", 1, 2048, 20, 1990,
     True),
    ("stage 2 13B B1 S2048 H40, 1990 valid", 1, 2048, 40, 1990, True),
)


def ptxas_report() -> str:
    """Each source built once more with -Xptxas -v, started together with
    the wrappers' own builds; the lines that name registers, spills and
    shared memory."""
    work = Path(tempfile.mkdtemp(prefix="flash_check_"))
    shipped = {name: _build._start(name) for name in ("flash_fwd",
                                                      "flash_bwd")}
    procs = {}
    for name in ("flash_fwd", "flash_bwd"):
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-I{_build.CSRC}", "-o", str(work / f"lib{name}.so"),
             str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        keep = [ln.strip() for ln in log.splitlines()
                if re.search(r"registers|spill|Compiling entry|smem", ln)]
        lines.append(f"{name}.cu:\n  " + "\n  ".join(keep))
    for name, started in shipped.items():
        _build._finish(name, started)
    return "\n".join(lines)


def finished(what: str):
    """Wait for the work queued so far, giving it `HANG_S` seconds."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > HANG_S:
            print(f"HANG: {what} did not finish in {HANG_S} s", flush=True)
            os._exit(3)
        time.sleep(0.01)


def inputs(gen, b, s, h, d, lengths):
    """q, k, v, dout (B, S, H, D) bf16 N(0, 1) and the (B, S) mask: row i
    attends its first lengths[i] keys."""
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    mask = torch.arange(s, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda")[:, None]
    return q, k, v, g, mask


# profiler traces taken, empty (no device time), and short (fewer of the
# timed kernel's events than its wrapper's launches in the traced calls)
TRACES = {"taken": 0, "empty": 0, "short": 0}


def device_ms(fn, iters: int, expect=None) -> float:
    """Device ms a call: the profiler's kernel time over ``iters`` calls
    (each profile keeping its events across cycles, ``acc_events``), or
    CUDA events around them when three traces come back empty or short.
    With ``expect`` ((profiler name, wrapper)) a trace must hold as many of
    the kernel's events as the wrapper counted launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        before = expect[1].launches if expect else 0
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        TRACES["taken"] += 1
        events = prof.key_averages()
        if expect is not None:
            n = sum(e.count for e in events if expect[0] in e.key
                    and str(e.device_type).endswith("CUDA"))
            launched = expect[1].launches - before
            if n < launched:
                TRACES["short"] += 1
                print(f"  trace {attempt + 1}: {n} {expect[0]} events of "
                      f"{launched} launches", flush=True)
                time.sleep(0.5)
                continue
        # each kernel's mean over its events times its events a call: a
        # trace that lost an event still reads the calls' time
        total = sum(e.self_device_time_total / e.count
                    * max(1, round(e.count / iters))
                    for e in events
                    if str(e.device_type).endswith("CUDA") and e.count)
        if total > 0:
            return total / 1e3
        TRACES["empty"] += 1
        print(f"  trace {attempt + 1}: no device time", flush=True)
        time.sleep(0.5)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    print("  CUDA events instead of the profiler", flush=True)
    return start.elapsed_time(end) / iters


def bound_ms(q, mask, products: int, extra_bytes: int) -> float:
    """chip_smoke.attention_bound: the attended (query, key) pairs' 2 D
    operations in each product, or q/k/v/o (and ``extra_bytes``) once."""
    b, s, h, d = q.shape
    pairs = int(mask.to(torch.int64).cumsum(dim=1).sum()) * h
    n_bytes = 4 * q.numel() * 2 + mask.numel() + extra_bytes
    return max(n_bytes / HBM_BYTES_PER_S,
               products * 2 * d * pairs / BF16_FLOP_PER_S) * 1e3


class Build:
    """K1's and K2's C entry points of one build, called as the wrappers
    call them (K2 after its delta kernel)."""

    def __init__(self, fwd_lib, bwd_lib, old: bool = False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        extra = [] if old else [i]
        self.fwd, self.bwd = fwd_lib.flash_fwd_bf16, bwd_lib.flash_bwd_bf16
        self.delta = bwd_lib.flash_bwd_delta_bf16
        self.fwd.argtypes = ([vp] * 4 + [ctypes.c_longlong, vp, vp]
                             + [i] * 6 + [f] + extra + [vp])
        self.bwd.argtypes = ([vp] * 7 + [ctypes.c_longlong] + [vp] * 3
                             + [i] * 6 + [f] + extra + [vp])
        self.delta.argtypes = [vp, vp, vp, i, i, i, i, vp]
        self.extra = [] if old else [0]

    def k1(self, q, k, v, mask):
        b, s, h, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
        _build.check(self.fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            mask.stride(0), out.data_ptr(), lse.data_ptr(), b, h, s, s, d,
            1, d ** -0.5, *self.extra,
            torch.cuda.current_stream().cuda_stream), "flash_fwd_bf16")
        return out, lse

    def k2(self, q, k, v, mask, out, lse, g):
        b, s, h, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        delta = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
        _build.check(self.delta(out.data_ptr(), g.data_ptr(),
                                delta.data_ptr(), b, h, s, d, stream),
                     "flash_bwd_delta_bf16")
        grads = [torch.empty_like(q) for _ in range(3)]
        _build.check(self.bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), mask.data_ptr(),
            mask.stride(0), *(x.data_ptr() for x in grads), b, h, s, s, d,
            1, d ** -0.5, *self.extra, stream), "flash_bwd_bf16")
        return grads


def build_against(specs) -> dict:
    """{name: Build} of each ``--against`` directory, all nvcc runs
    started together."""
    work = Path(tempfile.mkdtemp(prefix="flash_check_against_"))
    jobs = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        src, _, flag = rest.partition(",")
        for kernel in ("flash_fwd", "flash_bwd"):
            so = work / f"lib{name}_{kernel}.so"
            jobs[(name, kernel)] = (so, flag == "old", subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{src}", "-o",
                 str(so), str(Path(src) / f"{kernel}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, old = {}, {}
    for (name, kernel), (so, is_old, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name} {kernel}.cu:\n{log}")
        libs.setdefault(name, {})[kernel] = ctypes.CDLL(str(so))
        old[name] = is_old
    return {name: Build(pair["flash_fwd"], pair["flash_bwd"], old[name])
            for name, pair in libs.items()}


def times(gen, iters: int, others: dict) -> list:
    shipped = Build(_build.load("flash_fwd"), _build.load("flash_bwd"))
    rows = []
    for name, b, s, h, valid, train in SHAPES:
        if valid is None:
            lengths = torch.randint(300, s + 1, (b,), generator=gen,
                                    device="cuda").tolist()
        else:
            lengths = [valid] * b
        q, k, v, g, mask = inputs(gen, b, s, h, 128, lengths)
        out, lse = flash_attention(q, k, v, mask, causal=True,
                                   return_lse=True)
        finished(f"K1 {name}")
        row = {"shape": name,
               "k1_ms": device_ms(lambda: flash_attention(
                   q, k, v, mask, causal=True), iters,
                   ("flash_fwd_kernel", flash_attention)),
               "k1_bound_ms": bound_ms(q, mask, 2, lse.numel() * 4)}
        line = (f"{name}: K1 {row['k1_ms']:.4f} ms, bound "
                f"{row['k1_bound_ms']:.4f} "
                f"({100 * row['k1_bound_ms'] / row['k1_ms']:.1f} %)")
        if train:
            flash_attention_bwd(q, k, v, mask, out, lse, g, causal=True)
            finished(f"K2 {name}")
            row.update(
                k2_ms=device_ms(lambda: flash_attention_bwd(
                    q, k, v, mask, out, lse, g, causal=True), iters,
                    ("flash_bwd_kernel", flash_attention_bwd)),
                k2_bound_ms=bound_ms(q, mask, 5, 4 * q.numel() * 2
                                     + lse.numel() * 4))
            line += (f"; K2 {row['k2_ms']:.4f} ms, bound "
                     f"{row['k2_bound_ms']:.4f} "
                     f"({100 * row['k2_bound_ms'] / row['k2_ms']:.1f} %)")
        print(line, flush=True)
        for other, build in others.items():
            # in turns: other, shipped, shipped, other
            turns = {}
            for who in (other, "shipped", "shipped", other):
                bld = shipped if who == "shipped" else build
                got = [device_ms(lambda: bld.k1(q, k, v, mask), iters)]
                if train:
                    got.append(device_ms(lambda: bld.k2(
                        q, k, v, mask, out, lse, g), iters))
                turns.setdefault(who, []).append(got)
            row[f"turns_{other}"] = turns
            print(f"  in turns, K1{'/K2' if train else ''} ms: {other} "
                  + ", ".join("/".join(f"{x:.4f}" for x in t)
                              for t in turns[other])
                  + "; shipped " + ", ".join(
                      "/".join(f"{x:.4f}" for x in t)
                      for t in turns["shipped"]), flush=True)
        rows.append(row)
        del q, k, v, g, mask, out, lse
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--out")
    parser.add_argument("--against", action="append", default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_check needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{name}; {smi.strip()}; torch {torch.__version__}", flush=True)
    others = build_against(args.against)
    print(ptxas_report(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = times(gen, args.iters, others)
    print(f"profiler traces: {TRACES['taken']} taken, {TRACES['empty']} "
          f"empty, {TRACES['short']} short of the timed kernel's launches",
          flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"device": name, "nvidia_smi": smi.strip(), "times": rows,
             "traces": TRACES}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
