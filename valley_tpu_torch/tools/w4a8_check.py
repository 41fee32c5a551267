"""K8 (the grouped W4A8 product, ``csrc/w4a8_group_gemm.cu``) on the card:
what ptxas reports of the build, the wrappers' host time a call, and K8's
device time at Valley-13B's four fused int4gpa8 projections, beside other
builds of K8 timed in turns with it.

    python -m valley_tpu_torch.tools.w4a8_check [--against NAME=OTHER.cu ...]

Each ``--against`` source has the shipped C interface (``w4a8_group_gemm(xq,
a, w, scale, y, T, K, F, gs, out_bf16, stream)``): an earlier design, or a
copy of the shipped source with a part of the work left out to show its
cost.  All builds start together.  At 512 and 128 rows each projection is
timed by the profiler in turns (other, shipped, shipped, other for each
other build); whether each build is bit-equal to the plain version is
printed, and only the shipped one must be.  Bit-equality at every shape,
group and edge is held by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
A first launch that has not finished in `HANG_S` seconds stops the process
(exit 3) rather than hold the card.  It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from valley_tpu_torch.ops import _build, quant, w4a8

HANG_S = 30.0
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
# Valley-13B's fused int4gpa8 projections, (name, K, F), and the rows of
# bench's bucket and the a8 gate
SHAPES_13B = (("wqkv", 5120, 15360), ("wo", 5120, 5120),
              ("w_gateup", 5120, 27648), ("w_down", 13824, 5120))
ROWS = (512, 128)


def build(sources: dict, work: Path, flags=()) -> dict:
    """Each source built into ``work``, all nvcc runs started together:
    {name: (library, what nvcc said)}."""
    jobs = {}
    for name, src in sources.items():
        out = work / f"lib{name}.so"
        jobs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
             f"-I{_build.CSRC}", "-o", str(out), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    ref = w4a8._lib().w4a8_group_gemm     # the shipped build, meanwhile
    built = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.w4a8_group_gemm.argtypes = ref.argtypes
        lib.w4a8_group_gemm.restype = ref.restype
        built[name] = (lib, log)
    return built


def ptxas_report(log: str) -> str:
    """What ptxas said of each kernel: registers, spills, warnings."""
    return "\n".join(ln.strip() for ln in log.splitlines() if re.search(
        r"entry function|registers|spill|warning|wgmma", ln))


def launcher(lib):
    """K8 of ``lib`` as a function of (xq, a, w, scale): bf16 out."""
    def run(xq, a, w, scale):
        t, k = xq.shape
        f = w.shape[0]
        y = torch.empty((t, f), dtype=torch.bfloat16, device="cuda")
        _build.check(lib.w4a8_group_gemm(
            xq.data_ptr(), a.data_ptr(), w.data_ptr(), scale.data_ptr(),
            y.data_ptr(), t, k, f, k // scale.shape[1], 1,
            torch.cuda.current_stream().cuda_stream), "w4a8_group_gemm")
        return y
    return run


def watched(fn, what: str):
    """``fn()``, its launches given `HANG_S` seconds to finish."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > HANG_S:
            print(f"HANG: {what} did not finish in {HANG_S} s", flush=True)
            os._exit(3)
        time.sleep(0.01)
    return out


def k8_inputs(gen, t: int, k: int, f: int) -> tuple:
    """Activations quantized as the decoder quantizes them, and a random
    weight quantized int4 with groups of 128 and packed, as int4gpa8's."""
    xq, a = w4a8.quantize_tokens_plain(
        torch.randn((t, k), generator=gen, device="cuda"))
    wt = (torch.randn((f, k), generator=gen, device="cuda")
          * k ** -0.5).bfloat16()
    q, s = quant.quantize_tensor(wt, bits=4, group_size=128)
    return xq, a.reshape(-1), quant.pack_int4(q), s


def device_ms(fn, iters: int = 10) -> float:
    """Device ms a call of K8 by the profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if "w4a8_group_gemm" in e.key and e.count]
        if ev:
            return sum(e.self_device_time_total for e in ev) / 1e3 / iters
    raise RuntimeError("no device events of w4a8_group_gemm")


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds a call of ``fn``, the device synced every 20
    calls so that the queue never fills."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        if i % 20 == 19:
            torch.cuda.synchronize()
    return total / iters * 1e6


def timings(gen, runs: dict) -> bool:
    """Every build of ``runs`` ({name: K8 launcher}, "shipped" first) at
    the 13B shapes, the others in turns with the shipped one; returns
    whether the shipped one was bit-equal everywhere."""
    ok = True
    others = [n for n in runs if n != "shipped"]
    order = ["shipped"] if not others else \
        [n for o in others for n in (o, "shipped", "shipped", o)]
    for rows in ROWS:
        layer = {}
        for name, k, f in SHAPES_13B:
            xq, a, w, s = k8_inputs(gen, rows, k, f)
            ref = w4a8.w4a8_group_plain(xq, a, w, s, torch.bfloat16)
            equal = {}
            for run in runs:
                got = watched(lambda: runs[run](xq, a, w, s), run)
                equal[run] = torch.equal(got, ref)
            ok &= equal["shipped"]
            ops, n_bytes = 2 * rows * f * k, xq.numel() + 4 * rows + \
                w.numel() + 2 * s.numel() + 2 * rows * f
            bound = max(ops / INT8_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
            times = {}
            for run in order:
                times.setdefault(run, []).append(
                    device_ms(lambda: runs[run](xq, a, w, s)))
            parts = []
            for run, ms in times.items():
                mean = sum(ms) / len(ms)
                layer[run] = layer.get(run, 0.0) + mean
                parts.append(f"{run} " + "/".join(f"{m:.4f}" for m in ms)
                             + f" ms ({100 * bound / mean:.1f}% of the bound"
                             + ("" if equal[run] else "; NOT bit-equal")
                             + ")")
            print(f"K8 13b_{name} T{rows}: bound {bound:.4f} ms; "
                  + ", ".join(parts), flush=True)
        print(f"K8 a 13B layer at T{rows}: " + ", ".join(
            f"{run} {ms:.4f} ms" for run, ms in layer.items()), flush=True)
    return ok


def host_times(gen, libs: dict) -> None:
    """Host time a call at 13B's wo, T 512: K8's wrapper, the C call
    alone (which encodes two tensor maps) of every build in ``libs``
    ({name: library}), K8q's wrapper and the plain quantization it
    replaces."""
    xq, a, w, s = k8_inputs(gen, 512, 5120, 5120)
    y = torch.empty((512, 5120), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (xq.data_ptr(), a.data_ptr(), w.data_ptr(), s.data_ptr(),
            y.data_ptr(), 512, 5120, 5120, 128, 1, stream)
    c_calls = ", ".join(
        f"{name} {host_us(lambda: lib.w4a8_group_gemm(*args)):.1f} us"
        for name, lib in libs.items())
    wrapper = host_us(lambda: w4a8.w4a8_group_gemm(xq, a, w, s,
                                                   torch.bfloat16))
    x = torch.randn((512, 5120), generator=gen, device="cuda").bfloat16()
    print(f"host time a call (13b_wo T512): K8's wrapper {wrapper:.1f} us; "
          f"the C call alone: {c_calls}; K8q's wrapper "
          f"{host_us(lambda: w4a8.quantize_tokens(x)):.1f} us, the plain "
          f"quantization {host_us(lambda: w4a8.quantize_tokens_plain(x)):.1f}"
          f" us", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", action="append", default=[],
                        metavar="NAME=OTHER.cu",
                        help="another K8 source to time in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("w4a8_check: needs a CUDA card", file=sys.stderr)
        return 1
    others = dict(item.split("=", 1) for item in args.against)
    print(f"device: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        built = build({"shipped": _build.CSRC / "w4a8_group_gemm.cu",
                       **others}, Path(tmp), ("-Xptxas", "-v"))
        for name, (_, log) in built.items():
            print(f"ptxas, {name}:\n{ptxas_report(log)}", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        runs = {"shipped": lambda *t: w4a8.w4a8_group_gemm(
            *t, torch.bfloat16)}
        runs.update({name: launcher(built[name][0]) for name in others})
        ok = timings(gen, runs)
        host_times(gen, {"shipped": w4a8._lib(),
                         **{name: built[name][0] for name in others}})
    print("w4a8_check: " + ("shipped K8 bit-equal" if ok else "MISMATCH"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
