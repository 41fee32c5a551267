"""Device times of the quantized decode GEMVs, K4 (``csrc/int8_matvec.cu``)
and K5 (``csrc/int4_matvec.cu``), built with each of their compile-time
variants, at the fused weights of the paths that run them, and each
build's registers and spills as ptxas reports them.

    python -m valley_tpu_torch.tools.gemv_variants

The variants are text substitutions of the shipped sources (`VARIANTS`):
the units a step of a warp loads at once (``AHEAD``, 1 shipped), the warps
of a block (``MW``, 8 shipped), the units a warp takes (steps interleaved
with the other warps', shipped, or one contiguous range), K5's m-tiles a
warp at 9-16 rows (2 shipped), and a diagnostic that reads x from L1 only
(wrong by design, so not held to the plain version).  Each is built with
``-Xptxas -v`` (one nvcc a source and variant, all started together),
bound through the port's own wrappers, held against the plain version at
every shape (each row of a 9- or 16-row call bit-equal to the same row
alone) and timed by the profiler walking copies of the weight past the
50 MB L2, at 1, 9 and 16 rows: K4 on Valley-7B's fused int8 weights, K5 on
Valley-13B's fused int4gp weights (group 128, the per-channel lm_head).
Each line gives the device ms a call over one decode token's (or verify
round's) GEMVs, the bytes bound at 3.35 TB/s and the share of it reached.
It needs a CUDA card and nvcc, and stops without them.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops import quant
from valley_tpu_torch.tools.decode_attn_lab import REL_TOL

_STEPS = """  const int step = MW * AHEAD, uend = nunit;
  int u0 = warp * AHEAD;"""
# Each variant: text substitutions in each shipped source (each anchor must
# be found in one of them, or the build raises); the shipped build first.
# Diagnostics (diag_) are wrong by design and not held to the plain version.
VARIANTS = {
    "shipped": {},
    # two units a step (a row's 128 contiguous bytes a warp at once)
    "ahead2": {"constexpr int AHEAD = 1;": "constexpr int AHEAD = 2;"},
    # a warp's units one contiguous range of the row, not interleaved with
    # the other warps' steps
    "contiguous": {_STEPS: """  const int step = AHEAD, uend = (warp + 1) * nunit / MW;
  int u0 = warp * nunit / MW;"""},
    "mw4": {"constexpr int MW = 8;": "constexpr int MW = 4;"},
    # K5 at 9-16 rows with one m-tile a warp
    "mt1": {"launch<2, 2>(x, w, scale, y, B, K, F, G, st)":
            "launch<2, 1>(x, w, scale, y, B, K, F, G, st)"},
    # every x load reads the row's first vectors (x always in L1)
    "diag_x_in_l1": {"xb[n] = __ldg(xr[n] + xv + j);":
                     "xb[n] = __ldg(xr[n] + j);",
                     "xb[n][q] = __ldg(xr[n] + xv + q);":
                     "xb[n][q] = __ldg(xr[n] + q);"},
}
SOURCES = ("int8_matvec", "int4_matvec")
# (name, K, F): the decode GEMVs of one layer, then lm_head; K5's group
# size 128 for the layers, per channel for lm_head
K4_SHAPES = (("wqkv", 4096, 12288), ("wo", 4096, 4096),
             ("w_gateup", 4096, 22016), ("w_down", 11008, 4096),
             ("lm_head", 4096, 32000))
K5_SHAPES = (("wqkv", 5120, 15360), ("wo", 5120, 5120),
             ("w_gateup", 5120, 27648), ("w_down", 13824, 5120),
             ("lm_head", 5120, 32000))
LAYERS = {"int8_matvec": 32, "int4_matvec": 40}
ROWS = (1, 9, 16)
# bytes of weight copies a timing walks, 20 times the L2
WALK_BYTES = 1_000_000_000
HBM_BYTES_PER_S = 3.35e12


def build(work: Path) -> dict:
    """Every source and variant built together into ``work``: {(source,
    variant): (library path, ptxas registers and spills a kernel)}."""
    jobs = {}
    for source in SOURCES:
        shipped = (_build.CSRC / f"{source}.cu").read_text()
        for name, subs in VARIANTS.items():
            text = shipped
            for old, new in subs.items():
                text = text.replace(old, new)
            src = work / f"{source}_{name}.cu"
            src.write_text(text)
            out = work / f"lib{source}_{name}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                   f"-I{_build.CSRC}", "-o", str(out), str(src)]
            jobs[source, name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for name, subs in VARIANTS.items():
        for old in subs:
            if not any(old in (_build.CSRC / f"{source}.cu").read_text()
                       for source in SOURCES):
                raise RuntimeError(f"{name}: {old!r} is no longer in the "
                                   "sources")
    built = {}
    for key, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        built[key] = (out, registers(log))
    return built


def registers(log: str) -> dict:
    """{"<template arguments>": "R registers, S bytes spilled"} of each
    kernel in a ptxas -v log."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            args = re.findall(r"Li(\d+)E", entry.split("mma_kernel")[-1])
            regs["<" + ", ".join(args) + ">"] = \
                f"{m.group(1)} registers, {spill} bytes spilled"
            entry = None
    return regs


@contextlib.contextmanager
def library(source: str, path: Path):
    """The wrapper of ``source`` launches the kernels of ``path`` inside the
    block."""
    attr = "_lib" if source == "int8_matvec" else "_lib4"
    shipped = getattr(quant, attr)
    ref = shipped()
    lib = ctypes.CDLL(str(path))
    fn = f"{source}_bf16"
    getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.max_rows = ref.max_rows
    setattr(quant, attr, lambda: lib)
    try:
        yield
    finally:
        setattr(quant, attr, shipped)


def kernel_ms(fn, iters: int) -> float:
    """Device ms of the one kernel a call of ``fn`` launches: its mean over
    the events of ``iters`` calls in a profiler trace (a trace that lost an
    event still reads the call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):   # a trace may come back empty: take it again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "matvec" in e.key and e.count]
        if len(events) == 1:
            return events[0].self_device_time_total / 1e3 / events[0].count
    raise RuntimeError(f"want one kernel's events, got {events}")


def weights(source: str, gen, k: int, f: int, name: str) -> tuple:
    """A random (F, K) weight quantized as its path quantizes it: int8 per
    channel (K4), or int4 nibble-packed with group-128 scales, per channel
    for lm_head (K5)."""
    w = (torch.randn((f, k), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    if source == "int8_matvec":
        return quant.quantize_tensor(w)
    q, s = quant.quantize_tensor(w, bits=4,
                                 group_size=0 if name == "lm_head" else 128)
    return quant.pack_int4(q), s


def time_variants(built: dict, gen) -> None:
    for source in SOURCES:
        wrapper = getattr(quant, source)
        plain = getattr(quant, f"{source}_plain")
        shapes = K4_SHAPES if source == "int8_matvec" else K5_SHAPES
        layers = LAYERS[source]
        for b in ROWS:
            token = {v: 0.0 for v in VARIANTS}
            bound_ms = 0.0
            for name, k, f in shapes:
                n = 1 if name == "lm_head" else layers
                x = torch.randn((b, k), generator=gen,
                                device="cuda").bfloat16()
                w, s = weights(source, gen, k, f, name)
                ref = plain(x, w, s)
                tol = REL_TOL * ref.abs().max().item()
                ws = [w] + [w.clone() for _ in range(
                    -(-WALK_BYTES // w.numel()) - 1)]
                n_bytes = w.numel() + 2 * b * k + 2 * s.numel() + 4 * b * f
                bound_ms += n * n_bytes / HBM_BYTES_PER_S * 1e3
                parts = []
                for variant in VARIANTS:
                    with library(source, built[source, variant][0]):
                        out = wrapper(x, w, s)
                        torch.cuda.synchronize()
                        err = (out - ref).abs().max().item()
                        if err > tol and not variant.startswith("diag_"):
                            raise AssertionError(
                                f"{source} {variant} {name} B{b}: max abs "
                                f"err {err} > {tol}")
                        if b > 1 and not variant.startswith("diag_") \
                                and not all(torch.equal(
                                wrapper(x[r:r + 1].contiguous(), w, s)[0],
                                out[r]) for r in range(b)):
                            raise AssertionError(
                                f"{source} {variant} {name} B{b}: a row "
                                "depends on the other rows")
                        it = iter(range(10 ** 9))
                        ms = kernel_ms(lambda: wrapper(
                            x, ws[next(it) % len(ws)], s), 20)
                    token[variant] += n * ms
                    parts.append(f"{variant} {ms:.4f}")
                print(f"{source} {name} B{b}: bound "
                      f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
                      + ", ".join(parts) + f" ms (tol {tol:.2e})",
                      flush=True)
                del ws
            calls = 4 * layers + 1
            print(f"{source} B{b}, a call over a token's {calls} GEMVs: "
                  f"bound {bound_ms / calls:.4f} ms; " + ", ".join(
                      f"{v} {t / calls:.4f} ms ({100 * bound_ms / t:.1f}%)"
                      for v, t in token.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("gemv_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as tmp:
        built = build(Path(tmp))
        for (source, variant), (_, regs) in built.items():
            print(f"{source} {variant}: " + "; ".join(
                f"{k} {v}" for k, v in regs.items()))
        gen = torch.Generator(device="cuda").manual_seed(0)
        time_variants(built, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
