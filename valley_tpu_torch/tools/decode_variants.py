"""Device times of the decode-attention kernel K3 (``csrc/decode_attn.cu``)
built with each of its compile-time variants, at the shapes
``chip_smoke.py``'s paths give it, and each build's registers as ptxas
reports them.

    python -m valley_tpu_torch.tools.decode_variants

The variants are text substitutions of the shipped source (`VARIANTS`):
64 slots a block (shipped) or 128, and the merge of a (row, kv head)'s
chunks by a second kernel (shipped) or by its last block in one launch.
Each is built with ``-Xptxas -v`` (one nvcc each, all started together),
bound with the port's own wrapper, held against the plain version on the
middle layer and timed walking the layers of random caches at the five
path shapes: bf16 and int8 serving (Valley-7B L32 S639, 513 valid slots),
int8 at 13B (L40 H40), the pool's int8 L32 B8 S2304 (rows of 505, 72 and
1532 valid slots) and the conversation's L40 H40 S2052 (752 valid; int8
and bf16).  Two times a call: the profiler's device time (kernels only,
the lab's `device_ms`), and a CUDA graph of 64 calls replayed and timed by
CUDA events (the device's time from the first kernel to the last, the gaps
between kernels included, without the host's launch cost).  It needs a
CUDA card and nvcc, and stops without them.
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
from valley_tpu_torch.ops import decode_attention as da
from valley_tpu_torch.tools.decode_attn_lab import (REL_TOL,
                                                    conversation_valid,
                                                    device_ms, walk)

# Each variant: text substitutions in the shipped source (each anchor must
# be found, or the build raises); the shipped build first
_CHUNK128 = {"constexpr int CHUNK = 64; ": "constexpr int CHUNK = 128;"}
_ONE = {"constexpr bool ONE_LAUNCH = false;":
        "constexpr bool ONE_LAUNCH = true;"}
VARIANTS = {"shipped": {}, "chunk128": _CHUNK128, "one_launch": _ONE,
            "one_launch_chunk128": {**_ONE, **_CHUNK128}}
# The paths' masks: serving's prompt of 473 tokens in its 512 bucket and 40
# decoded tokens; the pool's rows; the conversation's three turns
PROMPT_LEN, BUCKET, DECODED = 473, 512, 40
POOL_LENS = [505] * 6 + [72, 1532]
_NAME = re.compile(r"decode_attn_kernelI(13__nv_bfloat16|a)Lb[01]ELi(\d+)"
                   r"ELi(\d+)E")


def build(work: Path) -> dict:
    """Every variant built together into ``work``: {variant: (library
    path, ptxas registers of each K3 instantiation)}."""
    shipped = (_build.CSRC / "decode_attn.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = shipped
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is no longer in the "
                                   "source")
            text = text.replace(old, new)
        src = work / f"decode_attn_{name}.cu"
        src.write_text(text)
        out = work / f"libdecode_attn_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               f"-I{_build.CSRC}", "-o", str(out), str(src)]
        jobs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        built[name] = (out, registers(log))
    return built


def registers(log: str) -> dict:
    """Registers of each K3 instantiation in a ptxas -v log, as
    "bf16 D128 REP1"."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            k3 = _NAME.search(entry)
            if k3:
                kind = "bf16" if k3.group(1) != "a" else "int8"
                regs[f"{kind} D{k3.group(2)} REP{k3.group(3)}"] = \
                    int(m.group(1))
            entry = None
    return regs


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """The wrapper launches ``lib``'s kernels inside the block."""
    shipped = da._lib
    da._lib = lambda: lib
    try:
        yield
    finally:
        da._lib = shipped


def graph_ms(fn, calls: int = 64, replays: int = 10) -> float:
    """Device ms a call of ``fn`` from a CUDA graph of ``calls`` calls,
    replayed ``replays`` times between two CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def cases(gen):
    """(name, q, k, v, scales, valid) at the five path shapes, K and V
    N(0, 1) (int8: quantized by the port's `_quantize_kv`)."""
    from valley_tpu_torch.models.llama import _quantize_kv

    serve = torch.zeros((1, 639), dtype=torch.bool, device="cuda")
    serve[:, :PROMPT_LEN] = True
    serve[:, BUCKET:BUCKET + DECODED] = True
    pool = (torch.arange(2304, device="cuda")[None, :]
            < torch.tensor(POOL_LENS, device="cuda")[:, None])
    conv = conversation_valid(2052, PROMPT_LEN, BUCKET, (31, 59), 64).cuda()
    shapes = (("bf16_7b_S639", 32, 32, False, serve),
              ("int8_7b_S639", 32, 32, True, serve),
              ("int8_13b_S639", 40, 40, True, serve),
              ("int8_pool_B8_S2304", 32, 32, True, pool),
              ("int8_conv_S2052", 40, 40, True, conv),
              ("bf16_conv_S2052", 40, 40, False, conv))
    for name, n_layers, h, quant, valid in shapes:
        b, smax = valid.shape
        q = torch.randn((b, 1, h, 128), generator=gen,
                        device="cuda").bfloat16()
        if not quant:
            k, v = (torch.randn((n_layers, b, smax, h, 128), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            yield name, q, k, v, (), valid
            continue
        out = []
        for _ in range(2):
            c = torch.empty((n_layers, b, smax, h, 128), dtype=torch.int8,
                            device="cuda")
            sc = torch.empty((n_layers, b, smax, h), dtype=torch.bfloat16,
                             device="cuda")
            for li in range(n_layers):
                c[li], sc[li] = _quantize_kv(torch.randn(
                    (b, smax, h, 128), generator=gen,
                    device="cuda").bfloat16())
            out += [c, sc]
        yield name, q, out[0], out[2], (out[1], out[3]), valid


def time_variants(libs: dict, gen) -> None:
    for name, q, k, v, scales, valid in cases(gen):
        n_layers, li = k.shape[0], k.shape[0] // 2
        ref = da.decode_attention_plain(q, k, v, li, valid, *scales)
        tol = REL_TOL * ref.float().abs().max().item()
        parts = []
        for variant, lib in libs.items():
            with library(lib):
                out = da.decode_attention_stacked(q, k, v, li, valid, *scales)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                if err > tol:
                    raise AssertionError(f"K3 {variant} {name}: max abs err "
                                         f"{err} > {tol}")
                fn = walk(lambda i: da.decode_attention_stacked(
                    q, k, v, i, valid, *scales), n_layers)
                parts.append(f"{variant} {device_ms(fn, 64):.4f} ms, graph "
                             f"{graph_ms(fn):.4f} ms (err {err:.2e})")
        print(f"K3 {name}: " + "; ".join(parts) + f" (tol {tol:.2e})",
              flush=True)
        del k, v, scales
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        built = build(Path(tmp))
        for variant, (_, regs) in built.items():
            print(f"K3 {variant}: registers "
                  + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())))
        libs = {variant: da.configure(ctypes.CDLL(str(path)))
                for variant, (path, _) in built.items()}
        time_variants(libs, torch.Generator(device="cuda").manual_seed(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
