"""Build the CUDA sources under ``valley_tpu_torch/csrc`` with nvcc into
shared libraries with a plain C interface, and load them with ctypes.

Each library is built at first use into ``valley_tpu_torch/build/`` under a
name keyed by a hash of its source, the shared headers and the compiler
flags, so an edited source or header builds anew and an unchanged one loads
at once.  Nothing here runs at import: the CPU tests import every module on
a machine with no nvcc.

Every kernel wrapper counts its launches through `count_launch`.  Inside
`recording_launches` (a CUDA graph's capture) the launches go to the
recording instead: a capture runs nothing, and each replay of the graph
adds the recording with `add_launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("flash_fwd", "flash_bwd", "decode_attn", "int8_matvec",
           "int4_matvec", "bf16_matvec", "read_sum", "decode_lab",
           "w4a8_group_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels build only where the CUDA toolkit is "
                       "installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every
    shared header in ``csrc`` (a source may include any of them) and the
    flags, so editing a header builds its includers anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, out) or None when
    the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing


def build_all() -> float:
    """Compile every source not built yet, one nvcc per source, all started
    together.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    started = [(name, _start(name)) for name in SOURCES]
    for name, st in started:
        _finish(name, st)
    return time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


_COUNT_LOCK = threading.Lock()
# this thread's recording of launches under capture, or None
_RECORDING = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel's
    wrapper, or to this thread's recording inside `recording_launches`.
    The serving pool launches kernels from two threads, and the
    interpreter lock does not make ``+= 1`` atomic."""
    rec = getattr(_RECORDING, "launches", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches are recorded in the dict
    yielded ({wrapper: launches}) and not counted."""
    if getattr(_RECORDING, "launches", None) is not None:
        raise RuntimeError("launches are already being recorded")
    rec: dict = {}
    _RECORDING.launches = rec
    try:
        yield rec
    finally:
        _RECORDING.launches = None


def add_launches(rec: dict) -> None:
    """Count a recording's launches (one replay of what it recorded)."""
    with _COUNT_LOCK:
        for wrapper, n in rec.items():
            wrapper.launches += n
