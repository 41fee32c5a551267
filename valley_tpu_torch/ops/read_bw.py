"""The read-bandwidth probe (K7, ``csrc/read_sum.cu``) and its plain
PyTorch version: ``seed * sum(x.float())`` over a 2-D bf16 array, the
function of the Pallas ``pallas_sum_2d`` of ``tools/exp_read_bw.py``.

It computes nothing the model needs.  Timed on an array far past the
card's 50 MB L2, it gives the card's measured read rate, the ceiling
against which ``chip_smoke.py`` sets the decode GEMVs' times beside the
datasheet's 3.35 TB/s.  The wrapper takes the plain version for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build


def read_sum_plain(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(1, 1) fp32: ``seed * sum(x.float())``.  x: (N, D) bf16; seed: one
    fp32 value ((), (1,) or (1, 1))."""
    return (seed.float().reshape(()) * x.float().sum()).reshape(1, 1)


@functools.cache
def _lib():
    lib = _build.load("read_sum")
    vp = ctypes.c_void_p
    lib.read_sum_bf16.argtypes = [vp, ctypes.c_longlong, vp, vp, vp, vp]
    lib.read_sum_bf16.restype = ctypes.c_int
    lib.read_sum_blocks.restype = ctypes.c_int
    lib.blocks = lib.read_sum_blocks()
    return lib


def _check(x: torch.Tensor, seed: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or seed.dtype != torch.float32:
        raise TypeError(f"read_sum takes bf16 x and an fp32 seed, got "
                        f"{x.dtype}, {seed.dtype}")
    if x.dim() != 2 or seed.numel() != 1:
        raise ValueError(f"want x (N, D) and one seed, got {tuple(x.shape)}, "
                         f"{tuple(seed.shape)}")
    if x.numel() == 0:
        raise ValueError("read_sum of an empty array")
    if seed.device != x.device:
        raise ValueError(f"seed is on {seed.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def read_sum(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``seed * sum(x.float())`` as a (1, 1) fp32 tensor: same arguments
    and result as `read_sum_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous,
    16-byte aligned bf16 (N, D) x and one fp32 seed on the same card; they
    run the kernel, and anything else raises.  Each call adds one to
    ``read_sum.launches``."""
    if x.device.type == "cpu":
        return read_sum_plain(x, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no read_sum for device {x.device}")
    _check(x, seed)
    lib = _lib()
    seed = seed.contiguous()
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    scratch = torch.empty((lib.blocks,), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.read_sum_bf16(x.data_ptr(), x.numel(), seed.data_ptr(),
                            out.data_ptr(), scratch.data_ptr(), stream)
    _build.check(err, "read_sum_bf16")
    _build.count_launch(read_sum)
    return out


read_sum.launches = 0
