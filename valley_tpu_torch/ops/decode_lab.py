"""Decode-attention variants for measurement (``csrc/decode_lab.cu``): the
port of the TPU measurement kernels T4-T7 in ``tools/``, each with its
plain PyTorch version and the wrapper that runs one or the other.

None of them is on a serving path: they keep the layouts and cuts the
tools varied to find where decode attention's time goes, and
``tools/decode_attn_lab.py`` times them beside K3 (``decode_attention``).

- `attn_head_chunked` (T4, ``tools/exp_attn_pallas2.py``
  ``decode_attn_pallas``): q (B, 1, H, D), a head-major (B, H, S, D)
  cache, an additive fp32 (B, S) bias, ``hc`` heads per block; fp32
  (B, 1, H, D).
- `attn_per_head` (T5, ``tools/exp_attn_layout.py`` ``attn_pallas``): the
  same, one (row, head) per block; each row reads its own bias (the tool
  broadcasts row 0's, which is the same at B = 1).
- `attn_stacked_head_major` (T6, ``tools/exp_attn_pallas3.py``
  ``decode_attn_stacked``): T4 on layer ``li`` of a stacked
  (L, B, H, S, D) cache, read in place.
- `attn_stage` (T7, ``tools/exp_kernel_ablate.py`` ``make_kernel``): K3's
  structure over the port's slot-major (L, B, S, H, D) cache with an
  additive bias, cut at ``stage`` 0-4 (see `attn_stage_plain`); q
  (B, H, D), bf16 (B, H, D) out.

The plain versions repeat the tools' arithmetic: fp32 logits, times
D^-1/2, plus the bias; fp32 softmax; probabilities cast to the value dtype
before PV; fp32 accumulation, the normalising sum unrounded.  (The tools
multiply the bf16 probabilities by V in bf16; XLA keeps that product in
fp32 unless its excess precision is turned off, so the tools compute this
function.)  A row whose every slot carries the -1e9 bias gets the mean of
V.  The wrappers take the plain version for CPU tensors only; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build

HEAD_DIMS = (64, 128)
STAGES = (0, 1, 2, 3, 4)


def attn_head_major_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """T4's and T5's function (T6's on one layer): q (B, 1, H, D), k/v
    (B, H, S, D), bias (B, S) fp32 -> (B, 1, H, D) fp32."""
    d = q.shape[-1]
    logits = torch.einsum("bhd,bhsd->bhs", q[:, 0].float(), k.float()) \
        * d ** -0.5 + bias.float()[:, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    z = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bhsd->bhd", p.to(v.dtype).float(), v.float())
    return (out / z)[:, None]


def attn_stage_plain(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, bias: torch.Tensor, li: int,
                     stage: int) -> torch.Tensor:
    """T7 at ``stage`` on layer ``li``: q (B, H, D) bf16; k_all/v_all
    (L, B, S, H, D) bf16; bias (B, S) fp32 -> (B, H, D) bf16.

    0: k[:, 0:H, head 0] + v[:, 0:H, head 0] (the tool's
    ``k_flat[0:H, 0:D] + v_flat[0:H, 0:D]``, slots 0..H-1 of head 0);
    1: the row's largest logit (bias not added), over every slot and head;
    2: per head, m + l, the biased logits' max and the sum of
    exp(logit - m); 3: the attention output; 4: the same function (the
    tool transposes P before its PV product)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage}")
    k, v = k_all[li], v_all[li]
    b, s, h, d = k.shape
    if stage == 0:
        return k[:, :h, 0] + v[:, :h, 0]
    logits = torch.einsum("bhd,bshd->bsh", q.float(), k.float()) * d ** -0.5
    if stage == 1:
        mx = logits.amax(dim=(1, 2))
        return mx[:, None, None].expand(b, h, d).to(torch.bfloat16)
    logits = logits + bias.float()[:, :, None]
    m = logits.amax(dim=1, keepdim=True)                  # (B, 1, H)
    p = torch.exp(logits - m)
    l = p.sum(dim=1, keepdim=True)
    if stage == 2:
        return (m + l).transpose(1, 2).expand(b, h, d).to(torch.bfloat16)
    out = torch.einsum("bsh,bshd->bhd", p.to(v.dtype).float(), v.float())
    return (out / l.transpose(1, 2)).to(torch.bfloat16)


@functools.cache
def _lib():
    """The built library, with its compile-time constants read once:
    ``chunk`` (T7's slots per block) and ``max_slots`` (the head-major
    kernels' longest S)."""
    lib = _build.load("decode_lab")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_lab_t4.argtypes = [vp] * 5 + [i] * 5 + [f, vp]
    lib.decode_lab_t5.argtypes = [vp] * 5 + [i] * 4 + [f, vp]
    lib.decode_lab_t6.argtypes = [vp] * 5 + [i] * 6 + [f, vp]
    lib.decode_lab_t7.argtypes = [vp] * 9 + [i] * 7 + [f, vp]
    for fn in (lib.decode_lab_t4, lib.decode_lab_t5, lib.decode_lab_t6,
               lib.decode_lab_t7, lib.decode_lab_chunk,
               lib.decode_lab_max_slots):
        fn.restype = i
    lib.chunk = lib.decode_lab_chunk()
    lib.max_slots = lib.decode_lab_max_slots()
    return lib


def _check(what: str, q, k, v, bias, layout: str, max_slots=None) -> None:
    """Types, shapes, devices and alignment the kernels take: bf16 q and
    cache, fp32 bias, contiguous, 16-byte aligned; ``layout`` names the
    cache's axes ("BHSD", "LBHSD" or "LBSHD") and q's are (B, 1, H, D), or
    (B, H, D) for the slot-major cache."""
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"{what} takes bf16 q and cache and an fp32 bias, "
                        f"got {q.dtype}, {k.dtype}/{v.dtype}, {bias.dtype}")
    if k.dim() != len(layout) or k.shape != v.shape:
        raise ValueError(f"{what}: want k/v ({', '.join(layout)}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    dims = dict(zip(layout, k.shape))
    b, h, s, d = dims["B"], dims["H"], dims["S"], dims["D"]
    want_q = (b, h, d) if layout == "LBSHD" else (b, 1, h, d)
    if tuple(q.shape) != want_q:
        raise ValueError(f"{what}: want q {want_q}, got {tuple(q.shape)}")
    if tuple(bias.shape) != (b, s):
        raise ValueError(f"{what}: want bias (B, S) = {(b, s)}, got "
                         f"{tuple(bias.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {HEAD_DIMS}, got {d}")
    if max_slots is not None and s > max_slots:
        raise ValueError(f"{what} holds at most {max_slots} slots of a head "
                         f"in shared memory, got {s}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _device(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {q.device}")
    return q.device.type == "cuda"


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def attn_head_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, hc: int = 16) -> torch.Tensor:
    """T4: `attn_head_major_plain`'s function, ``hc`` heads per block (the
    last block takes what is left).  Each launch adds one to
    ``attn_head_chunked.launches``."""
    if not _device(q, "attn_head_chunked"):
        return attn_head_major_plain(q, k, v, bias)
    lib = _lib()
    _check("attn_head_chunked", q, k, v, bias, "BHSD", lib.max_slots)
    if hc < 1:
        raise ValueError(f"hc must be at least 1, got {hc}")
    b, h, s, d = k.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = lib.decode_lab_t4(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), b, h, s, d, hc,
                            d ** -0.5, _stream(q))
    _build.check(err, "decode_lab_t4")
    _build.count_launch(attn_head_chunked)
    return out


def attn_per_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """T5: `attn_head_major_plain`'s function, one (row, head) per block.
    Each launch adds one to ``attn_per_head.launches``."""
    if not _device(q, "attn_per_head"):
        return attn_head_major_plain(q, k, v, bias)
    lib = _lib()
    _check("attn_per_head", q, k, v, bias, "BHSD", lib.max_slots)
    b, h, s, d = k.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = lib.decode_lab_t5(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), b, h, s, d,
                            d ** -0.5, _stream(q))
    _build.check(err, "decode_lab_t5")
    _build.count_launch(attn_per_head)
    return out


def attn_stacked_head_major(q: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, bias: torch.Tensor, li: int,
                            hc: int = 16) -> torch.Tensor:
    """T6: T4 on layer ``li`` of the stacked (L, B, H, S, D) cache, read in
    place.  Each launch adds one to ``attn_stacked_head_major.launches``."""
    if not _device(q, "attn_stacked_head_major"):
        return attn_head_major_plain(q, k_all[li], v_all[li], bias)
    lib = _lib()
    _check("attn_stacked_head_major", q, k_all, v_all, bias, "LBHSD",
           lib.max_slots)
    n_layers, b, h, s, d = k_all.shape
    if not 0 <= li < n_layers:
        raise IndexError(f"layer {li} outside the cache's {n_layers}")
    if hc < 1:
        raise ValueError(f"hc must be at least 1, got {hc}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = lib.decode_lab_t6(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), int(li), b, h, s,
                            d, hc, d ** -0.5, _stream(q))
    _build.check(err, "decode_lab_t6")
    _build.count_launch(attn_stacked_head_major)
    return out


def attn_stage(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
               bias: torch.Tensor, li: int, stage: int = 3) -> torch.Tensor:
    """T7 at ``stage``: `attn_stage_plain`'s function through the first K3's
    structure (a block per row, head and 64-slot chunk, then a combine
    kernel, which stage 0 leaves empty).  Each call adds one to
    ``attn_stage.launches``."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage}")
    if not _device(q, "attn_stage"):
        return attn_stage_plain(q, k_all, v_all, bias, li, stage)
    lib = _lib()
    _check("attn_stage", q, k_all, v_all, bias, "LBSHD")
    n_layers, b, s, h, d = k_all.shape
    if not 0 <= li < n_layers:
        raise IndexError(f"layer {li} outside the cache's {n_layers}")
    if s < h:
        raise ValueError(f"stage 0 reads slots 0..H-1: want S >= H, got S "
                         f"{s}, H {h}")
    n_split = -(-s // lib.chunk)
    dev = q.device
    part_acc = torch.empty((b, h, n_split, d), dtype=torch.float32,
                           device=dev)
    part_m = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, h, n_split), dtype=torch.float32, device=dev)
    sink = torch.empty((b * h,), dtype=torch.int32, device=dev)
    out = torch.empty((b, h, d), dtype=torch.bfloat16, device=dev)
    err = lib.decode_lab_t7(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                            bias.data_ptr(), part_acc.data_ptr(),
                            part_m.data_ptr(), part_l.data_ptr(),
                            out.data_ptr(), sink.data_ptr(), int(li), b, s, h,
                            d, n_split, stage, d ** -0.5, _stream(q))
    _build.check(err, "decode_lab_t7")
    _build.count_launch(attn_stage)
    return out


attn_head_chunked.launches = 0
attn_per_head.launches = 0
attn_stacked_head_major.launches = 0
attn_stage.launches = 0
