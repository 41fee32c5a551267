"""Serving quantization: the quantizer, the int8 GEMV (K4,
``csrc/int8_matvec.cu``) and the grouped-int4 GEMV (K5,
``csrc/int4_matvec.cu``), each with its plain PyTorch version and the
wrapper that runs one or the other.

Counterpart of ``valley_tpu/ops/quant.py`` for the int8 modes (``int8``,
and ``int8a8``, whose prefill runs W8A8 in `llama._w8a8_dot`) and the
weight-only int4 modes (``int4`` per channel, ``int4g`` and ``int4gp`` with
group-128 scales): symmetric scales over the contraction axis (per output
channel, or per group of ``group_size`` inputs), computed in the weight's
dtype and stored bf16, exactly as the JAX quantizer does.  The grouped W4A8
modes (``int4ga8``, ``int4gpa8``) and the vision quantizer are not ported
and raise NotImplementedError.

Layouts: layer projections stay (L, out, in), scale (L, out) per channel or
(L, out, in/group) grouped.  The JAX package keeps a quantized ``lm_head``
(in, out) with a (1, out) scale; the port quantizes it over the same axis
and stores it transposed to (out, in), so every quantized matrix a GEMV
reads holds each output's inputs contiguous (``weights.py`` converts both
ways).  The scale keeps its JAX shape.

int4 has one storage in the port: nibble-packed uint8, two values per byte
along the contraction axis, the low nibble first (`pack_int4`, bit-equal to
the JAX ``_pack_nibbles``), so ``int4``, ``int4g`` and ``int4gp`` differ
only in their scales.  The JAX package's int8 storage of int4 values and
its in-executable int4 views are TPU workarounds and have no counterpart.

`int8_matvec` and `int4_matvec` are the decode GEMVs: (B, K) activations,
B at most `MAX_ROWS`, against an (F, K) int8 or (F, K/2) packed weight.
Each wrapper takes the plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "wqkv", "w_gateup")   # last two: fused serving layout

# Serving quantization modes -> quantizer knobs (valley_tpu/ops/quant.py
# QUANT_MODES, same rows).  The port serves the int8 modes and the
# weight-only int4 modes.
QUANT_MODES = {
    #            bits  group  act8   packed
    "int8":     dict(bits=8, group_size=0,   act8=False, packed=False),
    "int8a8":   dict(bits=8, group_size=0,   act8=True,  packed=False),
    "int4":     dict(bits=4, group_size=0,   act8=False, packed=False),
    "int4g":    dict(bits=4, group_size=128, act8=False, packed=False),
    "int4gp":   dict(bits=4, group_size=128, act8=False, packed=True),
    "int4ga8":  dict(bits=4, group_size=128, act8=True,  packed=False),
    "int4gpa8": dict(bits=4, group_size=128, act8=True,  packed=True),
}
SERVED_MODES = ("int8", "int8a8", "int4", "int4g", "int4gp")


def parse_quant_mode(mode: str) -> dict:
    """Mode string -> dict(bits, group_size, act8, packed).  Modes the port
    does not serve yet raise NotImplementedError naming the mode."""
    try:
        knobs = dict(QUANT_MODES[mode])
    except KeyError:
        raise ValueError(f"unknown quantization mode {mode!r} "
                         f"(one of {sorted(QUANT_MODES)})") from None
    if mode not in SERVED_MODES:
        raise NotImplementedError(
            f"quantization mode {mode!r} is not ported yet: the port serves "
            f"{', '.join(SERVED_MODES)}")
    return knobs


def _quantize_one(w: torch.Tensor, contract_axis: int = -1, bits: int = 8,
                  group_size: int = 0):
    """Symmetric quantization over the contraction axis (quant.py:64-97):
    fp32 absmax, the scale amax/qmax (127, or 7 for ``bits`` 4) cast to
    w's dtype before ``round(w / scale)``, values clipped to +-qmax and
    stored int8, scales bf16.  With ``group_size`` (contract_axis -1 only,
    and only where it divides the axis, else per channel as in JAX) one
    scale per group: (out, K/group); per channel (out,) for contract_axis
    -1, (1, out) for -2."""
    qmax = 127.0 if bits == 8 else 7.0
    k = w.shape[-1]
    grouped = bool(group_size) and contract_axis == -1 and k % group_size == 0
    if grouped:
        w = w.reshape(w.shape[:-1] + (k // group_size, group_size))
    amax = w.abs().amax(dim=contract_axis, keepdim=True).to(torch.float32)
    scale = torch.where(amax > 0, amax / qmax,
                        torch.ones_like(amax)).to(w.dtype)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    if contract_axis == -1:
        scale = scale[..., 0]
    if grouped:
        q = q.reshape(q.shape[:-2] + (k,))
    return q, scale.to(torch.bfloat16)


def quantize_tensor(w: torch.Tensor, contract_axis: int = -1, bits: int = 8,
                    group_size: int = 0):
    """`_quantize_one`, one layer at a time for an (L, out, in) stack, so
    the transient is one layer."""
    if w.dim() == 3 and contract_axis == -1:
        parts = [_quantize_one(w[i], -1, bits, group_size)
                 for i in range(w.shape[0])]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    return _quantize_one(w, contract_axis, bits, group_size)


def pack_int4(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """int8 values in [-7, 7] -> uint8 nibble pairs along ``axis`` (-1, or
    0 of a 2-D tensor), which must have even length: out[k] = lo(w[2k]) |
    hi(w[2k + 1]) << 4, bit-equal to the JAX ``_pack_nibbles``
    (quant.py:354-367)."""
    if w.shape[axis] % 2:
        raise ValueError(f"pack axis {axis} has odd length {w.shape[axis]}")
    if axis in (-1, w.dim() - 1):
        lo, hi = w[..., 0::2], w[..., 1::2]
    elif axis in (0, -2) and w.dim() == 2:
        lo, hi = w[0::2], w[1::2]
    else:
        raise ValueError(f"unsupported pack axis {axis} for {w.dim()}-D")
    return ((lo & 0xF).to(torch.uint8)
            | ((hi & 0xF).to(torch.uint8) << 4)).contiguous()


def unpack_int4(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The inverse of `pack_int4`: int8 values, each nibble sign-extended
    as ``(n ^ 8) - 8`` (quant.py:370-384)."""
    lo = ((p & 0xF).to(torch.int8) ^ 8) - 8
    hi = ((p >> 4).to(torch.int8) ^ 8) - 8
    if axis in (-1, p.dim() - 1):
        return torch.stack((lo, hi), dim=-1).reshape(
            p.shape[:-1] + (2 * p.shape[-1],))
    if axis in (0, -2) and p.dim() == 2:
        return torch.stack((lo, hi), dim=1).reshape(2 * p.shape[0],
                                                    p.shape[1])
    raise ValueError(f"unsupported unpack axis {axis} for {p.dim()}-D")


def check_int4_range(name: str, q: torch.Tensor) -> None:
    """Refuse int8 values outside [-7, 7] before packing, as the JAX
    ``pack_int4_params`` does (a packed tree can no longer be checked)."""
    lo, hi = int(q.min()), int(q.max())
    if lo < -7 or hi > 7:
        raise ValueError(f"{name} holds values in [{lo}, {hi}]: int4 "
                         "packing needs [-7, 7] (quantize with bits=4)")


def _take(module, name: str) -> torch.Tensor:
    """Remove the parameter ``name`` from ``module`` and return its data."""
    t = module[name].data
    delattr(module, name)
    return t


def quantize_llama_params(params, act8: bool = False, bits: int = 8,
                          group_size: int = 0):
    """Quantize the decoder's projections (and ``lm_head``) of the port's
    `ValleyWeights` (quant.py:119-188), storing ``<name>_scale`` or, with
    ``act8`` (W8A8 prefill, mode ``int8a8``), ``<name>_scale_a8``.

    ``bits`` 8 stores int8; ``bits`` 4 clips to [-7, 7] and nibble-packs
    (`pack_int4`): layers (L, out, in/2) uint8, ``lm_head`` (out, in/2).
    ``group_size`` gives the layers grouped scales where it divides their
    contraction axis; ``lm_head`` is per channel, as in JAX.  W4A8
    (``act8`` with ``bits`` 4) and grouped int8 are not ported.

    Consumes the input, as the JAX quantizer does: each bf16 tensor is
    dropped as its quantized copy is made, so the peak is the tree plus one
    tensor.  Returns ``params`` with its ``llama`` weights replaced.
    """
    from valley_tpu_torch.models import llama

    if act8 and bits == 4:
        raise NotImplementedError("grouped W4A8 (int4ga8/int4gpa8) is not "
                                  "ported yet")
    if bits == 8 and group_size:
        raise NotImplementedError("grouped int8 scales (bits=8 with a "
                                  "group_size) are not ported: no serving "
                                  "mode uses them")
    scale_key = "_scale_a8" if act8 else "_scale"
    lw = params["llama"]
    layers = lw["layers"]
    lt = {n: _take(layers, n) for n, _ in list(
        layers.named_parameters(recurse=False))}
    for name in QUANT_TARGETS:
        if name not in lt or lt[name].dtype in (torch.int8, torch.uint8):
            continue
        q, scale = quantize_tensor(lt.pop(name), bits=bits,
                                   group_size=group_size)
        lt[name] = pack_int4(q) if bits == 4 else q
        lt[name + scale_key] = scale
    top = {n: _take(lw, n) for n, _ in list(lw.named_parameters(
        recurse=False))}
    if top["lm_head"].dtype not in (torch.int8, torch.uint8):
        q, scale = quantize_tensor(top.pop("lm_head"), contract_axis=-2,
                                   bits=bits)
        q = q.t()                               # (in, out) -> (out, in)
        top["lm_head"] = pack_int4(q) if bits == 4 else q.contiguous()
        top["lm_head_scale"] = scale            # (1, out), as in JAX
    params.llama = llama.LlamaWeights({**top,
                                       "layers": llama.LlamaLayers(lt)})
    return params


def quantize_vision_params(params, act8: bool = False):
    """The CLIP tower's int8 quantization (``quantize_vision_params``,
    worker ``--quantize-vision``) is not ported yet."""
    raise NotImplementedError("vision quantization (--quantize-vision "
                              "int8/int8a8) is not ported yet")


def int8_matvec_plain(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """y[..., o] = scale[o] * sum_k x[..., k] w[o, k] in fp32: the
    dequantized product.

    x: (..., K); w: (F, K) int8; scale: (F,).  Returns (..., F) fp32, what
    ``_int8_matvec_kernel`` computes (quant.py:455-460) with w taken
    (out, in)."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    return y * scale.to(torch.float32)


def dequant_matmul(x: torch.Tensor, w: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w) for w (in, out) int8 with an (out,) or (1, out)
    scale (quant.py:495): `int8_matvec_plain` over w's transpose, the
    result in x's dtype."""
    return int8_matvec_plain(x, w.t(), scale.reshape(-1)).to(x.dtype)


# The GEMV kernels' row limit (MAX_ROWS in csrc/int8_matvec.cu,
# csrc/int4_matvec.cu and csrc/bf16_matvec.cu), for the callers that choose
# between a GEMV kernel and a matrix product on any device
MAX_ROWS = 8


@functools.cache
def _lib():
    """The built library, its row limit checked against `MAX_ROWS`."""
    lib = _build.load("int8_matvec")
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.int8_matvec_bf16.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.int8_matvec_bf16.restype = i
    lib.int8_matvec_max_rows.restype = i
    lib.max_rows = lib.int8_matvec_max_rows()
    if lib.max_rows != MAX_ROWS:
        raise RuntimeError(f"int8_matvec.cu serves {lib.max_rows} rows, "
                           f"ops/quant.py expects {MAX_ROWS}")
    return lib


def _check(x, w, scale, max_rows):
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 \
            or scale.dtype != torch.bfloat16:
        raise TypeError(f"int8 matvec takes bf16 x, int8 w and a bf16 "
                        f"scale, got {x.dtype}, {w.dtype}, {scale.dtype}")
    if x.dim() != 2 or w.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"want x (B, K), w (F, K), scale (F,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    b, k = x.shape
    f = w.shape[0]
    if w.shape[1] != k or scale.shape[0] != f:
        raise ValueError(f"x (B, {k}) against w {tuple(w.shape)} and scale "
                         f"{tuple(scale.shape)}")
    if not 1 <= b <= max_rows:
        raise ValueError(f"int8 matvec takes 1..{max_rows} rows, got {b}")
    if k % 16:
        raise ValueError(f"int8 matvec needs K a multiple of 16 (16-byte "
                         f"weight loads), got {k}")
    for name, t in (("x", x), ("w", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # x and w are read in 16-byte vectors; the scale one bf16 at a time
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def int8_matvec(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w)^T for a few rows: same arguments and result as
    `int8_matvec_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous
    bf16 x of at most `MAX_ROWS` rows, an int8 (F, K) w with K a multiple of
    16, and a bf16 (F,) scale; they run the kernel, and anything else
    raises.  Each kernel launch adds one to ``int8_matvec.launches``.
    """
    if x.device.type == "cpu":
        return int8_matvec_plain(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matvec for device {x.device}")
    lib = _lib()
    _check(x, w, scale, lib.max_rows)
    b, k = x.shape
    f = w.shape[0]
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int8_matvec_bf16(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), b, k, f, stream)
    _build.check(err, "int8_matvec_bf16")
    _build.count_launch(int8_matvec)
    return out


int8_matvec.launches = 0


def _group_scale(scale: torch.Tensor, f: int) -> torch.Tensor:
    """An int4 weight's scale as fp32 (F, G): a grouped (F, G) scale as it
    is, a per-channel (F,) or (1, F) one as one group."""
    return scale.reshape(f, -1).to(torch.float32)


def int4_matvec_plain(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """y[..., o] = sum_g scale[o, g] * sum_{i in g} x[..., i] w[o, i] in
    fp32: per-group partial sums of the unpacked weight, each times its
    group's scale, summed over groups.

    x: (..., K); w: (F, K/2) uint8 nibble pairs (`pack_int4`); scale:
    (F, G) bf16 with G dividing K, or (F,) per channel (one group).
    Returns (..., F) fp32, what the Pallas ``pallas_grouped``
    (tools/exp_int4_group.py:80-89) and `_proj`'s grouped branch
    (llama.py:270-317) compute."""
    f, k = w.shape[0], x.shape[-1]
    s = _group_scale(scale, f)
    g = s.shape[1]
    wg = unpack_int4(w).to(torch.float32).reshape(f, g, k // g)
    xg = x.to(torch.float32).reshape(-1, g, k // g)
    part = torch.einsum("bgi,fgi->bfg", xg, wg)
    return (part * s).sum(dim=-1).reshape(x.shape[:-1] + (f,))


def int4_dequantize(w: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The (F, K) weight of a packed (F, K/2) ``w`` and its (F, G) or (F,)
    scale: the unpacked values times their group's scale in fp32, cast to
    ``dtype``."""
    f = w.shape[0]
    s = _group_scale(scale, f)
    wq = unpack_int4(w).to(torch.float32).reshape(f, s.shape[1], -1)
    return (wq * s[..., None]).reshape(f, -1).to(dtype)


@functools.cache
def _lib4():
    """The built K5 library, its row limit checked against `MAX_ROWS`."""
    lib = _build.load("int4_matvec")
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.int4_matvec_bf16.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.int4_matvec_bf16.restype = i
    lib.int4_matvec_max_rows.restype = i
    lib.max_rows = lib.int4_matvec_max_rows()
    if lib.max_rows != MAX_ROWS:
        raise RuntimeError(f"int4_matvec.cu serves {lib.max_rows} rows, "
                           f"ops/quant.py expects {MAX_ROWS}")
    return lib


def _check4(x, w, scale, max_rows) -> int:
    """K5's argument checks; returns the number of groups G."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.uint8 \
            or scale.dtype != torch.bfloat16:
        raise TypeError(f"int4 matvec takes bf16 x, uint8 (packed) w and a "
                        f"bf16 scale, got {x.dtype}, {w.dtype}, "
                        f"{scale.dtype}")
    if x.dim() != 2 or w.dim() != 2 or scale.dim() not in (1, 2):
        raise ValueError(f"want x (B, K), w (F, K/2), scale (F, G) or (F,), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    b, k = x.shape
    f = w.shape[0]
    g = scale.shape[1] if scale.dim() == 2 else 1
    if 2 * w.shape[1] != k or scale.shape[0] != f or k % g:
        raise ValueError(f"x (B, {k}) against w {tuple(w.shape)} and scale "
                         f"{tuple(scale.shape)}")
    if not 1 <= b <= max_rows:
        raise ValueError(f"int4 matvec takes 1..{max_rows} rows, got {b}")
    if k % 32 or k >= 2 ** 19 or (k // g) % 8:
        raise ValueError(f"int4 matvec needs K a multiple of 32 (16-byte "
                         f"loads of 32 weights) below 2^19 and a group size "
                         f"a multiple of 8, got K {k}, group {k // g}")
    for name, t in (("x", x), ("w", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # x and w are read in 16-byte vectors; the scale one bf16 at a time
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return g


def int4_matvec(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w)^T for a few rows of a packed int4 weight with group
    or channel scales: same arguments and result as `int4_matvec_plain`.

    CPU tensors run the plain version.  CUDA tensors must be a contiguous
    bf16 x of at most `MAX_ROWS` rows with K a multiple of 32 below 2^19,
    a uint8
    (F, K/2) w and a bf16 (F, G) or (F,) scale whose group size K/G is a
    multiple of 8; they run the kernel, and anything else raises.  Each
    kernel launch adds one to ``int4_matvec.launches``.
    """
    if x.device.type == "cpu":
        return int4_matvec_plain(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int4 matvec for device {x.device}")
    lib = _lib4()
    g = _check4(x, w, scale, lib.max_rows)
    b, k = x.shape
    f = w.shape[0]
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int4_matvec_bf16(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), b, k, f, g, stream)
    _build.check(err, "int4_matvec_bf16")
    _build.count_launch(int4_matvec)
    return out


int4_matvec.launches = 0
