"""int8 serving quantization: the quantizer, and the int8 GEMV (K4,
``csrc/int8_matvec.cu``) with its plain PyTorch version and the wrapper that
runs one or the other.

Counterpart of ``valley_tpu/ops/quant.py`` for the per-channel int8 modes
(``int8``, and ``int8a8``, whose prefill runs W8A8 in `llama._w8a8_dot`):
symmetric per-output-channel scales over the contraction axis, computed in
the weight's dtype and stored bf16, exactly as the JAX quantizer does.  The
int4 modes (per channel, grouped, nibble-packed, W4A8) and the vision
quantizer are not ported and raise NotImplementedError.

Layouts: layer projections stay (L, out, in), scale (L, out).  The JAX
package keeps a quantized ``lm_head`` (in, out) with a (1, out) scale; the
port quantizes it over the same axis and stores the int8 values transposed
to (out, in), so every int8 matrix K4 reads holds each output's inputs
contiguous (``weights.py`` converts both ways).  The scale keeps its JAX
shape.

`int8_matvec` is the decode GEMV: (B, K) activations, B at most
`max_rows()`, against an (F, K) int8 weight.  The wrapper takes the plain
version for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from valley_tpu_torch.ops import _build

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "wqkv", "w_gateup")   # last two: fused serving layout

# Serving quantization modes -> quantizer knobs (valley_tpu/ops/quant.py
# QUANT_MODES, same rows).  The port serves the two per-channel int8 modes.
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
SERVED_MODES = ("int8", "int8a8")


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


def _quantize_one(w: torch.Tensor, contract_axis: int = -1):
    """Symmetric per-out-channel int8 over the contraction axis
    (quant.py:64-97): fp32 absmax, the scale amax/127 cast to w's dtype
    before ``round(w / scale)``, stored bf16; (out,) for contract_axis -1,
    (1, out) for -2."""
    amax = w.abs().amax(dim=contract_axis, keepdim=True).to(torch.float32)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(w.dtype)
    q = torch.clamp(torch.round(w / scale), -127.0, 127.0).to(torch.int8)
    if contract_axis == -1:
        scale = scale[..., 0]
    return q, scale.to(torch.bfloat16)


def quantize_tensor(w: torch.Tensor, contract_axis: int = -1):
    """`_quantize_one`, one layer at a time for an (L, out, in) stack, so
    the transient is one layer."""
    if w.dim() == 3 and contract_axis == -1:
        parts = [_quantize_one(w[i]) for i in range(w.shape[0])]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    return _quantize_one(w, contract_axis)


def _take(module, name: str) -> torch.Tensor:
    """Remove the parameter ``name`` from ``module`` and return its data."""
    t = module[name].data
    delattr(module, name)
    return t


def quantize_llama_params(params, act8: bool = False):
    """Quantize the decoder's projections (and ``lm_head``) of the port's
    `ValleyWeights` to per-channel int8, storing ``<name>_scale`` or, with
    ``act8`` (W8A8 prefill, mode ``int8a8``), ``<name>_scale_a8``.

    Consumes the input, as the JAX quantizer does: each bf16 tensor is
    dropped as its int8 copy is made, so the peak is the tree plus one
    tensor.  Returns ``params`` with its ``llama`` weights replaced.
    """
    from valley_tpu_torch.models import llama

    scale_key = "_scale_a8" if act8 else "_scale"
    lw = params["llama"]
    layers = lw["layers"]
    lt = {n: _take(layers, n) for n, _ in list(
        layers.named_parameters(recurse=False))}
    for name in QUANT_TARGETS:
        if name not in lt or lt[name].dtype == torch.int8:
            continue
        q, scale = quantize_tensor(lt.pop(name))
        lt[name] = q
        lt[name + scale_key] = scale
    top = {n: _take(lw, n) for n, _ in list(lw.named_parameters(
        recurse=False))}
    if top["lm_head"].dtype != torch.int8:
        q, scale = quantize_tensor(top.pop("lm_head"), contract_axis=-2)
        top["lm_head"] = q.t().contiguous()     # (in, out) -> (out, in)
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


# The kernel's row limit (MAX_ROWS in csrc/int8_matvec.cu), for the callers
# that choose between K4 and a matrix product on any device
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
    int8_matvec.launches += 1
    return out


int8_matvec.launches = 0
