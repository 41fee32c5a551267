"""Carry parameter trees between the JAX package and the port, and mark
which parameters train.

The port keeps the JAX layouts, so conversion is a dtype and device copy:
``from_jax_params(jax.device_get(params), device, dtype)`` turns the nested
dict of numpy arrays made by ``valley_tpu.models.valley.init_params`` (or a
loaded checkpoint) into a `ValleyWeights` module, and `to_numpy` turns one
back.  `from_state_dict` rebuilds weights saved by the port's own
checkpoints.  The ``temporal`` entry carries the learned pooling's
parameters (empty for mean and max).  Fused serving trees (``wqkv``,
``w_gateup``) and quantized trees convert too: the decoder's
(``quantize_llama_params``, every mode of ``QUANT_MODES``) and the CLIP
tower's (``quantize_vision_params``: int8 (L, in, out) leaves with (L, 1,
out) scales); quantized leaves keep their type and their
``*_scale``/``*_scale_a8`` leaves stay bf16, whatever ``dtype`` asks for
the float leaves.

The port keeps int4 nibble-packed only (``ops/quant.py``).  A JAX int4gp or
int4gpa8 tree's uint8 leaves are taken as they are; an int4g or int4ga8
tree (int8 storage, grouped scales) is packed on conversion, and so is a
per-channel int4 tree (int8 storage, per-channel scales, every value in
[-7, 7]).  A grouped tree's values outside [-7, 7] are refused, as the JAX
``pack_int4_params`` refuses them.  `to_numpy` gives int4 back packed, as
the JAX int4gp and int4gpa8 trees hold it.

One layout differs: the port stores a quantized ``lm_head`` (out, in), or
(out, in/2) packed, where the JAX package keeps it (in, out), or (in/2,
out), so that every matrix a GEMV kernel reads holds each output's inputs
contiguous; conversion transposes it both ways (its (1, vocab) scale keeps
the JAX shape).  LoRA adapters (``<name>_lora_a``, ``<name>_lora_b``,
``lora_scale``) carry across on the unfused float layout, cast as the
float leaves are; `llama.LlamaLayers` refuses them beside fused or
quantized weights, as JAX's ``fuse_llama_params`` does.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from valley_tpu_torch.models import clip_vit, llama, temporal, valley
from valley_tpu_torch.models.llama import QUANTIZED
from valley_tpu_torch.ops.quant import check_int4_range, pack_int4


def to_tensor(a: Any, device=None, dtype=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on ``device``,
    cast to ``dtype`` when given."""
    a = np.array(a)   # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _holds_int4(lt: Mapping[str, Any]) -> bool:
    """Whether a JAX llama tree holds int4 weights: nibble-packed uint8
    leaves, or int8 leaves whose values all lie in [-7, 7], or grouped int8
    leaves that never reach +-127.  The int8 quantizer puts +-127 at the
    largest weight of every channel or group that is not all zero, so a
    per-channel or grouped int8 tree reaches it; a grouped tree that does
    not is int4 (modes int4g, int4ga8), and packing refuses its values
    outside [-7, 7]."""
    ints, grouped = [], False
    for level in (lt, lt["layers"]):
        for name, a in level.items():
            if isinstance(a, Mapping):
                continue
            a = np.asarray(a)
            if a.dtype == np.uint8:
                return True
            if a.dtype == np.int8:
                ints.append(a)
                scale = level.get(name + "_scale",
                                  level.get(name + "_scale_a8"))
                grouped |= name != "lm_head" and np.ndim(scale) == a.ndim
    if not ints:
        return False
    peak = max(max(-int(a.min()), int(a.max())) for a in ints)
    return peak <= 7 or (grouped and peak < 127)


def _cast_level(level: Mapping[str, torch.Tensor], device, dtype) -> dict:
    """{name: tensor} on ``device``: float leaves cast to ``dtype`` (None
    keeps theirs); quantized (int8, packed uint8) leaves keep their type
    and their ``<name>_scale`` or ``<name>_scale_a8`` leaves are bf16."""
    scales = {n + suffix for n, t in level.items() if t.dtype in QUANTIZED
              for suffix in ("_scale", "_scale_a8")}
    return {k: v.to(device=device) if v.dtype in QUANTIZED
            else v.to(device=device, dtype=torch.bfloat16) if k in scales
            else v.to(device=device, dtype=dtype) for k, v in level.items()}


def _assemble(tree: Mapping[str, Any], conv) -> valley.ValleyWeights:
    """Build the weight modules from a nested tree, ``conv`` turning each
    {name: leaf} level into {name: tensor}."""
    lt, vt = tree["llama"], tree["vision"]
    return valley.ValleyWeights({
        "llama": llama.LlamaWeights({
            **conv({k: v for k, v in lt.items() if k != "layers"}),
            "layers": llama.LlamaLayers(conv(lt["layers"])),
        }),
        "vision": clip_vit.ClipWeights({
            **conv({k: v for k, v in vt.items() if k != "layers"}),
            "layers": clip_vit.ClipLayers(conv(vt["layers"])),
        }),
        "projector": valley.Projector(conv(tree["projector"])),
        "temporal": temporal.TemporalWeights(conv(tree.get("temporal")
                                                  or {})),
    })


def from_jax_params(params_np: Mapping[str, Any], device=None,
                    dtype=torch.float32) -> valley.ValleyWeights:
    """The JAX Valley parameter tree (numpy leaves) as the port's weights
    on ``device``: float tensors cast to ``dtype``, quantized ones and
    their scales kept as int8 or uint8 and bf16, a quantized ``lm_head``
    transposed to (out, in).  An int4 tree's int8 leaves (modes int4,
    int4g and int4ga8) are nibble-packed; the tower's int8 leaves are
    int8."""
    int4 = _holds_int4(params_np["llama"])

    def conv(level):
        out = {k: to_tensor(v) for k, v in level.items()}
        decoder = "embed" in level or "attn_norm" in level
        for k, t in out.items():
            if int4 and decoder and t.dtype == torch.int8:
                # layers pack along in (the last axis); lm_head (in, out)
                # along its first, as the JAX pack_int4_params does
                check_int4_range(k, t)
                out[k] = pack_int4(t, axis=0 if k == "lm_head" else -1)
        out = _cast_level(out, device, dtype)
        if "lm_head" in out and out["lm_head"].dtype in QUANTIZED:
            out["lm_head"] = out["lm_head"].t().contiguous()  # -> (out, in)
        return out

    return _assemble(params_np, conv)


def _nest(items) -> dict:
    """(dotted name, leaf) pairs -> nested dict."""
    tree: dict = {}
    for name, value in items:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def from_state_dict(state: Mapping[str, torch.Tensor], device=None,
                    dtype=None) -> valley.ValleyWeights:
    """Weights from a `ValleyWeights.state_dict()` (dotted names, as the
    port's checkpoints store them, in the port's layouts), float leaves
    cast to ``dtype`` on ``device``; int8 leaves and their scales keep
    their types."""
    return _assemble(_nest(state.items()),
                     lambda level: _cast_level(level, device, dtype))


def to_numpy(weights: valley.ValleyWeights) -> dict:
    """The inverse of `from_jax_params`: the JAX package's nested tree of
    numpy arrays (its ``temporal`` entry empty for mean and max pooling), a
    quantized ``lm_head`` back in (in, out), packed int4 in the JAX int4gp
    layout.
    bf16 tensors come out as float32, which holds them exactly (numpy has
    no bfloat16)."""
    def leaf(name, t):
        t = t.detach().cpu()
        if name == "llama.lm_head" and t.dtype in QUANTIZED:
            t = t.t()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    tree = _nest((name, leaf(name, t)) for name, t in
                 weights.state_dict().items())
    return {"temporal": {}, **tree}


def set_trainable(weights: valley.ValleyWeights,
                  names: Iterable[str]) -> None:
    """Let exactly the parameters named in ``names`` (dotted, as
    ``named_parameters`` gives them) take gradients; `Weights` registers
    every tensor frozen."""
    names = set(names)
    known = {n for n, _ in weights.named_parameters()}
    if names - known:
        raise KeyError(f"no parameters named {sorted(names - known)}")
    for name, p in weights.named_parameters():
        p.requires_grad_(name in names)
