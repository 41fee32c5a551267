"""Carry parameter trees between the JAX package and the port, and mark
which parameters train.

The port keeps the JAX layouts, so conversion is a dtype and device copy:
``from_jax_params(jax.device_get(params), device, dtype)`` turns the nested
dict of numpy arrays made by ``valley_tpu.models.valley.init_params`` (or a
loaded checkpoint) into a `ValleyWeights` module, and `to_numpy` turns one
back.  `from_state_dict` rebuilds weights saved by the port's own
checkpoints.  Fused serving trees (``wqkv``, ``w_gateup``) and quantized
trees (``quantize_llama_params``, modes ``int8``, ``int8a8``, ``int4``,
``int4g``, ``int4gp``) convert too: quantized leaves keep their type and
their ``*_scale``/``*_scale_a8`` leaves stay bf16, whatever ``dtype`` asks
for the float leaves.

The port keeps int4 nibble-packed only (``ops/quant.py``).  A JAX int4gp
tree's uint8 leaves are taken as they are; an int4g tree (int8 storage,
grouped scales) is packed on conversion, and so is a per-channel int4 tree
(int8 storage, per-channel scales, every value in [-7, 7]).  A grouped
tree's values outside [-7, 7] are refused, as the JAX
``pack_int4_params`` refuses them.

One layout differs: the port stores a quantized ``lm_head`` (out, in), or
(out, in/2) packed, where the JAX package keeps it (in, out), or (in/2,
out), so that every matrix a GEMV kernel reads holds each output's inputs
contiguous; conversion transposes it both ways (its (1, vocab) scale keeps
the JAX shape).  Trees this port cannot run yet are refused: grouped W4A8
(``int4ga8``, ``int4gpa8``), a quantized vision tower, LoRA, or with
temporal pooling parameters.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from valley_tpu_torch.models import clip_vit, llama, valley
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


def _check_served(tree: Mapping[str, Any], where: str) -> None:
    for name, a in tree.items():
        if isinstance(a, Mapping):
            _check_served(a, f"{where}.{name}")
            continue
        if "_lora_" in name or name == "lora_scale":
            raise NotImplementedError(
                f"{where}.{name}: LoRA adapters are not ported yet; merge "
                "them first")
        if np.asarray(a).dtype.name in ("int8", "uint8") and \
                where.startswith("params.vision"):
            raise NotImplementedError(
                f"{where}.{name}: the quantized vision tower "
                "(quantize_vision_params) is not ported yet")


def _holds_int4(lt: Mapping[str, Any]) -> bool:
    """Whether a JAX llama tree holds int4 weights: nibble-packed uint8
    leaves, int8 leaves with grouped scales (only the int4 modes group),
    or int8 leaves whose values all lie in [-7, 7] (per-channel int8 puts
    +-127 on every row that is not all zero)."""
    ints = []
    for level in (lt, lt["layers"]):
        for name, a in level.items():
            if isinstance(a, Mapping):
                continue
            a = np.asarray(a)
            scale = level.get(name + "_scale", level.get(name + "_scale_a8"))
            if a.dtype == np.uint8 or (a.dtype == np.int8 and scale is not None
                                       and np.ndim(scale) == a.ndim
                                       and name != "lm_head"):
                return True
            if a.dtype == np.int8:
                ints.append(a)
    return bool(ints) and all(
        -7 <= int(a.min()) and int(a.max()) <= 7 for a in ints)


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
    })


def from_jax_params(params_np: Mapping[str, Any], device=None,
                    dtype=torch.float32) -> valley.ValleyWeights:
    """The JAX Valley parameter tree (numpy leaves) as the port's weights
    on ``device``: float tensors cast to ``dtype``, quantized ones and
    their scales kept as int8 or uint8 and bf16, a quantized ``lm_head``
    transposed to (out, in).  An int4 tree's int8 leaves (modes int4 and
    int4g) are nibble-packed."""
    _check_served(params_np, "params")
    if params_np.get("temporal"):
        raise NotImplementedError("temporal pooling parameters (importance "
                                  "/ transformer pooling) are not ported yet")
    int4 = _holds_int4(params_np["llama"])
    if int4 and any(n.endswith("_scale_a8")
                    for n in params_np["llama"]["layers"]):
        raise NotImplementedError("grouped W4A8 trees (int4ga8/int4gpa8, "
                                  "*_scale_a8 on int4 weights) are not "
                                  "ported yet")

    def conv(level):
        out = {k: to_tensor(v) for k, v in level.items()}
        for k, t in out.items():
            if int4 and t.dtype == torch.int8:
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
    numpy arrays (with its empty ``temporal`` entry), a quantized
    ``lm_head`` back in (in, out), packed int4 in the JAX int4gp layout.
    bf16 tensors come out as float32, which holds them exactly (numpy has
    no bfloat16)."""
    def leaf(name, t):
        t = t.detach().cpu()
        if name == "llama.lm_head" and t.dtype in QUANTIZED:
            t = t.t()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    tree = _nest((name, leaf(name, t)) for name, t in
                 weights.state_dict().items())
    return {**tree, "temporal": {}}


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
