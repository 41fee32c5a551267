"""Carry parameter trees between the JAX package and the port, and mark
which parameters train.

The port keeps the JAX layouts, so conversion is a dtype and device copy:
``from_jax_params(jax.device_get(params), device, dtype)`` turns the nested
dict of numpy arrays made by ``valley_tpu.models.valley.init_params`` (or a
loaded checkpoint) into a `ValleyWeights` module, and `to_numpy` turns one
back.  `from_state_dict` rebuilds weights saved by the port's own
checkpoints.  Fused serving trees (``wqkv``, ``w_gateup``) and per-channel
int8 trees (``quantize_llama_params``, ``int8`` or ``int8a8``) convert too:
int8 leaves stay int8 and their ``*_scale``/``*_scale_a8`` leaves bf16,
whatever ``dtype`` asks for the float leaves.

One layout differs: the port stores an int8 ``lm_head`` (out, in), where
the JAX package keeps it (in, out), so that every int8 matrix the GEMV
kernel reads holds each output's inputs contiguous; conversion transposes
it both ways (its (1, vocab) scale keeps the JAX shape).  Trees this port
cannot run yet are refused: int4 (nibble-packed uint8 or grouped scales),
LoRA, or with temporal pooling parameters.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from valley_tpu_torch.models import clip_vit, llama, valley


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
        kind = np.asarray(a).dtype.name
        if kind in ("uint8", "int4"):
            raise NotImplementedError(
                f"{where}.{name}: {kind} (nibble-packed or int4) quantized "
                "weights are not ported yet")
        if kind == "int8" and where.startswith("params.vision"):
            raise NotImplementedError(
                f"{where}.{name}: the quantized vision tower "
                "(quantize_vision_params) is not ported yet")
        if kind == "int8":
            scale = tree.get(name + "_scale_a8", tree.get(name + "_scale"))
            if scale is not None and np.ndim(scale) == np.ndim(a) and \
                    name != "lm_head":
                raise NotImplementedError(
                    f"{where}.{name}: grouped quantized scales (int4g) are "
                    "not ported yet")


def _cast_level(level: Mapping[str, torch.Tensor], device, dtype) -> dict:
    """{name: tensor} on ``device``: float leaves cast to ``dtype`` (None
    keeps theirs); int8 leaves stay int8 and their ``<name>_scale`` or
    ``<name>_scale_a8`` leaves bf16."""
    scales = {n + suffix for n, t in level.items() if t.dtype == torch.int8
              for suffix in ("_scale", "_scale_a8")}
    return {k: v.to(device=device) if v.dtype == torch.int8
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
    on ``device``: float tensors cast to ``dtype``, int8 ones and their
    scales kept as int8 and bf16, an int8 ``lm_head`` transposed to
    (out, in)."""
    _check_served(params_np, "params")
    if params_np.get("temporal"):
        raise NotImplementedError("temporal pooling parameters (importance "
                                  "/ transformer pooling) are not ported yet")

    def conv(level):
        out = _cast_level({k: to_tensor(v) for k, v in level.items()},
                          device, dtype)
        if "lm_head" in out and out["lm_head"].dtype == torch.int8:
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
    numpy arrays (with its empty ``temporal`` entry), an int8 ``lm_head``
    back in (in, out).  bf16 tensors come out as float32, which holds them
    exactly (numpy has no bfloat16)."""
    def leaf(name, t):
        t = t.detach().cpu()
        if name == "llama.lm_head" and t.dtype == torch.int8:
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
