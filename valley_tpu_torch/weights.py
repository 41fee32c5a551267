"""Carry parameter trees between the JAX package and the port, and mark
which parameters train.

The port keeps the JAX layouts, so conversion is a dtype and device copy:
``from_jax_params(jax.device_get(params), device, dtype)`` turns the nested
dict of numpy arrays made by ``valley_tpu.models.valley.init_params`` (or a
loaded checkpoint) into a `ValleyWeights` module, and `to_numpy` turns one
back.  `from_state_dict` rebuilds weights saved by the port's own
checkpoints.  Trees this port cannot run yet are refused: quantized, fused
(``wqkv``), LoRA, or with temporal pooling parameters.
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


def _check_plain(tree: Mapping[str, Any], where: str) -> None:
    for name, a in tree.items():
        if isinstance(a, Mapping):
            _check_plain(a, f"{where}.{name}")
            continue
        if name in ("wqkv", "w_gateup"):
            raise NotImplementedError(
                f"{where}.{name}: the fused serving layout is not ported yet")
        if np.asarray(a).dtype.name in ("int8", "uint8", "int4"):
            raise NotImplementedError(
                f"{where}.{name}: quantized weights are not ported yet")
        if "_lora_" in name or name == "lora_scale":
            raise NotImplementedError(
                f"{where}.{name}: LoRA adapters are not ported yet; merge "
                "them first")


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
    """The JAX Valley parameter tree (numpy leaves) as the port's weights,
    every tensor cast to ``dtype`` on ``device``."""
    _check_plain(params_np, "params")
    if params_np.get("temporal"):
        raise NotImplementedError("temporal pooling parameters (importance "
                                  "/ transformer pooling) are not ported yet")
    return _assemble(params_np, lambda level: {
        k: to_tensor(v, device, dtype) for k, v in level.items()})


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
    port's checkpoints store them), cast to ``dtype`` on ``device``."""
    return _assemble(_nest(state.items()), lambda level: {
        k: v.to(device=device, dtype=dtype) for k, v in level.items()})


def to_numpy(weights: valley.ValleyWeights) -> dict:
    """The inverse of `from_jax_params`: the JAX package's nested tree of
    numpy arrays (with its empty ``temporal`` entry).  bf16 tensors come
    out as float32, which holds them exactly (numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    tree = _nest((name, leaf(t)) for name, t in
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
