"""Carry a parameter tree of the JAX package over to the port.

The port keeps the JAX layouts, so conversion is a dtype and device copy:
``from_jax_params(jax.device_get(params), device, dtype)`` turns the nested
dict of numpy arrays made by ``valley_tpu.models.valley.init_params`` (or a
loaded checkpoint) into a `ValleyWeights` module.  Trees this port cannot
run yet are refused: quantized, fused (``wqkv``), LoRA, or with temporal
pooling parameters.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def from_jax_params(params_np: Mapping[str, Any], device=None,
                    dtype=torch.float32) -> valley.ValleyWeights:
    """The JAX Valley parameter tree (numpy leaves) as the port's weights,
    every tensor cast to ``dtype`` on ``device``."""
    _check_plain(params_np, "params")
    if params_np.get("temporal"):
        raise NotImplementedError("temporal pooling parameters (importance "
                                  "/ transformer pooling) are not ported yet")

    def conv(tree):
        return {k: to_tensor(v, device, dtype) for k, v in tree.items()}

    lt, vt = params_np["llama"], params_np["vision"]
    return valley.ValleyWeights({
        "llama": llama.LlamaWeights({
            **conv({k: v for k, v in lt.items() if k != "layers"}),
            "layers": llama.LlamaLayers(conv(lt["layers"])),
        }),
        "vision": clip_vit.ClipWeights({
            **conv({k: v for k, v in vt.items() if k != "layers"}),
            "layers": clip_vit.ClipLayers(conv(vt["layers"])),
        }),
        "projector": valley.Projector(conv(params_np["projector"])),
    })
