"""LoRA as weight-tree surgery, the counterpart of
``valley_tpu/train/lora.py``.

The adapters are extra tensors of the decoder's stacked layers,
``<name>_lora_a`` (L, in, r) and ``<name>_lora_b`` (L, r, out) for each
target projection and one ``lora_scale`` (L, 1, 1), which `llama._proj`
picks up wherever the weights are used.  Freezing the base is the
trainer's labels ('lora' for the factors), not module flags; the adapter
dropout is applied at train time through the forward's ``lora_rng``.
Every function returns a new `ValleyWeights` that shares the tensors it
does not change with the one it was given.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from valley_tpu_torch.models import llama, valley

# the reference's target_modules, by the stacked weights' names
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_down", "w_up")


def _with_layers(params: valley.ValleyWeights,
                 layers: Mapping[str, torch.Tensor]) -> valley.ValleyWeights:
    """A new tree whose decoder layers are ``layers``; every other tensor
    (and the tower, projector and temporal modules) shared with
    ``params``."""
    lw = params["llama"]
    top = {n: p.data for n, p in lw.named_parameters(recurse=False)}
    return valley.ValleyWeights({
        "llama": llama.LlamaWeights({**top,
                                     "layers": llama.LlamaLayers(layers)}),
        "vision": params["vision"], "projector": params["projector"],
        "temporal": params["temporal"]})


def _layer_tensors(params: valley.ValleyWeights) -> dict:
    return {n: p.data for n, p in
            params["llama"]["layers"].named_parameters(recurse=False)}


def add_lora(params: valley.ValleyWeights, generator: torch.Generator,
             r: int = 16, alpha: int = 32,
             targets: Sequence[str] = DEFAULT_TARGETS,
             dtype=torch.bfloat16) -> valley.ValleyWeights:
    """The tree with LoRA factors added to every layer of each target
    (lora.py:25-47): A ~ N(0, 1) * fan_in^-1/2 drawn in fp32 from
    ``generator`` (one draw per target, in ``targets``' order) and cast to
    ``dtype``, B zero, so the first step is the base model's; the scale
    alpha / r."""
    layers = _layer_tensors(params)
    if "wqkv" in layers:
        raise ValueError("adapters target the unfused projections: add them "
                         "before fuse_llama_params")
    n_layers = layers["wq"].shape[0]
    device = layers["wq"].device
    for name in targets:
        _, fan_out, fan_in = layers[name].shape      # (L, out, in)
        a = torch.randn((n_layers, fan_in, r), generator=generator,
                        dtype=torch.float32, device=device)
        layers[name + "_lora_a"] = (a * fan_in ** -0.5).to(dtype)
        layers[name + "_lora_b"] = torch.zeros((n_layers, r, fan_out),
                                               dtype=dtype, device=device)
    layers["lora_scale"] = torch.full((n_layers, 1, 1), alpha / r,
                                      dtype=dtype, device=device)
    return _with_layers(params, layers)


def merge_lora(params: valley.ValleyWeights) -> valley.ValleyWeights:
    """Fold A @ B * scale into the base weights and drop the factors, the
    reference's ``merge_and_unload`` (lora.py:50-71): the product and the
    sum in fp32, the result cast to the base weight's dtype.  Layer by
    layer, so the fp32 temporaries are one layer's; returns a new tree (the
    merged projections new tensors) and leaves ``params`` as it is.  A tree
    without adapters is returned as it is."""
    layers = _layer_tensors(params)
    scale = layers.get("lora_scale")
    if scale is None:
        return params
    merged = {}
    with torch.no_grad():
        for name, w in layers.items():
            if llama.is_lora_name(name):
                continue
            a = layers.get(name + "_lora_a")
            if a is not None:
                b = layers[name + "_lora_b"]
                out = torch.empty_like(w)
                for li in range(w.shape[0]):
                    delta = (a[li].float() @ b[li].float()).t() \
                        * scale[li, 0, 0].float()
                    out[li] = (w[li].float() + delta).to(w.dtype)
                w = out
            merged[name] = w
    return _with_layers(params, merged)


def is_lora_key(path) -> bool:
    """Whether a parameter path (a tuple of keys, or a dotted name) ends in
    a LoRA factor."""
    last = str(path[-1]) if isinstance(path, tuple) else \
        str(path).rsplit(".", 1)[-1]
    return last.endswith("_lora_a") or last.endswith("_lora_b")


def split_lora(params: valley.ValleyWeights) -> dict:
    """Only the adapter tensors, {name: tensor} as the layers name them
    (for adapter-only checkpoints, the reference's ``LLMCallback``)."""
    return {n: t.detach() for n, t in _layer_tensors(params).items()
            if llama.is_lora_name(n)}


def load_lora(params: valley.ValleyWeights,
              adapter: Mapping[str, torch.Tensor]) -> valley.ValleyWeights:
    """The tree with the adapter tensors of `split_lora` put into its
    layers (on the layers' device, in the adapter's dtypes)."""
    layers = _layer_tensors(params)
    device = layers["wq"].device if "wq" in layers else None
    layers.update({n: torch.as_tensor(t).to(device)
                   for n, t in adapter.items()})
    return _with_layers(params, layers)
