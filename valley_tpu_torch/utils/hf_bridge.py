"""Hugging Face checkpoints for the PyTorch port: convert a Valley (or plain
LLaMA) HF directory into the port's `ValleyWeights`, quantizing on load,
and write the port's weights back as an HF directory.

The port's counterpart of ``valley_tpu/utils/hf_bridge.py`` (which imports
jax).  The files are read and written by the port's own safetensors code
(`safetensors_io`); the tokenizer comes from the checkpoint through
``transformers`` (`tokenizer.load_hf_tokenizer`), or is passed by the
caller.  Layouts are the JAX package's, as `weights.from_jax_params` keeps
them: LLaMA projections (L, out, in) as HF stores them, ``lm_head`` and the
projector (in, out), CLIP's GEMMs (L, in, out) and its stride-14 patch
convolution flattened to (3 p p, H).

Quantize-on-load (``load_valley_checkpoint(quantize=...)``, the JAX
loader's ``:489-497, 527-552``): the JAX package quantizes on the host so
that a 13B bf16 tree never exists whole on a 16 GB chip.  The port does the
same work on the card one layer at a time: a layer's bf16 weights are
moved to the card, fused (``fused``), quantized by the port's quantizer
(`ops.quant._quantize_one`, bit-equal to the JAX host quantizer) and
nibble-packed for int4, written into the quantized stacks, and the bf16
copy is dropped; ``lm_head`` follows.  The card holds at most the
quantized tree, the bf16 embedding, the vision tower and one bf16 layer.
Every mode of `quant.QUANT_MODES` quantizes on load, the grouped W4A8
modes (``int4ga8``, ``int4gpa8``) to the same packed tree; the tower stays
as the checkpoint holds it (``--quantize-vision`` quantizes it after the
load, `quant.quantize_vision_params`).

Temporal pooling: a checkpoint whose ``config.json`` sets
``use_patch_importance_pooling`` or ``use_delta_transformer`` loads its
pooling layer (``model.pooling_layer.*``) or its one-layer encoder
(``model.transformer_delta_encoder.layers.0.*`` and
``model.position_matrix``), `convert_temporal`, and the exporter writes
them back under those names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.models import clip_vit, llama, temporal, valley
from valley_tpu_torch.ops import quant
from valley_tpu_torch.ops.w4a8 import check_card_group
from valley_tpu_torch.utils.safetensors_io import (read_state_dict,
                                                   save_sharded)

__all__ = ["convert_llama", "export_llama", "convert_clip", "export_clip",
           "convert_projector", "convert_temporal", "read_state_dict",
           "export_valley_checkpoint", "resize_token_embeddings",
           "text_config_from_hf", "load_valley_checkpoint"]

# HF name of each stacked LLaMA layer tensor, stored (out, in) as HF stores
# it
LLAMA_LAYER_KEYS = {
    "attn_norm": "input_layernorm.weight",
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "mlp_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}
# HF name of each stacked CLIP layer tensor; True: a Linear weight, stored
# (in, out) here and (out, in) in HF
CLIP_LAYER_KEYS = {
    "ln1_scale": ("layer_norm1.weight", False),
    "ln1_bias": ("layer_norm1.bias", False),
    "wq": ("self_attn.q_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "wk": ("self_attn.k_proj.weight", True),
    "bk": ("self_attn.k_proj.bias", False),
    "wv": ("self_attn.v_proj.weight", True),
    "bv": ("self_attn.v_proj.bias", False),
    "wo": ("self_attn.out_proj.weight", True),
    "bo": ("self_attn.out_proj.bias", False),
    "ln2_scale": ("layer_norm2.weight", False),
    "ln2_bias": ("layer_norm2.bias", False),
    "fc1": ("mlp.fc1.weight", True),
    "fc1_bias": ("mlp.fc1.bias", False),
    "fc2": ("mlp.fc2.weight", True),
    "fc2_bias": ("mlp.fc2.bias", False),
}
FUSED = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up")}
# the vision tower's shape in config.json (HF CLIPVisionConfig's keys)
VISION_KEYS = ("hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads", "image_size", "patch_size",
               "layer_norm_eps", "hidden_act")


def _strip_prefix(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out or dict(sd)


def _put(t: torch.Tensor, dtype, device) -> torch.Tensor:
    """A copy of a checkpoint tensor on ``device`` in ``dtype`` (never the
    file's mapping itself)."""
    return t.to(device=device, dtype=dtype, copy=True)


def _stack(sd, fmt: str, n: int, dtype, device, transpose: bool = False
           ) -> torch.Tensor:
    """The ``n`` per-layer tensors ``fmt.format(i)`` as one (n, ...) tensor
    on ``device``, filled a layer at a time."""
    out = None
    for i in range(n):
        w = _put(sd[fmt.format(i)], dtype, device)
        if transpose:
            w = w.t()
        if out is None:
            out = torch.empty((n,) + tuple(w.shape), dtype=dtype,
                              device=device)
        out[i] = w
    return out


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------

def _llama_sd(sd: Mapping[str, Any]) -> Dict[str, Any]:
    return {k.replace("base_model.model.", ""): v for k, v in sd.items()}


def convert_llama(sd: Mapping[str, Any], cfg: C.TextConfig,
                  dtype=torch.bfloat16, device=None,
                  fused: bool = False) -> Dict[str, Any]:
    """HF ``LlamaForCausalLM`` state dict (``model.layers.N...``,
    ``lm_head.weight``) -> {name: tensor} of `llama.LlamaWeights` (its
    ``layers`` a `llama.LlamaLayers`) on ``device`` in ``dtype``: the
    projections (L, out, in) as HF stores them, ``lm_head`` (in, out).
    ``fused`` concatenates each layer's wq/wk/wv and w_gate/w_up along the
    out axis as it stacks them (`llama.fuse_llama_params`)."""
    sd = _llama_sd(sd)
    n = cfg.num_hidden_layers
    keys = {name: "model.layers.{}." + key
            for name, key in LLAMA_LAYER_KEYS.items()}
    if fused:
        layers = {"attn_norm": _stack(sd, keys["attn_norm"], n, dtype,
                                      device),
                  "mlp_norm": _stack(sd, keys["mlp_norm"], n, dtype, device),
                  "wo": _stack(sd, keys["wo"], n, dtype, device),
                  "w_down": _stack(sd, keys["w_down"], n, dtype, device)}
        for out, parts in FUSED.items():
            stack = None
            for i in range(n):
                w = torch.cat([_put(sd[keys[p].format(i)], dtype, device)
                               for p in parts])
                if stack is None:
                    stack = torch.empty((n,) + tuple(w.shape), dtype=dtype,
                                        device=device)
                stack[i] = w
            layers[out] = stack
    else:
        layers = {name: _stack(sd, fmt, n, dtype, device)
                  for name, fmt in keys.items()}
    return {
        "embed": _put(sd["model.embed_tokens.weight"], dtype, device),
        "layers": layers,
        "final_norm": _put(sd["model.norm.weight"], dtype, device),
        "lm_head": _put(sd["lm_head.weight"], dtype, device).t().contiguous(),
    }


def _quantized_llama(sd: Mapping[str, Any], cfg: C.TextConfig, dtype, device,
                     fused: bool, mode: str, group_size: int,
                     new_vocab: Optional[int]) -> Dict[str, Any]:
    """Quantize-on-load: `convert_llama`'s tree quantized in ``mode`` (a
    mode of `quant.QUANT_MODES`), made one layer at a time on ``device``
    (see the module docstring); ``new_vocab`` resizes the embedding and
    ``lm_head`` first (`resize_token_embeddings`), as the JAX loader
    resizes before it quantizes."""
    knobs = quant.parse_quant_mode(mode)
    bits = knobs["bits"]
    group = group_size if knobs["group_size"] else 0
    quant.check_act8(bits, group, knobs["act8"])
    if knobs["act8"] and bits == 4:
        # K8's groups, refused before a layer is read: the projections'
        # inputs are the hidden and the intermediate width
        for k in (cfg.hidden_size, cfg.intermediate_size):
            check_card_group(group, k, device)
    scale_key = "_scale_a8" if knobs["act8"] else "_scale"
    sd = _llama_sd(sd)
    n = cfg.num_hidden_layers
    keys = {name: "model.layers.{}." + key
            for name, key in LLAMA_LAYER_KEYS.items()}
    stacks: Dict[str, torch.Tensor] = {}

    def store(name: str, i: int, t: torch.Tensor) -> None:
        if name not in stacks:
            stacks[name] = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                       device=device)
        stacks[name][i] = t

    for i in range(n):
        layer = {name: _put(sd[fmt.format(i)], dtype, device)
                 for name, fmt in keys.items()}
        if fused:
            for out, parts in FUSED.items():
                layer[out] = torch.cat([layer.pop(p) for p in parts])
        for name in llama.LlamaLayers.expected_names(layer):
            w = layer.pop(name)
            if name not in quant.QUANT_TARGETS:
                store(name, i, w)
                continue
            q, scale = quant._quantize_one(w, -1, bits, group)
            del w
            store(name, i, quant.pack_int4(q) if bits == 4 else q)
            store(name + scale_key, i, scale)
        del layer
    top = {"embed": _put(sd["model.embed_tokens.weight"], dtype, device),
           "final_norm": _put(sd["model.norm.weight"], dtype, device),
           "lm_head": _put(sd["lm_head.weight"], dtype, device).t()}
    if new_vocab is not None:
        top = resize_token_embeddings(top, new_vocab)
    q, scale = quant._quantize_one(top.pop("lm_head"), -2, bits)
    q = q.t()                                      # (in, out) -> (out, in)
    top["lm_head"] = quant.pack_int4(q) if bits == 4 else q.contiguous()
    top["lm_head_scale"] = scale                   # (1, out), as in JAX
    return {**top, "layers": stacks}


def export_llama(weights: llama.LlamaWeights, prefix: str = ""
                 ) -> Dict[str, torch.Tensor]:
    """The port's unfused, unquantized decoder -> HF-layout state dict:
    views of the weights where they lie (cast and moved by the writer)."""
    lay = weights["layers"]
    if "wqkv" in lay or any(t.dtype in llama.QUANTIZED
                            for t in weights.parameters()):
        raise ValueError("export takes an unfused, unquantized tree (export "
                         "before fuse_llama_params / quantize_llama_params)")
    out = {}
    for ours, theirs in LLAMA_LAYER_KEYS.items():
        arr = lay[ours].data
        for i in range(arr.shape[0]):
            out[f"{prefix}model.layers.{i}.{theirs}"] = arr[i]
    out[prefix + "model.embed_tokens.weight"] = weights["embed"].data
    out[prefix + "model.norm.weight"] = weights["final_norm"].data
    out[prefix + "lm_head.weight"] = weights["lm_head"].data.t()
    return out


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------

def convert_clip(sd: Mapping[str, Any], cfg: C.VisionConfig,
                 dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` or ``ChineseCLIPVisionModel`` state dict (with
    or without the ``vision_model.`` prefix) -> {name: tensor} of
    `clip_vit.ClipWeights`.  ChineseCLIP's ``pre_layernorm`` spelling is
    taken for CLIP's ``pre_layrnorm`` (the two towers are otherwise one
    architecture, ``hf_bridge.py:153-167``)."""
    sd = _strip_prefix(sd, "vision_model.")
    if "pre_layernorm.weight" in sd:
        sd = dict(sd)
        sd["pre_layrnorm.weight"] = sd["pre_layernorm.weight"]
        sd["pre_layrnorm.bias"] = sd["pre_layernorm.bias"]
    n, h = cfg.num_hidden_layers, cfg.hidden_size
    conv = _put(sd["embeddings.patch_embedding.weight"], dtype, device)
    enc = "encoder.layers.{}."
    return {
        "class_embedding": _put(sd["embeddings.class_embedding"], dtype,
                                device),
        "patch_embedding": conv.reshape(h, -1).t().contiguous(),
        "position_embedding": _put(
            sd["embeddings.position_embedding.weight"], dtype, device),
        "pre_ln_scale": _put(sd["pre_layrnorm.weight"], dtype, device),
        "pre_ln_bias": _put(sd["pre_layrnorm.bias"], dtype, device),
        "layers": {ours: _stack(sd, enc + theirs, n, dtype, device,
                                transpose)
                   for ours, (theirs, transpose) in CLIP_LAYER_KEYS.items()},
    }


def export_clip(vision: clip_vit.ClipWeights, prefix: str = ""
                ) -> Dict[str, torch.Tensor]:
    """The port's CLIP tower -> HF ``vision_model.*`` state dict, with the
    identity ``post_layernorm`` HF checkpoints carry (the -2 tap never
    reads it)."""
    def p(k):
        return prefix + "vision_model." + k

    lay = vision["layers"]
    h = vision["class_embedding"].shape[0]
    patch = vision["patch_embedding"].data             # (3 p p, H)
    ps = int(round((patch.shape[0] // 3) ** 0.5))
    out = {p("embeddings.class_embedding"): vision["class_embedding"].data,
           p("embeddings.patch_embedding.weight"):
               patch.t().contiguous().reshape(h, 3, ps, ps),
           p("embeddings.position_embedding.weight"):
               vision["position_embedding"].data,
           p("pre_layrnorm.weight"): vision["pre_ln_scale"].data,
           p("pre_layrnorm.bias"): vision["pre_ln_bias"].data}
    for ours, (theirs, transpose) in CLIP_LAYER_KEYS.items():
        arr = lay[ours].data
        for i in range(arr.shape[0]):
            out[p(f"encoder.layers.{i}.{theirs}")] = \
                arr[i].t() if transpose else arr[i]
    dev = patch.device
    out[p("post_layernorm.weight")] = torch.ones(h, device=dev)
    out[p("post_layernorm.bias")] = torch.zeros(h, device=dev)
    return out


# ---------------------------------------------------------------------------
# Valley extras
# ---------------------------------------------------------------------------

def convert_projector(sd: Mapping[str, Any], dtype=torch.bfloat16,
                      device=None, prefix: str = "model.mm_projector."
                      ) -> Dict[str, torch.Tensor]:
    """``mm_projector`` Linear -> {"w": (in, out), "b": (out,)}."""
    sd2 = _strip_prefix(sd, prefix)
    return {"w": _put(sd2["weight"], dtype, device).t().contiguous(),
            "b": _put(sd2["bias"], dtype, device)}


# the reference's names of the temporal encoder layer's tensors (torch
# ``nn.TransformerEncoderLayer``), under TEMPORAL_PREFIX; True: a Linear
# weight, stored (in, out) here and (out, in) there
TEMPORAL_PREFIX = "model.transformer_delta_encoder.layers.0."
TEMPORAL_KEYS = {
    "wo": ("self_attn.out_proj.weight", True),
    "bo": ("self_attn.out_proj.bias", False),
    "ln1_scale": ("norm1.weight", False), "ln1_bias": ("norm1.bias", False),
    "ln2_scale": ("norm2.weight", False), "ln2_bias": ("norm2.bias", False),
    "ffn1": ("linear1.weight", True), "ffn1_bias": ("linear1.bias", False),
    "ffn2": ("linear2.weight", True), "ffn2_bias": ("linear2.bias", False),
}


def convert_temporal(sd: Mapping[str, Any], cfg: C.ValleyConfig,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """The pooling variant's weights from a Valley state dict
    (``hf_bridge.py:222-250``): none for mean and max; importance pooling's
    ``model.pooling_layer`` Linear as ``pooling_w`` (P H, 1) and
    ``pooling_b``; the transformer's encoder layer with its fused
    ``in_proj`` split into q, k and v, each Linear (in, out), and
    ``model.position_matrix`` (the sinusoidal table where the checkpoint
    has none)."""
    method = cfg.patch_pooling_method
    if method in ("mean", "max"):
        return {}
    if method == "temporal_importance":
        return {"pooling_w": _put(sd["model.pooling_layer.weight"], dtype,
                                  device).t().contiguous(),
                "pooling_b": _put(sd["model.pooling_layer.bias"], dtype,
                                  device)}
    p = TEMPORAL_PREFIX
    in_w = _put(sd[p + "self_attn.in_proj_weight"], dtype, device)  # (3H, H)
    in_b = _put(sd[p + "self_attn.in_proj_bias"], dtype, device)
    h = in_w.shape[1]
    out = {}
    for i, n in enumerate("qkv"):
        out["w" + n] = in_w[i * h:(i + 1) * h].t().contiguous()
        out["b" + n] = in_b[i * h:(i + 1) * h].clone()
    for ours, (theirs, transpose) in TEMPORAL_KEYS.items():
        t = _put(sd[p + theirs], dtype, device)
        out[ours] = t.t().contiguous() if transpose else t
    if "model.position_matrix" in sd:
        out["position_matrix"] = _put(sd["model.position_matrix"], dtype,
                                      device)
    else:
        out["position_matrix"] = temporal.sinusoidal_position_matrix(
            cfg.temporal_pos_len, h).to(device=device, dtype=dtype)
    return out


def export_temporal(tp: temporal.TemporalWeights
                    ) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_temporal` (``hf_bridge.py:364-383``): the
    reference's names, Linear weights (out, in), q, k and v fused into
    ``in_proj``."""
    if "pooling_w" in tp:
        return {"model.pooling_layer.weight": tp["pooling_w"].data.t(),
                "model.pooling_layer.bias": tp["pooling_b"].data}
    if "wq" not in tp:
        return {}
    p = TEMPORAL_PREFIX
    out = {p + "self_attn.in_proj_weight": torch.cat(
               [tp["w" + n].data.t() for n in "qkv"]),
           p + "self_attn.in_proj_bias": torch.cat(
               [tp["b" + n].data for n in "qkv"]),
           "model.position_matrix": tp["position_matrix"].data}
    for ours, (theirs, transpose) in TEMPORAL_KEYS.items():
        t = tp[ours].data
        out[p + theirs] = t.t() if transpose else t
    return out


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------

def export_valley_checkpoint(cfg: C.ValleyConfig, params: valley.ValleyWeights,
                             out_dir: str, tokenizer_src: Optional[str] = None,
                             dtype=torch.float32,
                             max_shard_bytes: Optional[int] = None) -> int:
    """Write an HF-layout checkpoint directory of the port's unfused,
    unquantized weights (the JAX ``export_valley_checkpoint``,
    ``hf_bridge.py:345``): ``model.*`` / ``lm_head`` /
    ``model.mm_projector.*`` / ``model.vision_tower.vision_model.*`` tensors
    in ``dtype`` (float32 by default, as the JAX exporter writes; bfloat16
    halves the files), sharded into files of at most ``max_shard_bytes``
    with an index, a ``config.json`` with the Valley flags, and the
    tokenizer files of ``tokenizer_src``.  The tensors are moved to the host
    one at a time.  Returns the bytes of weights written."""
    os.makedirs(out_dir, exist_ok=True)
    sd = export_llama(params["llama"])
    proj = params["projector"]
    sd["model.mm_projector.weight"] = proj["w"].data.t()
    sd["model.mm_projector.bias"] = proj["b"].data
    sd.update(export_clip(params["vision"], prefix="model.vision_tower."))
    sd.update(export_temporal(params["temporal"]))
    written = save_sharded(sd, out_dir, max_shard_bytes, dtype)
    t = cfg.text
    hf_cfg = {
        "architectures": ["ValleyLlamaForCausalLM"],
        "model_type": "valley",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.kv_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "use_mm_proj": True,
        "mm_hidden_size": cfg.vision.hidden_size,
        "mm_vision_select_layer": cfg.vision.select_layer,
        "mm_use_im_start_end": True,
        "use_patch_importance_pooling":
            cfg.patch_pooling_method == "temporal_importance",
        "use_delta_transformer":
            cfg.patch_pooling_method == "temporal_transformer",
        "torch_dtype": str(dtype).replace("torch.", ""),
        # the tower's shape, in HF CLIPVisionConfig's keys
        "vision_config": {k: getattr(cfg.vision, k) for k in VISION_KEYS},
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    if tokenizer_src and os.path.isdir(tokenizer_src):
        for fname in ("tokenizer.model", "tokenizer.json",
                      "tokenizer_config.json", "special_tokens_map.json"):
            src = os.path.join(tokenizer_src, fname)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(out_dir, fname))
    return written


def resize_token_embeddings(llama_params: Mapping[str, torch.Tensor],
                            new_vocab: int,
                            num_new_init: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """Grow (or shrink) ``embed`` (V, H) and ``lm_head`` (H, V) to
    ``new_vocab`` rows, new rows the mean of the old ones (``hf_bridge.py:
    428``; ``initialize_vision_tokenizer``, ``valley_model.py:354-379``).
    The mean is taken in float64 and rounded to float32, then to the
    weights' dtype.  Returns a new dict; the other entries are kept."""
    embed, head = llama_params["embed"], llama_params["lm_head"]
    old = embed.shape[0]
    out = dict(llama_params)
    if new_vocab == old:
        return out
    if new_vocab < old:
        out["embed"] = embed[:new_vocab].clone()
        out["lm_head"] = head[:, :new_vocab].clone()
        return out
    num_new = new_vocab - old
    e_mean = embed.double().mean(dim=0, keepdim=True).float()
    h_mean = head.double().mean(dim=1, keepdim=True).float()
    out["embed"] = torch.cat([embed, e_mean.expand(num_new, -1).to(
        embed.dtype)])
    out["lm_head"] = torch.cat([head, h_mean.expand(-1, num_new).to(
        head.dtype)], dim=1)
    return out


def text_config_from_hf(hf_cfg: Mapping[str, Any]) -> C.TextConfig:
    return C.TextConfig(
        vocab_size=hf_cfg.get("vocab_size", 32000),
        hidden_size=hf_cfg.get("hidden_size", 4096),
        intermediate_size=hf_cfg.get("intermediate_size", 11008),
        num_hidden_layers=hf_cfg.get("num_hidden_layers", 32),
        num_attention_heads=hf_cfg.get("num_attention_heads", 32),
        num_key_value_heads=hf_cfg.get("num_key_value_heads"),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 2048),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
    )


def _checkpoint_tokenizer(path: str, model_max_length: int):
    """The checkpoint's own tokenizer, through ``transformers``."""
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {path} needs the `transformers` "
            "package, which is not installed; pass a tokenizer to "
            "load_valley_checkpoint(tokenizer=...) instead (the loader "
            "never falls back to another tokenizer on its own)") from e
    from valley_tpu_torch.tokenizer import load_hf_tokenizer

    return load_hf_tokenizer(path, model_max_length)


def tokens_of(tokenizer) -> C.SpecialTokens:
    """The multimodal marker ids of a tokenizer: its own ``special_tokens()``
    (`tokenizer.ByteFallbackTokenizer`), else read back from it as
    `tokenizer.load_hf_tokenizer` does."""
    if hasattr(tokenizer, "special_tokens"):
        return tokenizer.special_tokens()
    from valley_tpu_torch import constants as K

    ids = tokenizer.convert_tokens_to_ids
    return C.SpecialTokens(
        im_patch=ids(K.DEFAULT_IMAGE_PATCH_TOKEN),
        im_start=ids(K.DEFAULT_IM_START_TOKEN),
        im_end=ids(K.DEFAULT_IM_END_TOKEN),
        vi_frame=ids(K.DEFAULT_VIDEO_FRAME_TOKEN),
        vi_start=ids(K.DEFAULT_VI_START_TOKEN),
        vi_end=ids(K.DEFAULT_VI_END_TOKEN),
        pad=tokenizer.pad_token_id, bos=tokenizer.bos_token_id,
        eos=tokenizer.eos_token_id,
        unk=tokenizer.unk_token_id if tokenizer.unk_token_id is not None
        else 0)


def _vocab(tokenizer) -> int:
    return len(tokenizer) if hasattr(tokenizer, "__len__") \
        else tokenizer.vocab_size


def load_valley_checkpoint(path: str, vision_tower: Optional[str] = None,
                           select_layer: int = -2, pooling: str = "mean",
                           dtype=torch.bfloat16,
                           model_max_length: int = 2048,
                           quantize: Optional[str] = None,
                           quantize_group_size: int = 128,
                           fused: bool = False, tokenizer=None,
                           device=None):
    """Load a Valley (or plain LLaMA) HF checkpoint directory onto
    ``device`` (default the card).  Returns (ValleyConfig, ValleyWeights,
    tokenizer), as the JAX ``load_valley_checkpoint`` (``hf_bridge.py:473``)
    returns its tree.

    The vision tower comes from the checkpoint (``model.vision_tower.*``),
    else from the CLIP directory ``vision_tower``, else random weights (the
    port's own draw from seed 0, not JAX's); the projector from
    ``model.mm_projector.*``, else zeros; the checkpoint's
    ``mm_vision_select_layer`` overrides ``select_layer``.  The tower is
    CLIP ViT-L/14, Valley's, unless a ``vision_config`` entry of
    config.json (HF CLIPVisionConfig's keys, as `export_valley_checkpoint`
    writes it) gives another shape.

    The tokenizer: ``tokenizer`` if given (for example a
    `ByteFallbackTokenizer` for a checkpoint of random weights), else the
    checkpoint's own through ``transformers`` (an ImportError naming the
    package where it is missing).  The embedding and ``lm_head`` follow the
    checkpoint's tokenizer to its vocabulary, new rows the mean of the old
    (the Valley markers of a plain LLaMA base); a tokenizer passed by the
    caller only grows them, where it holds more ids than they have rows.

    ``quantize`` (a mode of `quant.QUANT_MODES`) quantizes on load, layer
    by layer on the card (module docstring), with ``quantize_group_size``
    for the grouped modes (the int8 modes stay per channel, as in JAX); ``fused`` takes the wqkv/w_gateup serving
    layout (before quantizing, as the worker's ``--fused`` does).
    """
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: load with device=\"cpu\" to "
                           "load on the CPU")
    if quantize is not None:
        quant.parse_quant_mode(quantize)      # refuse before reading
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    text_cfg = text_config_from_hf(hf_cfg)
    if hf_cfg.get("use_patch_importance_pooling"):
        pooling = "temporal_importance"
    if hf_cfg.get("use_delta_transformer"):
        pooling = "temporal_transformer"
    own_tokenizer = tokenizer is None
    if own_tokenizer:
        tokenizer, tokens = _checkpoint_tokenizer(path, model_max_length)
    else:
        tokens = tokens_of(tokenizer)
    select_layer = int(hf_cfg.get("mm_vision_select_layer", select_layer))
    vc = hf_cfg.get("vision_config") or {}
    vis_cfg = C.VisionConfig(**{k: vc[k] for k in VISION_KEYS if k in vc},
                             select_layer=select_layer)

    sd = read_state_dict(path)
    rows = sd[next(k for k in ("model.embed_tokens.weight",
                               "base_model.model.model.embed_tokens.weight")
                   if k in sd)].shape[0]
    tok_vocab = _vocab(tokenizer)
    new_vocab = None
    if tok_vocab != rows and (own_tokenizer or tok_vocab > rows):
        new_vocab = tok_vocab
        text_cfg = dataclasses.replace(text_cfg, vocab_size=new_vocab)
    cfg = C.ValleyConfig(text=text_cfg, vision=vis_cfg, tokens=tokens,
                         patch_pooling_method=pooling)

    if quantize is not None:
        lt = _quantized_llama(sd, text_cfg, dtype, device, fused, quantize,
                              quantize_group_size, new_vocab)
    else:
        lt = convert_llama(sd, text_cfg, dtype, device, fused)
        if new_vocab is not None:
            lt = resize_token_embeddings(lt, new_vocab)
    tower_sd = _strip_prefix({k: v for k, v in sd.items()
                              if "vision_tower." in k},
                             "model.vision_tower.")
    if any("vision_tower." in k for k in sd):
        vt = convert_clip(tower_sd, vis_cfg, dtype, device)
    elif vision_tower and os.path.isdir(vision_tower):
        vt = convert_clip(read_state_dict(vision_tower), vis_cfg, dtype,
                          device)
    else:
        vt = None
    if any("mm_projector" in k for k in sd):
        proj = convert_projector(sd, dtype, device)
    else:
        hl, hv = text_cfg.hidden_size, vis_cfg.hidden_size
        proj = {"w": torch.zeros((hv, hl), dtype=dtype, device=device),
                "b": torch.zeros((hl,), dtype=dtype, device=device)}
    tp = convert_temporal(sd, cfg, dtype, device)
    del sd
    if vt is None:
        vision = clip_vit.init_params(
            vis_cfg, torch.Generator(device).manual_seed(0), dtype, device)
    else:
        vision = clip_vit.ClipWeights({
            **{k: v for k, v in vt.items() if k != "layers"},
            "layers": clip_vit.ClipLayers(vt["layers"])})
    params = valley.ValleyWeights({
        "llama": llama.LlamaWeights({
            **{k: v for k, v in lt.items() if k != "layers"},
            "layers": llama.LlamaLayers(lt["layers"])}),
        "vision": vision,
        "projector": valley.Projector(proj),
        "temporal": temporal.TemporalWeights(tp),
    })
    return cfg, params, tokenizer
