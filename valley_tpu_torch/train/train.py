"""Training entry point of the PyTorch port: a YAML experiment config ->
the Valley recipe on one device.

    python -m valley_tpu_torch.train.train --conf <yaml> [--device cuda|cpu]

Reads the same YAML keys as ``valley_tpu/train/train.py`` (model, data and
training arguments) with the same meaning.  ``model_name_or_path`` may be
``random:*`` (or ``model_size``) for random weights from a seed, with the
same rules as the JAX entry point, or the output directory of an earlier
run of this entry point (``valley_config.json``, ``valley_meta.json`` and
``final/``), which is how stage 2 starts from stage 1.  The device is the
card unless ``--device cpu`` is given; nothing falls back to the CPU.

Not ported yet, and refused with NotImplementedError: Hugging Face
checkpoint directories, LoRA, ``export_hf``, ``predict_with_generate`` and
``evaluation_strategy: steps`` (see also `trainer.check_ported`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.data.dataset import (DataLoader,
                                           make_video_supervised_data_module)
from valley_tpu_torch.models import valley
from valley_tpu_torch.train.trainer import TrainConfig, Trainer
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.weights import from_state_dict

logger = logging.getLogger(__name__)


@dataclass
class ModelArguments:
    model_name_or_path: str = ""
    vision_tower: Optional[str] = None
    mm_vision_select_layer: int = -1
    pretrain_mm_mlp_adapter: Optional[str] = None
    mm_use_im_start_end: bool = False
    tune_llm_layer: Optional[str] = None
    patch_pooling_method: str = "mean"
    use_patch_importance_pooling: bool = False
    use_delta_transformer: bool = False
    model_size: str = "7b"          # "7b" | "13b" | "tiny"


@dataclass
class DataArguments:
    data_path: Optional[str] = None
    fashion_data_path: Optional[str] = None
    video_data_path: Optional[str] = None
    lazy_preprocess: bool = False
    is_multimodal: bool = False
    sep_image_conv_front: bool = False
    image_token_len: int = 0
    eval_num: int = 400
    image_folder: Optional[str] = None
    video_folder: Optional[str] = None
    fashion_image_folder: Optional[str] = None
    image_aspect_ratio: str = "square"
    num_image: int = 4
    multi_image: bool = True
    multi_image_mode: str = "concatenate"
    use_fashion: bool = False
    fast_epoch: bool = False
    conv_mode: str = "v1"
    only_mask_system: bool = False
    project_name: str = "valley"
    num_frames: int = 8


def load_yaml_config(path: str):
    """(model_args, data_args, train_config, extra) from a recipe YAML;
    ``extra`` holds model_max_length, bf16, fp16 and rope_scaling."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    def fill(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    model_args = fill(ModelArguments)
    data_args = fill(DataArguments)
    tc = fill(TrainConfig)
    tc = dataclasses.replace(tc, learning_rate=float(tc.learning_rate))
    extra = {k: v for k, v in raw.items()
             if k in ("model_max_length", "bf16", "fp16", "rope_scaling")}
    return model_args, data_args, tc, extra


def resolve_pooling(model_args: ModelArguments) -> str:
    """The temporal pooling method from the flags (train.py:28-29)."""
    if model_args.use_delta_transformer:
        return "temporal_transformer"
    if model_args.use_patch_importance_pooling:
        return "temporal_importance"
    return model_args.patch_pooling_method or "mean"


def load_framework_checkpoint(path: str, model_max_length: int, device,
                              dtype):
    """(cfg, params, tokenizer) from the output directory of an earlier
    run of this entry point."""
    with open(os.path.join(path, "valley_config.json")) as f:
        cfg = C.ValleyConfig.from_json(f.read())
    meta = {}
    meta_path = os.path.join(path, "valley_meta.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if meta.get("lora"):
        raise NotImplementedError(f"{path} is a LoRA output; LoRA is not "
                                  "ported yet")
    state = ckpt_lib.restore_pytree(
        os.path.join(path, meta.get("final", "final")), map_location="cpu")
    params = from_state_dict(state, device, dtype)
    from valley_tpu_torch.tokenizer import (ByteFallbackTokenizer,
                                            load_hf_tokenizer)

    tok_path = meta.get("tokenizer_path", "")
    if tok_path and os.path.isdir(tok_path):
        tokenizer, tokens = load_hf_tokenizer(tok_path, model_max_length)
        cfg = cfg.replace(tokens=tokens)
    else:
        tokenizer = ByteFallbackTokenizer(model_max_length=model_max_length)
        cfg = cfg.replace(tokens=tokenizer.special_tokens())
    return cfg, params, tokenizer


def build_model_and_tokenizer(model_args: ModelArguments, extra: dict,
                              device, dtype=torch.bfloat16, seed: int = 0):
    """(cfg, params, tokenizer): an earlier run's output directory, or
    random weights from ``seed`` with the rules of train.py:164-175 (the
    tiny configuration for ``model_size: tiny`` or any ``random*`` path,
    else LLaMA-2 7B or 13B by ``model_size``)."""
    pooling = resolve_pooling(model_args)
    path = model_args.model_name_or_path
    max_len = int(extra.get("model_max_length", 2048))

    if path and os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "valley_config.json")):
            return load_framework_checkpoint(path, max_len, device, dtype)
        raise NotImplementedError(
            f"{path}: loading Hugging Face checkpoints is not ported yet")

    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    tokenizer = ByteFallbackTokenizer(model_max_length=max_len)
    if model_args.model_size == "tiny" or path.startswith("random"):
        cfg = C.valley_tiny(patch_pooling_method=pooling)
    else:
        base = C.LLAMA2_13B if "13" in model_args.model_size else C.LLAMA2_7B
        cfg = C.ValleyConfig(text=base, patch_pooling_method=pooling)
    cfg = cfg.replace(tokens=tokenizer.special_tokens())
    params = valley.init_params(
        cfg, torch.Generator(device).manual_seed(seed), dtype, device)
    if model_args.pretrain_mm_mlp_adapter:
        proj = ckpt_lib.restore_pytree(model_args.pretrain_mm_mlp_adapter,
                                       map_location=device)
        params["projector"].load_state_dict(proj)
    return cfg, params, tokenizer


def _refuse_unported(tc: TrainConfig) -> None:
    for flag, what in ((tc.export_hf, "export_hf (the Hugging Face export)"),
                       (tc.predict_with_generate, "predict_with_generate"),
                       (tc.evaluation_strategy == "steps",
                        "evaluation_strategy: steps")):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")


def train(conf_path: str, device: str = "cuda") -> int:
    """Train by the recipe in ``conf_path`` on ``device``; writes
    ``final/``, ``valley_config.json`` and ``valley_meta.json`` under
    ``output_dir``.  Returns the number of optimizer updates."""
    model_args, data_args, tc, extra = load_yaml_config(conf_path)
    _refuse_unported(tc)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    dtype = torch.bfloat16 if extra.get("bf16", True) else torch.float32
    cfg, params, tokenizer = build_model_and_tokenizer(model_args, extra,
                                                       device, dtype)
    rs = float(extra.get("rope_scaling", 1.0))
    if rs != 1.0:
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, rope_scaling=rs))

    data_args.is_multimodal = data_args.is_multimodal or \
        model_args.vision_tower is not None
    data_args.mm_use_im_start_end = model_args.mm_use_im_start_end
    data_args.crop_size = cfg.vision.image_size
    data_args.scale_size = max(cfg.vision.image_size * 256 // 224,
                               cfg.vision.image_size)
    data_args.patch_size = cfg.vision.patch_size
    module = make_video_supervised_data_module(tokenizer, data_args)
    loader = DataLoader(module["train_dataset"],
                        tc.per_device_train_batch_size,
                        module["data_collator"], seed=tc.seed)

    trainer = Trainer(cfg, tc, params, loader)
    n_train = sum(p.numel() for p in params.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in params.parameters())
    logger.info("trainable params: %d of %d (%.4f%%)", n_train, n_all,
                100.0 * n_train / n_all)
    step = trainer.train(resume=True)

    final_dir = os.path.join(tc.output_dir, "final")
    ckpt_lib.save_pytree(final_dir, params.state_dict())
    with open(os.path.join(tc.output_dir, "valley_config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(tc.output_dir, "valley_meta.json"), "w") as f:
        json.dump({"lora": False,
                   "tokenizer_path": model_args.model_name_or_path,
                   "final": "final"}, f)
    logger.info("training done at step %d; saved to %s", step, final_dir)
    return step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train(args.conf, args.device)


if __name__ == "__main__":
    main()
