"""Training entry point of the PyTorch port: a YAML experiment config ->
the Valley recipe on one device, or on one process per device under
torchrun:

    python -m valley_tpu_torch.train.train --conf <yaml> [--device cuda|cpu]
    torchrun --nproc_per_node N -m valley_tpu_torch.train.train --conf <yaml>

Under torchrun (its environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) each process drives ``cuda:LOCAL_RANK``
(NCCL; gloo with ``--device cpu``) on the recipe's mesh (``mesh_data``,
``mesh_fsdp``, ``mesh_model``; -1 infers an axis from the world, as JAX
infers it from the devices): the decoder cut Megatron-style over
``model`` (tensor parallelism, `parallel/tensor.py`), each rank's share of
the weights and AdamW's state sharded again over ``fsdp`` (ZeRO-3,
`parallel/sharding.py`), the global batch ``per_device_train_batch_size x
data x fsdp`` split over the batch world, each rank loading only its rows
(the ranks of one ``model`` group the same rows) with the collator's
padded geometry fixed (JAX train.py:211-223).  Rank 0 writes the logs,
``final/``, ``valley_config.json``, ``valley_meta.json`` and ``hf/``; the
process group comes down at the end (`distributed.shutdown`, its seconds
logged).  Without torchrun's environment the recipe runs in one process
with no process group, and a mesh larger than one device is refused as
JAX refuses it.

Reads the same YAML keys as ``valley_tpu/train/train.py`` (model, data and
training arguments) with the same meaning.  ``model_name_or_path`` may be
``random:*`` (or ``model_size``) for random weights from a seed, with the
same rules as the JAX entry point, a Hugging Face checkpoint directory
(`hf_bridge.load_valley_checkpoint`), or the output directory of an
earlier run of this entry point (``valley_config.json``,
``valley_meta.json`` and ``final/``), which is how stage 2 starts from
stage 1.  The device is the card unless ``--device cpu`` is given;
nothing falls back to the CPU.

Stage 2 as the recipes run it: ``lora: true`` adds adapters
(`train/lora.py`) after the weights are built and writes an adapter-only
``final`` (serve it with ``--lora-path <output_dir>/final`` over the base
checkpoint); ``export_hf`` writes a Hugging Face checkpoint under
``<output_dir>/hf`` (not with LoRA); ``evaluation_strategy: steps`` runs
the generate-eval (`train/eval_loop.py`) every ``eval_steps`` updates and
``predict_with_generate`` once after training, over the first
``eval_num`` training samples (on a mesh: on rank 0, over the gathered
tree).  Refused with NotImplementedError: the options of
`trainer.check_ported`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.data.dataset import (DataLoader,
                                           make_video_supervised_data_module)
from valley_tpu_torch.models import valley
from valley_tpu_torch.parallel import distributed, sharding
from valley_tpu_torch.parallel.mesh import create_mesh, mesh_sizes
from valley_tpu_torch.train import lora as lora_lib
from valley_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                            check_ported, label_params)
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.utils.logging import (print_trainable_params,
                                            rank_zero_info)
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
        raise ValueError(
            f"{path} is a LoRA output (adapter-only). Load the base "
            f"checkpoint and pass lora_path={path}/final instead.")
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
    """(cfg, params, tokenizer): an earlier run's output directory, a
    Hugging Face checkpoint directory (train.py:152-161), or random weights
    from ``seed`` with the rules of train.py:164-175 (the tiny
    configuration for ``model_size: tiny`` or any ``random*`` path, else
    LLaMA-2 7B or 13B by ``model_size``)."""
    pooling = resolve_pooling(model_args)
    path = model_args.model_name_or_path
    max_len = int(extra.get("model_max_length", 2048))

    if path and os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "valley_config.json")):
            return load_framework_checkpoint(path, max_len, device, dtype)
        from valley_tpu_torch.utils import hf_bridge

        return hf_bridge.load_valley_checkpoint(
            path, vision_tower=model_args.vision_tower,
            select_layer=model_args.mm_vision_select_layer,
            pooling=pooling, dtype=dtype, model_max_length=max_len,
            device=device)

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


def refresh_weights(dst: valley.ValleyWeights,
                    src: valley.ValleyWeights) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place: an engine's CUDA
    graphs replay the tensors they captured, so its weights are refilled,
    never replaced (tensors the two trees share are left alone)."""
    with torch.no_grad():
        for (name, d), (_, s) in zip(dst.named_parameters(),
                                     src.named_parameters()):
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)


def _eval_engine(cfg, params, tokenizer, max_new_tokens: int):
    from valley_tpu_torch.inference.engine import Engine

    max_len = getattr(tokenizer, "model_max_length", 2048)
    return Engine(cfg, params, buckets=(min(1024, max_len), max_len),
                  max_new_tokens=max_new_tokens)


class StepEval:
    """The generate-eval of ``evaluation_strategy: steps``
    (train.py:233-258): greedy replies of up to 128 tokens to the first
    ``eval_num`` samples of ``dataset``, through one engine kept across
    evals (its decode graphs stay captured) whose weights are refilled in
    place (`refresh_weights`) with the trainer's, adapters merged."""

    def __init__(self, cfg, tc: TrainConfig, tokenizer, dataset,
                 conv_mode: str = "v1"):
        self.cfg, self.tc, self.tokenizer = cfg, tc, tokenizer
        self.dataset, self.conv_mode = dataset, conv_mode
        self.engine = None

    def __call__(self, params: valley.ValleyWeights, step: int) -> dict:
        from valley_tpu_torch.inference.engine import GenerationConfig
        from valley_tpu_torch.train.eval_loop import generate_eval

        p = lora_lib.merge_lora(params) if self.tc.lora else params
        if self.engine is None:
            self.engine = _eval_engine(self.cfg, p, self.tokenizer, 256)
        else:
            refresh_weights(self.engine.params, p)
        del p
        return generate_eval(
            self.engine, self.tokenizer, self.dataset,
            eval_num=self.tc.eval_num, conv_mode=self.conv_mode,
            gen=GenerationConfig(max_new_tokens=128, do_sample=False))


def train(conf_path: str, device: str = "cuda") -> int:
    """Train by the recipe in ``conf_path`` on ``device``; writes
    ``final/`` (adapter-only with LoRA), ``valley_config.json`` and
    ``valley_meta.json`` under ``output_dir``, and ``hf/`` with
    ``export_hf``.  Returns the number of optimizer updates."""
    model_args, data_args, tc, extra = load_yaml_config(conf_path)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    check_ported(tc)
    grouped = distributed.initialize(device=device)
    device = distributed.device_for(device)
    data, fsdp, _ = mesh_sizes(tc.mesh_data, tc.mesh_fsdp, tc.mesh_model,
                               distributed.process_count())
    mesh = create_mesh(tc.mesh_data, tc.mesh_fsdp, tc.mesh_model,
                       device.type) if grouped else None
    rank0 = distributed.process_index() == 0
    dtype = torch.bfloat16 if extra.get("bf16", True) else torch.float32
    cfg, params, tokenizer = build_model_and_tokenizer(model_args, extra,
                                                       device, dtype)
    rs = float(extra.get("rope_scaling", 1.0))
    if rs != 1.0:
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, rope_scaling=rs))
    if tc.lora:
        params = lora_lib.add_lora(
            params, torch.Generator(device).manual_seed(1), r=tc.lora_r,
            alpha=tc.lora_alpha, dtype=dtype)

    data_args.is_multimodal = data_args.is_multimodal or \
        model_args.vision_tower is not None
    data_args.mm_use_im_start_end = model_args.mm_use_im_start_end
    data_args.crop_size = cfg.vision.image_size
    data_args.scale_size = max(cfg.vision.image_size * 256 // 224,
                               cfg.vision.image_size)
    data_args.patch_size = cfg.vision.patch_size
    module = make_video_supervised_data_module(tokenizer, data_args)
    if distributed.process_count() > 1:
        # the ranks' batches must agree on shape without seeing each
        # other's samples: fix the collator's padded geometry
        coll = module["data_collator"]
        coll.pad_to_length = coll.max_length
        coll.pad_frames_to = data_args.num_frames
        coll.image_size = cfg.vision.image_size
    # per-device batch (torchrun's semantics): the global batch scales
    # with the data-parallel ranks, and each rank loads its rows of it
    loader = DataLoader(module["train_dataset"],
                        tc.per_device_train_batch_size * data * fsdp,
                        module["data_collator"], seed=tc.seed,
                        process_index=sharding.batch_rank(mesh)
                        if mesh is not None else 0,
                        process_count=data * fsdp)

    step_eval = StepEval(cfg, tc, tokenizer, module["train_dataset"],
                         data_args.conv_mode) \
        if tc.evaluation_strategy == "steps" else None
    print_trainable_params(params, label_params(params, tc))
    trainer = Trainer(cfg, tc, params, loader, eval_fn=step_eval, mesh=mesh)
    step = trainer.train(resume=True)
    trainer.eval_fn = step_eval = None     # frees the eval engine
    if mesh is not None:
        params = sharding.gather_params(params)
    if not rank0:
        distributed.barrier()    # rank 0 writes and evaluates
        return step

    final_dir = os.path.join(tc.output_dir, "final")
    if tc.lora:
        ckpt_lib.save_pytree(final_dir, lora_lib.split_lora(params))
    else:
        ckpt_lib.save_pytree(final_dir, params.state_dict())
    with open(os.path.join(tc.output_dir, "valley_config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(tc.output_dir, "valley_meta.json"), "w") as f:
        json.dump({"lora": bool(tc.lora),
                   "tokenizer_path": model_args.model_name_or_path,
                   "final": "final"}, f)
    if tc.export_hf and not tc.lora:
        from valley_tpu_torch.utils.hf_bridge import export_valley_checkpoint

        hf_dir = os.path.join(tc.output_dir, "hf")
        tok_src = model_args.model_name_or_path \
            if os.path.isdir(model_args.model_name_or_path) else None
        export_valley_checkpoint(cfg, params, hf_dir, tokenizer_src=tok_src)
        rank_zero_info(f"HF export written to {hf_dir}", logger)
    rank_zero_info(f"training done at step {step}; saved to {final_dir}",
                   logger)

    # the generate-eval after training, over the first eval_num training
    # samples (train.py:293-315)
    if tc.predict_with_generate and len(module["train_dataset"]):
        from valley_tpu_torch.inference.engine import GenerationConfig
        from valley_tpu_torch.train.eval_loop import generate_eval

        params_eval = lora_lib.merge_lora(params) if tc.lora else params
        engine = _eval_engine(cfg, params_eval, tokenizer,
                              min(tc.generation_max_length, 1024))
        pred_file = tc.prediction_file_name or os.path.join(
            tc.output_dir, "eval_result.jsonl")
        metrics = generate_eval(
            engine, tokenizer, module["train_dataset"],
            eval_num=tc.eval_num, conv_mode=data_args.conv_mode,
            prediction_file=pred_file,
            gen=GenerationConfig(max_new_tokens=256, do_sample=False))
        trainer.log({"step": step, **{f"eval_{k}": v
                                      for k, v in metrics.items()}})
    distributed.barrier()
    return step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        train(args.conf, args.device)
    finally:
        t0 = time.perf_counter()
        distributed.shutdown()
        logger.info("process group down in %.2f s", time.perf_counter() - t0)


if __name__ == "__main__":
    main()
