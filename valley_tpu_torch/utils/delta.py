"""Weight deltas: distribute Valley weights as differences from a base LLaMA
checkpoint, the port's counterpart of ``valley_tpu/utils/delta.py`` on its
own safetensors reader and writer (`safetensors_io`).

Semantics of the JAX tools (and of the reference's ``make_delta.py`` /
``apply_delta.py``): elementwise subtract or add against the base state
dict in the stored dtype; ``model.embed_tokens.weight`` and
``lm_head.weight`` may have extra rows (the added special tokens), and
only the overlapping slice is differenced; projector, vision and pooling
weights pass through untouched.

Usage:
  python -m valley_tpu_torch.utils.delta make  --base-model-path B \
      --target-model-path T --delta-path D
  python -m valley_tpu_torch.utils.delta apply --base-model-path B \
      --delta-path D --target-model-path T
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Dict

import torch

from valley_tpu_torch.utils.safetensors_io import read_state_dict, save_file

logger = logging.getLogger(__name__)

PASS_THROUGH_MARKERS = ("mm_projector", "vision_tower", "pooling_layer",
                        "transformer_delta_encoder", "position_matrix")
RESIZABLE = ("model.embed_tokens.weight", "lm_head.weight")


def _combine(target_sd: Dict[str, torch.Tensor],
             base_sd: Dict[str, torch.Tensor], sign: int
             ) -> Dict[str, torch.Tensor]:
    out = {}
    for name, param in target_sd.items():
        if name not in base_sd:
            if not any(m in name for m in PASS_THROUGH_MARKERS):
                raise KeyError(f"{name} not in base model")
            out[name] = param
            continue
        bparam = base_sd[name]
        if param.shape == bparam.shape:
            out[name] = param + sign * bparam
        else:
            if name not in RESIZABLE:
                raise ValueError(f"{name} dimension mismatch: "
                                 f"{tuple(param.shape)} vs "
                                 f"{tuple(bparam.shape)}")
            merged = param.clone()
            merged[:bparam.shape[0], :bparam.shape[1]] += sign * bparam
            out[name] = merged
    return out


def _save_sd(path: str, sd: Dict[str, torch.Tensor], src_dir: str) -> None:
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    # carry over config and tokenizer files so the result is loadable
    for fname in ("config.json", "tokenizer.model", "tokenizer.json",
                  "tokenizer_config.json", "special_tokens_map.json",
                  "generation_config.json"):
        src = os.path.join(src_dir, fname)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(path, fname))


def make_delta(base_model_path: str, target_model_path: str,
               delta_path: str) -> None:
    logger.info("Loading base model")
    base_sd = read_state_dict(base_model_path)
    logger.info("Loading target model")
    target_sd = read_state_dict(target_model_path)
    logger.info("Calculating delta")
    delta = _combine(target_sd, base_sd, sign=-1)
    _save_sd(delta_path, delta, target_model_path)
    logger.info("Saved delta to %s", delta_path)


def apply_delta(base_model_path: str, delta_path: str,
                target_model_path: str) -> None:
    logger.info("Loading base model")
    base_sd = read_state_dict(base_model_path)
    logger.info("Loading delta")
    delta_sd = read_state_dict(delta_path)
    logger.info("Applying delta")
    target = _combine(delta_sd, base_sd, sign=+1)
    _save_sd(target_model_path, target, delta_path)
    logger.info("Saved target model to %s", target_model_path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("--base-model-path", required=True)
    mk.add_argument("--target-model-path", required=True)
    mk.add_argument("--delta-path", required=True)
    ap = sub.add_parser("apply")
    ap.add_argument("--base-model-path", required=True)
    ap.add_argument("--delta-path", required=True)
    ap.add_argument("--target-model-path", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cmd == "make":
        make_delta(args.base_model_path, args.target_model_path,
                   args.delta_path)
    else:
        apply_delta(args.base_model_path, args.delta_path,
                    args.target_model_path)


if __name__ == "__main__":
    main()
