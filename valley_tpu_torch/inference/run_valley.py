"""Offline one-shot video Q&A on the PyTorch port.

python -m valley_tpu_torch.inference.run_valley --model-name random:tiny \
    --video-file v.mp4 --query "Describe the video."

``random:tiny`` builds the tiny test configuration with random weights and
the byte tokenizer.  Loading a Hugging Face Valley checkpoint is not ported
yet (the JAX package's loader, ``valley_tpu.utils.hf_bridge``, imports jax).
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.inference.engine import Engine, GenerationConfig
from valley_tpu_torch.inference.generate import completion
from valley_tpu_torch.models import valley

DEFAULT_SYSTEM_PROMPT = (
    "You are Valley, a large language and vision assistant trained by "
    "ByteDance. You are able to understand the visual content or video "
    "that the user provides, and assist the user with a variety of "
    "tasks using natural language. Follow the instructions carefully "
    "and explain your answers in detail.")


def load_model(model_name: str, device: Optional[str] = None,
               buckets=(512, 1024, 2048), max_new_tokens: int = 1024):
    """Build (engine, tokenizer) on ``device`` (default: the card if there
    is one, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if model_name != "random:tiny":
        raise NotImplementedError(
            f"cannot load {model_name!r}: loading Hugging Face Valley "
            "checkpoints is not ported to the PyTorch package yet; use "
            "--model-name random:tiny")
    from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

    tokenizer = ByteFallbackTokenizer()
    cfg = C.valley_tiny().replace(tokens=tokenizer.special_tokens())
    generator = torch.Generator(device).manual_seed(0)
    # bf16 on the card, where the kernels take bf16; fp32 on the CPU
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    params = valley.init_params(cfg, generator, dtype, device)
    engine = Engine(cfg, params, buckets=buckets,
                    max_new_tokens=max_new_tokens)
    return engine, tokenizer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-name", type=str, required=True)
    parser.add_argument("--video-file", type=str, required=True)
    parser.add_argument("--query", type=str,
                        default="Describe the video concisely.")
    parser.add_argument("--system-prompt", type=str,
                        default=DEFAULT_SYSTEM_PROMPT)
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--do-sample", action="store_true")
    args = parser.parse_args(argv)

    engine, tokenizer = load_model(args.model_name, args.device,
                                   max_new_tokens=args.max_new_tokens)
    messages = [
        {"role": "system", "content": args.system_prompt},
        {"role": "user", "content": args.query + " <video>"},
    ]
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           do_sample=args.do_sample)
    response = completion(engine, tokenizer, args.video_file, messages, gen)
    print(response[0])


if __name__ == "__main__":
    main()
