"""Offline one-shot video Q&A on the PyTorch port.

python -m valley_tpu_torch.inference.run_valley --model-name random:tiny \
    --video-file v.mp4 --query "Describe the video." \
    [--quantize int8a8|int4gp --fused --kv-cache int8] [--device cpu]

``random:tiny`` builds the tiny test configuration with random weights and
the byte tokenizer.  Loading a Hugging Face Valley checkpoint is not ported
yet (the JAX package's loader, ``valley_tpu.utils.hf_bridge``, imports jax).
It runs on the card; without one it stops unless ``--device cpu`` is
given.  ``--fused``, ``--quantize`` and ``--kv-cache`` are the serving
worker's options (``valley_tpu/serve/model_worker.py``), applied in its
order: fuse, then quantize (and pack int4), then choose the cache.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.inference.engine import Engine, GenerationConfig
from valley_tpu_torch.inference.generate import completion
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops.quant import (SERVED_MODES, parse_quant_mode,
                                        quantize_llama_params)

DEFAULT_SYSTEM_PROMPT = (
    "You are Valley, a large language and vision assistant trained by "
    "ByteDance. You are able to understand the visual content or video "
    "that the user provides, and assist the user with a variety of "
    "tasks using natural language. Follow the instructions carefully "
    "and explain your answers in detail.")


def load_model(model_name: str, device: Optional[str] = None,
               buckets=(512, 1024, 2048), max_new_tokens: int = 1024,
               quantize: Optional[str] = None, fused: bool = False,
               kv_cache: str = "bf16", steps_per_call: int = 4,
               decode_ramp=()):
    """Build (engine, tokenizer) on ``device`` (default the card; without
    one this raises unless the caller asks for ``"cpu"``).  ``fused`` takes
    the fused serving layout, ``quantize`` (a mode of
    ``quant.SERVED_MODES``: ``int8``, ``int8a8``, ``int4``, ``int4g``,
    ``int4gp``) the quantized weights, ``kv_cache="int8"`` the int8 KV
    cache; ``steps_per_call`` and ``decode_ramp`` set the engine's decode
    chunks.  At the tiny widths (64, 128) group-128 scales fall back to per
    channel where 128 does not divide the contraction axis, as in JAX."""
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device="
                           "\"cpu\") to run on the CPU")
    if kv_cache not in ("bf16", "int8"):
        raise ValueError(f"kv_cache must be bf16 or int8, got {kv_cache!r}")
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
    if fused:
        params = llama.fuse_llama_params(params)
    if quantize:
        knobs = parse_quant_mode(quantize)
        params = quantize_llama_params(params, act8=knobs["act8"],
                                       bits=knobs["bits"],
                                       group_size=knobs["group_size"])
    engine = Engine(cfg, params, buckets=buckets,
                    max_new_tokens=max_new_tokens,
                    cache_dtype=torch.int8 if kv_cache == "int8"
                    else torch.bfloat16, steps_per_call=steps_per_call,
                    decode_ramp=decode_ramp)
    return engine, tokenizer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-name", type=str, required=True)
    parser.add_argument("--video-file", type=str, required=True)
    parser.add_argument("--query", type=str,
                        default="Describe the video concisely.")
    parser.add_argument("--system-prompt", type=str,
                        default=DEFAULT_SYSTEM_PROMPT)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=list(SERVED_MODES),
                        help="quantized decoder weights: per-channel "
                             "int8 (int8a8 also runs W8A8 prefill), or "
                             "nibble-packed int4 per channel (int4) or with "
                             "group-128 scales (int4g, int4gp)")
    parser.add_argument("--kv-cache", type=str, default="bf16",
                        choices=["bf16", "int8"],
                        help="KV-cache dtype")
    parser.add_argument("--fused", action="store_true",
                        help="fused wqkv/w_gateup layout (4 GEMVs per "
                             "layer instead of 7)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--do-sample", action="store_true")
    args = parser.parse_args(argv)

    engine, tokenizer = load_model(args.model_name, args.device,
                                   max_new_tokens=args.max_new_tokens,
                                   quantize=args.quantize, fused=args.fused,
                                   kv_cache=args.kv_cache)
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
