"""Offline one-shot video Q&A on the PyTorch port.

python -m valley_tpu_torch.inference.run_valley --model-name <dir> \
    --video-file v.mp4 --query "Describe the video." \
    [--quantize int8a8|int4gp|int4gpa8 --fused --kv-cache int8] \
    [--speculative] \
    [--device cpu]

``--model-name`` is a Hugging Face Valley checkpoint directory (read by
``utils/hf_bridge.py``, its tokenizer through ``transformers``; a
``--quantize`` mode quantizes on load), or ``random:tiny`` (the tiny test
configuration), ``random:7b`` or ``random:13b`` (Valley-7B/13B filled with
0.008, the JAX worker's perf weights) with the byte tokenizer.  It runs on
the card; without one it stops unless ``--device cpu`` is given.
``--fused``, ``--quantize`` and ``--kv-cache`` are the serving worker's
options (``valley_tpu/serve/model_worker.py``), applied in its
order: fuse, then quantize (and pack int4), then choose the cache.
``--speculative`` decodes by n-gram self-speculation
(``inference/speculative.py``).  ``--lora-path`` (a checkpoint directory's
base only) merges the adapter-only ``final`` of a LoRA run of
``train/train.py`` into the bf16 weights before any fusing or quantizing.
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
                                        quantize_llama_params,
                                        quantize_vision_params)

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
               decode_ramp=(), frame_buckets=None, raw_media: bool = False,
               vision_tower: Optional[str] = None, tokenizer=None,
               lora_path: Optional[str] = None,
               quantize_vision: Optional[str] = None, mesh=None):
    """Build (engine, tokenizer) on ``device`` (default the card; without
    one this raises unless the caller asks for ``"cpu"``).  ``model_name``
    is a checkpoint directory (`hf_bridge.load_valley_checkpoint`: its
    tower, else ``vision_tower``'s; its tokenizer, unless ``tokenizer`` is
    given) or a ``random:`` configuration (module docstring).
    ``fused`` takes the fused serving layout, ``quantize`` (a mode of
    ``quant.QUANT_MODES``: ``int8``, ``int8a8``, ``int4``, ``int4g``,
    ``int4gp``, ``int4ga8``, ``int4gpa8``) the quantized weights (a
    checkpoint quantizes on load), ``quantize_vision`` (``int8`` or
    ``int8a8``) the int8 CLIP tower (`quant.quantize_vision_params`, after
    the decoder, as the JAX worker orders them), ``kv_cache="int8"`` the
    int8 KV cache; ``steps_per_call`` and
    ``decode_ramp`` set the engine's decode chunks, ``frame_buckets`` and
    ``raw_media`` its media (`Engine`).  ``lora_path`` (with a checkpoint
    directory) is an adapter saved by the port's trainer: the checkpoint
    loads unquantized, the adapter is merged (`lora.merge_lora` of
    `lora.load_lora`), then the weights are fused and quantized as asked,
    in the JAX worker's order (model_worker.py:938-975).  Weights are bf16 on the card,
    where the kernels take bf16, and fp32 on the CPU.  At the tiny widths
    (64, 128) group-128 scales fall back to per channel where 128 does not
    divide the contraction axis, as in JAX.  ``mesh``: the engine's
    (`Engine(mesh=)`), which cuts the full weights to this rank's share
    (``device`` is then this rank's)."""
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device="
                           "\"cpu\") to run on the CPU")
    if kv_cache not in ("bf16", "int8"):
        raise ValueError(f"kv_cache must be bf16 or int8, got {kv_cache!r}")
    knobs = parse_quant_mode(quantize) if quantize else None
    if quantize_vision not in (None, "int8", "int8a8"):
        raise ValueError(f"quantize_vision must be int8 or int8a8, got "
                         f"{quantize_vision!r}")
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    if model_name.startswith("random:"):
        from valley_tpu_torch.tokenizer import ByteFallbackTokenizer

        if lora_path:
            raise ValueError("--lora-path merges into a checkpoint "
                             f"directory's weights, not {model_name!r}")
        tokenizer = ByteFallbackTokenizer()
        size = model_name.split(":", 1)[1]
        if size == "tiny":
            cfg = C.valley_tiny().replace(tokens=tokenizer.special_tokens())
        elif size in ("7b", "13b"):
            cfg = C.ValleyConfig(
                text=C.LLAMA2_13B if size == "13b" else C.LLAMA2_7B,
                tokens=tokenizer.special_tokens())
            dtype = torch.bfloat16
        else:
            raise ValueError(f"unknown model {model_name!r}: random:tiny, "
                             "random:7b or random:13b, or a checkpoint "
                             "directory")
        params = valley.init_params(cfg, torch.Generator(device).manual_seed(
            0), dtype, device)
        if size != "tiny":
            # the JAX worker's full-size random weights: every leaf 0.008
            for p in params.parameters():
                p.data.fill_(0.008)
        if fused:
            params = llama.fuse_llama_params(params)
        if knobs:
            params = quantize_llama_params(params, act8=knobs["act8"],
                                           bits=knobs["bits"],
                                           group_size=knobs["group_size"])
    elif lora_path:
        from valley_tpu_torch.train import lora as lora_lib
        from valley_tpu_torch.utils import checkpoint as ckpt_lib
        from valley_tpu_torch.utils import hf_bridge

        # no quantize-on-load: the adapter merges into the float weights
        cfg, params, tokenizer = hf_bridge.load_valley_checkpoint(
            model_name, vision_tower=vision_tower, dtype=dtype,
            tokenizer=tokenizer, device=device)
        adapter = ckpt_lib.restore_pytree(lora_path, map_location=device)
        params = lora_lib.merge_lora(lora_lib.load_lora(params, adapter))
        if fused:
            params = llama.fuse_llama_params(params)
        if knobs:
            params = quantize_llama_params(params, act8=knobs["act8"],
                                           bits=knobs["bits"],
                                           group_size=knobs["group_size"])
    else:
        from valley_tpu_torch.utils import hf_bridge

        cfg, params, tokenizer = hf_bridge.load_valley_checkpoint(
            model_name, vision_tower=vision_tower, dtype=dtype,
            quantize=quantize, fused=fused, tokenizer=tokenizer,
            device=device)
    if quantize_vision:
        params = quantize_vision_params(params,
                                        act8=quantize_vision == "int8a8")
    engine = Engine(cfg, params, buckets=buckets,
                    max_new_tokens=max_new_tokens,
                    cache_dtype=torch.int8 if kv_cache == "int8"
                    else torch.bfloat16, steps_per_call=steps_per_call,
                    decode_ramp=decode_ramp, frame_buckets=frame_buckets,
                    raw_media=raw_media, mesh=mesh)
    return engine, tokenizer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-name", type=str, required=True,
                        help="checkpoint directory, or random:tiny / "
                             "random:7b / random:13b")
    parser.add_argument("--video-file", type=str, required=True)
    parser.add_argument("--query", type=str,
                        default="Describe the video concisely.")
    parser.add_argument("--system-prompt", type=str,
                        default=DEFAULT_SYSTEM_PROMPT)
    parser.add_argument("--vision-tower", type=str, default=None,
                        help="CLIP checkpoint directory for a checkpoint "
                             "without its own tower")
    parser.add_argument("--lora-path", type=str, default=None,
                        help="adapter-only final/ of a LoRA training run, "
                             "merged into --model-name's weights")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=list(SERVED_MODES),
                        help="quantized decoder weights: per-channel "
                             "int8 (int8a8 also runs W8A8 prefill), or "
                             "nibble-packed int4 per channel (int4) or with "
                             "group-128 scales (int4g, int4gp; int4ga8 and "
                             "int4gpa8 also run grouped W4A8 prefill)")
    parser.add_argument("--kv-cache", type=str, default="bf16",
                        choices=["bf16", "int8"],
                        help="KV-cache dtype")
    parser.add_argument("--fused", action="store_true",
                        help="fused wqkv/w_gateup layout (4 GEMVs per "
                             "layer instead of 7)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--do-sample", action="store_true")
    parser.add_argument("--speculative", action="store_true",
                        help="n-gram self-speculative decode (greedy "
                             "token-identical, sampling "
                             "distribution-exact)")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="N ranks under torchrun --nproc_per_node N, "
                             "the weights cut over them; rank 0 prints")
    args = parser.parse_args(argv)

    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import serving_mesh

    mesh = serving_mesh(args.tensor_parallel, args.device,
                        "valley_tpu_torch.inference.run_valley")
    engine, tokenizer = load_model(
        args.model_name,
        distributed.device_for(args.device or "cuda") if mesh is not None
        else args.device, max_new_tokens=args.max_new_tokens,
        quantize=args.quantize, fused=args.fused, kv_cache=args.kv_cache,
        vision_tower=args.vision_tower, lora_path=args.lora_path, mesh=mesh)
    messages = [
        {"role": "system", "content": args.system_prompt},
        {"role": "user", "content": args.query + " <video>"},
    ]
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           do_sample=args.do_sample)
    # every rank runs the same request (the collectives pair up by order)
    response = completion(engine, tokenizer, args.video_file, messages, gen,
                          speculative=args.speculative)
    if distributed.process_index() == 0:
        print(response[0])
    distributed.shutdown()


if __name__ == "__main__":
    main()
