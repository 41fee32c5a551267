"""Offline batch inference on the PyTorch port: a JSONL of requests through
the continuous-batching pool (`inference.continuous.ContinuousEngine`),
the counterpart of ``valley_tpu/inference/batch_infer.py``.

The weights load once, every request streams through the pool, and each
answer is appended to the output JSONL the moment its request finishes.

Input, one JSON object per line:

    {"id": "a1", "video": "clip.mp4", "query": "Describe the video."}
    {"id": "a2", "query": "A text-only question."}
    {"id": "a3", "image": "img.jpg", "query": "What is shown?"}

``video`` is a media file or a directory of frames; ``image`` one image,
served as a one-frame video.  A ``<video>``/``<image>`` placeholder is
prepended to ``query`` when media is given without one.  Optional keys:
``system_prompt``, ``temperature``, ``max_new_tokens``; ``id`` defaults to
the line number.

Output, appended as requests complete (ids already present are skipped, so
a killed run resumes where it stopped):

    {"id": "a1", "response": "...", "tokens": 57, "ttft_s": 0.41,
     "wall_s": 1.93}

A line that cannot be prepared or served is written as
``{"id": ..., "error": "..."}``.

Usage:

    python -m valley_tpu_torch.inference.batch_infer \\
        --model-path random:tiny --input req.jsonl --output ans.jsonl \\
        [--device cpu]

The flags and defaults are the JAX module's (``--rows 16 --fused
--kv-cache int8 --steps-per-call 16 --buckets 512,1024,2048``, bf16
weights unless ``--quantize``).  It runs on the card; without one it stops
unless ``--device cpu`` is given.  ``--model-path`` is a checkpoint
directory (quantized on load with ``--quantize``) or a ``random:``
configuration (`run_valley.load_model`).  The decode GEMV kernels take at most
``ops.quant.MAX_ROWS`` (16) rows, so a pool of more ``--rows`` decodes its
projections through the library's matrix product, the same shape rule by
which prefill's many rows and speculative verify rounds of more than 16
rows do.  ``--speculative`` decodes by n-gram self-speculation per row
(``ContinuousEngine(speculative=True)``, the JAX defaults of
``SpecConfig``).  ``--frame-buckets 1,4,8`` pads each
video's frames to the smallest bucket that holds them (``off`` or empty:
exact counts; ``--num-frames`` is added as a bucket where it exceeds
them), as the JAX worker's ``load_engine`` does, and the pool is warmed at
those buckets.  ``--lora-path`` merges a LoRA adapter into a checkpoint
directory's weights before fusing and quantizing (`run_valley.load_model`);
``--quantize-vision int8|int8a8`` quantizes the CLIP tower.

``--tensor-parallel N`` cuts the weights over N ranks, one process a card:

    torchrun --nproc_per_node N -m valley_tpu_torch.inference.batch_infer \
        --tensor-parallel N --model-path ... --input ... --output ...

Every rank reads the JSONL and its output (to tell whether work is left)
and runs the same pool; rank 0 submits the requests, sends each to the
other ranks with its submit (`parallel.lockstep`), and alone writes the
output.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time

from valley_tpu_torch.inference.run_valley import DEFAULT_SYSTEM_PROMPT

logger = logging.getLogger("valley_tpu_torch.batch_infer")


def _load_requests(path: str):
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "query" not in obj:
                raise ValueError(f"line {i + 1}: missing 'query'")
            obj.setdefault("id", i)
            reqs.append(obj)
    return reqs


def _done_ids(path: str):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        done.add(json.loads(line)["id"])
                    except (ValueError, KeyError):
                        continue    # a half-written tail line from a kill
    return done


def _prepare(req: dict, cfg, num_frames: int, frame_mode: str,
             raw_pixels: bool, default_system: str):
    """One JSONL request -> (token-expanded prompt text, frames or None):
    frames (1, T, 3, H, W), uint8 with ``raw_pixels``."""
    from valley_tpu_torch.constants import (DEFAULT_IMAGE_TOKEN,
                                            DEFAULT_VIDEO_TOKEN)
    from valley_tpu_torch.inference.generate import (build_prompt,
                                                     media_replace_token)

    query = req["query"]
    frames = None
    size = cfg.vision.image_size
    if req.get("video"):
        from valley_tpu_torch.data.video import load_video

        clip = load_video(req["video"], frame_mode=frame_mode,
                          fixed_frame_number=num_frames, crop_size=size,
                          scale_size=max(size * 256 // 224, size),
                          raw_pixels=raw_pixels)
        frames = clip.transpose(1, 0, 2, 3)[None]      # (1, T, 3, H, W)
        if DEFAULT_VIDEO_TOKEN not in query:
            query = DEFAULT_VIDEO_TOKEN + "\n" + query
    elif req.get("image"):
        import numpy as np
        from PIL import Image

        from valley_tpu_torch.data.dataset import preprocess_image

        img = preprocess_image(Image.open(req["image"]).convert("RGB"),
                               crop_size=size, scale_size=size,
                               raw_pixels=raw_pixels)
        frames = np.stack([img])[None]                  # (1, 1, 3, H, W)
        if DEFAULT_IMAGE_TOKEN not in query:
            query = DEFAULT_IMAGE_TOKEN + "\n" + query
    t = frames.shape[1] if frames is not None else num_frames
    replace = media_replace_token(cfg.num_patches, t)
    query = query.replace(DEFAULT_VIDEO_TOKEN, replace)
    query = query.replace(DEFAULT_IMAGE_TOKEN, replace)
    messages = [
        {"role": "system",
         "content": req.get("system_prompt", default_system)},
        {"role": "user", "content": query},
    ]
    return build_prompt(messages, cfg.num_patches, t,
                        require_media=False), frames


def frame_buckets(args):
    """``--frame-buckets`` as the engine takes it (model_worker.py:992-999):
    None for ``off`` or empty, else the buckets, with ``--num-frames``
    added where it exceeds them."""
    fb = (args.frame_buckets or "").strip()
    if fb.lower() == "off" or not fb:
        return None
    fbt = tuple(int(b) for b in fb.split(","))
    if args.num_frames > max(fbt):
        fbt = fbt + (int(args.num_frames),)
    return fbt


def run_batch(args) -> dict:
    """Run the file; returns summary stats (also printed; None on a
    follower rank of ``--tensor-parallel``)."""
    from valley_tpu_torch.inference.continuous import (ContinuousEngine,
                                                       _drain)
    from valley_tpu_torch.inference.generate import process_response
    from valley_tpu_torch.inference.run_valley import load_model
    from valley_tpu_torch.parallel import distributed, lockstep
    from valley_tpu_torch.parallel.mesh import serving_mesh

    reqs = _load_requests(args.input)
    done = _done_ids(args.output)
    todo = [r for r in reqs if r["id"] not in done]
    if done:
        logger.info("resume: %d of %d already in %s, %d to run",
                    len(done), len(reqs), args.output, len(todo))
    if not todo:
        summary = {"requests": len(reqs), "ran": 0, "skipped": len(reqs),
                   "errors": 0, "tokens": 0, "wall_s": 0.0,
                   "agg_tok_s": 0.0}
        print(json.dumps(summary))
        return summary

    mesh = serving_mesh(args.tensor_parallel, args.device,
                        "valley_tpu_torch.inference.batch_infer")
    device = args.device if mesh is None else \
        distributed.device_for(args.device or "cuda")
    engine, tokenizer = load_model(
        args.model_path, device,
        buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        max_new_tokens=args.max_new_tokens, quantize=args.quantize,
        fused=args.fused, kv_cache=args.kv_cache,
        steps_per_call=args.steps_per_call,
        decode_ramp=tuple(int(s) for s in args.decode_ramp.split(",") if s),
        frame_buckets=frame_buckets(args), raw_media=bool(args.raw_pixels),
        vision_tower=args.vision_tower, lora_path=args.lora_path,
        quantize_vision=args.quantize_vision, mesh=mesh)
    cfg = engine.cfg
    ls = None
    if mesh is not None:
        ls = lockstep.Lockstep()
        ls.register(engine)
        ls.register(tokenizer)
        if not ls.lead:
            ls.follow()
            return None
    pool = lockstep.make(ContinuousEngine, engine, rows=args.rows,
                         admit_batch=args.admit_batch,
                         speculative=bool(args.speculative), proxy=False)
    # model_worker.py:1225-1226: the engine's frame buckets where it has
    # them
    pool.warmup(frames=engine.frame_buckets
                or tuple(sorted({args.num_frames, 1})) + (0,))

    out_lock = threading.Lock()
    out_f = open(args.output, "a")
    eos_id = int(getattr(tokenizer, "eos_token_id", 2) or 2)
    inflight = threading.Semaphore(args.inflight or args.rows * 4)
    totals = {"tokens": 0, "ran": 0, "errors": 0}

    def write(rec: dict) -> None:
        with out_lock:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
            totals["tokens"] += rec.get("tokens", 0)
            totals["errors"] += "error" in rec
            totals["ran"] += 1

    def consume(req, outq, t_submit):
        ids, first = [], None
        try:
            for t in _drain(outq):
                if first is None:
                    first = time.perf_counter() - t_submit
                ids.append(int(t))
            text = tokenizer.decode(ids)
            rec = {"id": req["id"],
                   "response": process_response([text])[0],
                   "tokens": len(ids),
                   "ttft_s": round(first, 3) if first is not None else None,
                   "wall_s": round(time.perf_counter() - t_submit, 3)}
        except Exception as e:                  # noqa: BLE001 -- per row
            rec = {"id": req["id"], "error": f"{type(e).__name__}: {e}"}
        write(rec)
        inflight.release()

    t0 = time.perf_counter()
    threads = []
    try:
        for req in todo:
            inflight.acquire()
            try:
                prompt, frames = _prepare(req, cfg, args.num_frames,
                                          args.frame_mode,
                                          bool(args.raw_pixels),
                                          args.system_prompt)
                outq = pool.submit(
                    tokenizer.encode(prompt), images=frames,
                    temperature=float(req.get("temperature",
                                              args.temperature)),
                    top_p=args.top_p,
                    max_new_tokens=min(int(req.get("max_new_tokens",
                                                   args.max_new_tokens)),
                                       engine.max_new_tokens),
                    eos_id=eos_id)
            except Exception as e:              # noqa: BLE001 -- bad row
                write({"id": req["id"], "error": f"{type(e).__name__}: {e}"})
                inflight.release()
                continue
            th = threading.Thread(target=consume,
                                  args=(req, outq, time.perf_counter()),
                                  daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
    finally:
        pool.close()
        out_f.close()
        if ls is not None:
            ls.stop()
    wall = time.perf_counter() - t0
    summary = {"requests": len(reqs), "ran": totals["ran"],
               "skipped": len(done), "errors": totals["errors"],
               "tokens": totals["tokens"], "wall_s": round(wall, 2),
               "agg_tok_s": round(totals["tokens"] / wall, 1)
               if wall > 0 else 0.0}
    print(json.dumps(summary))
    return summary


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Batch offline inference over the continuous-"
                    "batching pool (JSONL in, JSONL out, crash-resume)")
    parser.add_argument("--input", required=True,
                        help="requests JSONL (see the module docstring)")
    parser.add_argument("--output", required=True,
                        help="answers JSONL; appended, resumable")
    parser.add_argument("--rows", type=int, default=16,
                        help="pool rows (more than 16 decode through the "
                             "library's matrix product)")
    parser.add_argument("--inflight", type=int, default=0,
                        help="max submitted-but-unfinished requests "
                             "(default rows*4)")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--system-prompt", default=DEFAULT_SYSTEM_PROMPT)
    parser.add_argument("--speculative", action="store_true",
                        help="n-gram self-speculation per row (a latency "
                             "lever)")
    parser.add_argument("--admit-batch", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    # engine flags: the serving worker's names and defaults
    parser.add_argument("--model-path", required=True,
                        help="a checkpoint directory, or random:tiny / "
                             "random:7b / random:13b")
    parser.add_argument("--vision-tower", default=None)
    parser.add_argument("--lora-path", default=None)
    parser.add_argument("--quantize", default=None,
                        help="int8|int8a8|int4|int4g|int4gp|int4ga8|"
                             "int4gpa8")
    parser.add_argument("--quantize-vision", default=None,
                        help="int8|int8a8: the int8 CLIP tower")
    parser.add_argument("--fused", action="store_true", default=True)
    parser.add_argument("--no-fused", dest="fused", action="store_false")
    parser.add_argument("--kv-cache", default="int8",
                        choices=["bf16", "int8"])
    parser.add_argument("--buckets", default="512,1024,2048")
    parser.add_argument("--frame-buckets", default="")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--steps-per-call", type=int, default=16)
    parser.add_argument("--decode-ramp", default="")
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--frame-mode", default="fixed")
    parser.add_argument("--tensor-parallel", type=int, default=1)
    parser.add_argument("--raw-pixels", action="store_true", default=True)
    parser.add_argument("--no-raw-pixels", dest="raw_pixels",
                        action="store_false")
    return parser


def main(argv=None):
    from valley_tpu_torch.parallel import distributed

    logging.basicConfig(level=logging.INFO)
    run_batch(build_parser().parse_args(argv))
    distributed.shutdown()


if __name__ == "__main__":
    main()
