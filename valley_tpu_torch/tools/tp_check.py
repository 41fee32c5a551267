"""Valley-13B served tensor-parallel across cards over NCCL: one 8-frame
video request decoded by CUDA graph with the collectives captured.

Run one world per card count, one process a card (each rank takes the
process group down, its captured graphs released first, and prints the
seconds that took); the first run (N = 1) writes its tokens, which the
others are held to:

    for n in 1 2 4; do
      torchrun --standalone --nproc_per_node $n \\
          -m valley_tpu_torch.tools.tp_check --out tp_check_out
    done

Each world loads Valley-13B bf16 at its full 40 layers on random weights
(seed 0, N(0, 1/fan_in), made on each card and cut by `Engine(mesh=)` to its
(1, 1, N) share), warms the request once (which captures the decode
graphs), then serves it again and prints, from rank 0, one line of JSON:
the first token and its wall time, decode ms/token over the 128 new
tokens, the share of a decode step's device time in NCCL's kernels (the
profiler over replays of one 16-step graph: all-reduce, and the all-gather
of the logits' vocabulary shares), and whether the tokens equal N = 1's
(else the first step where they part).  The card's name and power limit
from ``nvidia-smi`` stand beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

NEW_TOKENS = 128
STEPS_PER_CALL = 16
BUCKET = 512
PROFILED_CHUNKS = 3


def request(cfg):
    """An 8-frame video prompt of 473 tokens in the 512 bucket, raw uint8
    frames (bench.py's shape), from seed 0."""
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    rng = np.random.default_rng(0)
    prompt = [1] + span + rng.integers(
        5, 30000, size=BUCKET - len(span) - 40).tolist()
    size = cfg.vision.image_size
    return prompt, rng.integers(0, 256, (1, 8, 3, size, size)).astype(
        np.uint8)


def serve(engine, prompt, frames) -> tuple:
    """(tokens, first-token ms, decode ms/token) of one greedy request."""
    from valley_tpu_torch.inference.engine import GenerationConfig

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, t_first = [], None
    for t in engine.generate_tokens([prompt], frames, gen, eos_ids=[-1]):
        toks.append(int(t[0]))
        if t_first is None:
            t_first = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return toks, (t_first - t0) * 1e3, (t1 - t_first) * 1e3 / (len(toks) - 1)


def collective_share(engine) -> dict:
    """Device time by kind over `PROFILED_CHUNKS` replays of the engine's
    16-step decode graph (continuing the last request's state)."""
    graphs = next(iter(engine.graph_sets.values()))
    graphs.run(STEPS_PER_CALL, False)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED_CHUNKS):
            graphs.run(STEPS_PER_CALL, False)
        torch.cuda.synchronize()
    kinds = {"all_reduce": 0.0, "all_gather": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = "all_reduce" if "nccl" in name and "allreduce" in name \
            else "all_gather" if "nccl" in name and "allgather" in name \
            else "other"
        kinds[kind] += us / 1e3
    total = sum(kinds.values())
    steps = PROFILED_CHUNKS * STEPS_PER_CALL
    return {"device_ms_per_step": total / steps if total else None,
            **{f"{k}_share": (v / total if total else None)
               for k, v in kinds.items() if k != "other"}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True,
                        help="directory for the N = 1 tokens and each "
                             "world's line")
    args = parser.parse_args(argv)

    from valley_tpu_torch import SpecialTokens, valley_13b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
    from valley_tpu_torch.inference.engine import Engine
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import serving_mesh

    if not torch.cuda.is_available():
        raise SystemExit("tp_check runs on the card")
    n = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = serving_mesh(n, "cuda", "valley_tpu_torch.tools.tp_check")
    device = distributed.device_for("cuda")
    torch.cuda.set_device(device)
    rank = distributed.process_index()
    cfg = valley_13b(tokens=SpecialTokens(**BENCH_TOKENS))
    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator(device).manual_seed(0),
                                torch.bfloat16, device)
    engine = Engine(cfg, params, buckets=(BUCKET,),
                    max_new_tokens=NEW_TOKENS, steps_per_call=STEPS_PER_CALL,
                    mesh=mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompt, frames = request(cfg)
    t0 = time.perf_counter()
    serve(engine, prompt, frames)           # captures the decode graphs
    warm_s = time.perf_counter() - t0
    toks, first_ms, decode_ms = serve(engine, prompt, frames)
    share = collective_share(engine)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        ref_path = out / "tokens_n1.json"
        if n == 1:
            ref_path.write_text(json.dumps(toks))
        ref = json.loads(ref_path.read_text()) if ref_path.exists() else None
        parted = None if ref is None or ref == toks else next(
            i for i, (a, b) in enumerate(zip(ref, toks)) if a != b)
        line = {"ranks": n, "layers": cfg.text.num_hidden_layers,
                "first_token": toks[0], "first_token_ms": first_ms,
                "decode_ms_per_token": decode_ms, **share,
                "tokens_equal_n1": None if ref is None else ref == toks,
                "first_parting_step": parted,
                "graphs": engine.use_graphs,
                "graph_keys": sorted(map(list, next(iter(
                    engine.graph_sets.values())).keys())),
                "load_s": load_s, "warm_s": warm_s,
                "cards": smi[:n]}
        (out / f"n{n}.json").write_text(json.dumps(line))
        print(json.dumps(line), flush=True)
    # the decode graphs hold NCCL's communicator: `shutdown` releases them
    # before it destroys the group (it hung while they lived)
    t0 = time.perf_counter()
    distributed.shutdown()
    print(json.dumps({"rank": rank, "teardown_s": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
