"""Valley-13B full stage 2 trained across cards over NCCL on a ``model``
axis, beside ZeRO-3: the same three updates at meshes (1, 1, 4), (1, 2, 2)
and (1, 4, 1), one world of four processes, one a card:

    torchrun --standalone --nproc_per_node 4 \\
        -m valley_tpu_torch.tools.tp_train_check --out tp_train_out

Each mesh trains Valley-13B at its full 40 layers on random bf16 weights
(seed 0, N(0, 1/fan_in), made on each card and cut by `Trainer(mesh=)`),
with valley_stage2.yaml's settings (the decoder, embeddings, head and
projector trained, AdamW, lr 2e-5, clipping at 1) and ``"dots"`` remat,
on one synthetic row of 2048 tokens with an 8-frame video a batch block:
every block holds the same row, so the global mean loss, and every update,
is the same at every mesh.  Rank 0 prints one line of JSON a mesh: the
three updates' losses and walls (the update's wall: the median of the last
two), then, over a fourth update under the profiler, the device's busy
time (the union of the kernels' intervals: NCCL's kernels run on their own
streams beside the compute) and idle share, the share of NCCL's
all-reduce, all-gather and reduce-scatter kernels in the summed kernel
time (a collective's kernel waits for its peers, so the share counts the
ranks' skew with the transfer), K1's and K2's device ms a call on the
rank's heads, and each rank's peak memory over the updates (and apart,
the peak of making the full tree before it is cut); then a last line
with the meshes' losses against each other (the stage-2 loss bar, 2.5e-3)
and the seconds the process group took to come down.  The card's name and
power limit from ``nvidia-smi`` stand beside them.  No depth or width is
cut: Valley-13B full stage 2 fits no fewer than four cards.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

MESHES = ((1, 1, 4), (1, 2, 2), (1, 4, 1))
UPDATES = 3
SEQ = 2048
FRAMES = 8
# the stage-2 loss bar of PERF.md §2, between the meshes' losses
LOSS_BAR = 2.5e-3
KINDS = {"all_reduce": "allreduce", "all_gather": "allgather",
         "reduce_scatter": "reducescatter"}


def device_row(cfg, device) -> dict:
    """One collated synthetic row of `SEQ` tokens with a `FRAMES`-frame
    video (`TrainRows`' first row, seed 0) on ``device``."""
    import numpy as np

    from valley_tpu_torch.data.dataset import DataCollatorForSupervisedDataset
    from valley_tpu_torch.data.synthetic import TrainRows

    rows = TrainRows(cfg, n=2, seq=SEQ, frames=FRAMES)
    coll = DataCollatorForSupervisedDataset(
        pad_token_id=0, pad_to_length=SEQ, pad_frames_to=FRAMES,
        max_length=SEQ)
    batch = coll([rows[0]])
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.to(torch.bfloat16) if k == "images" else t).to(device)
    return out


class OneRow:
    """A loader of the same row, `UPDATES` + 1 times (the trainer's
    length)."""

    def __len__(self):
        return UPDATES + 1

    def epoch(self, _i):
        raise RuntimeError("the check drives the updates itself")


def profile_update(trainer, batch) -> dict:
    """Device time by kind over one update under the profiler: busy
    (every kernel), the collectives by kind, K1 and K2, and the wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = {"kernels": 0.0, "K1": 0.0, "K2": 0.0, **{k: 0.0 for k in KINDS}}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        ms["kernels"] += us / 1e3
        if "flash_fwd_kernel" in name:
            ms["K1"] += us / 1e3
        elif "flash_bwd_" in name:
            ms["K2"] += us / 1e3
        for kind, key in KINDS.items():
            if "nccl" in name and key in name.replace("_", ""):
                ms[kind] += us / 1e3
    # busy: the union of the kernels' intervals (NCCL's run on their own
    # streams beside the compute, so the kernels' sum exceeds it)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    ms["busy"] = busy / 1e3
    ms["wall"] = wall * 1e3
    return ms


def train_mesh(cfg, shape, device, out_dir: Path) -> dict:
    """The updates of one mesh on this rank: losses, walls, the profiled
    update's breakdown, K1's and K2's launches in it, and peak memory."""
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from valley_tpu_torch.parallel.mesh import create_mesh
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer

    mesh = create_mesh(*shape, device_type=device.type)
    torch.cuda.reset_peak_memory_stats(device)
    params = valley.init_params(cfg, torch.Generator(device).manual_seed(0),
                                torch.bfloat16, device)
    tc = TrainConfig(output_dir=str(out_dir / "x".join(map(str, shape))),
                     learning_rate=2e-5, lr_scheduler_type="cosine",
                     warmup_ratio=0.03, adam_beta1=0.9, adam_beta2=0.95,
                     max_grad_norm=1.0, weight_decay=0.0,
                     gradient_checkpointing="dots", freeze_backbone=False,
                     tune_mm_mlp_adapter=True, per_device_train_batch_size=1,
                     save_steps=0)
    trainer = Trainer(cfg, tc, params, OneRow(), total_steps=8, mesh=mesh)
    # the full tree is made on each card before it is cut: that peak apart
    init_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    batch = device_row(cfg, device)
    losses, walls = [], []
    for _ in range(UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    k1, k2 = flash_attention.launches, flash_attention_bwd.launches
    prof = profile_update(trainer, batch)
    k1, k2 = flash_attention.launches - k1, flash_attention_bwd.launches - k2
    peak = torch.cuda.max_memory_allocated(device)
    # the trainer and its loader hold each other: the cycle goes only
    # with the collector, and the next mesh needs its memory
    del trainer, params, batch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"losses": losses, "walls": walls, "prof": prof, "k1": k1,
            "k2": k2, "peak": peak, "init_peak": init_peak}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True,
                        help="directory for each mesh's line")
    args = parser.parse_args(argv)

    from valley_tpu_torch import SpecialTokens, valley_13b
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS
    from valley_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        raise SystemExit("tp_train_check runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if not distributed.initialize(device="cuda"):
        raise SystemExit("launch under torchrun --nproc_per_node 4")
    n = distributed.process_count()
    if n != 4:
        raise SystemExit(f"a world of 4 cards, not {n}")
    device = distributed.device_for("cuda")
    rank = distributed.process_index()
    cfg = valley_13b(tokens=SpecialTokens(**BENCH_TOKENS))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines() if rank == 0 else None
    lines = {}
    for shape in MESHES:
        t0 = time.perf_counter()
        got = train_mesh(cfg, shape, device, out)
        every = [None] * n
        torch.distributed.all_gather_object(
            every, {"peak": got["peak"], "init_peak": got["init_peak"],
                    "prof": got["prof"], "k1": got["k1"], "k2": got["k2"]})
        if rank == 0:
            prof = got["prof"]
            coll = sum(prof[k] for k in KINDS)
            line = {
                "mesh": list(shape), "layers": cfg.text.num_hidden_layers,
                "seq": SEQ, "losses": got["losses"],
                "update_walls_ms": [w * 1e3 for w in got["walls"]],
                "update_wall_ms": statistics.median(got["walls"][1:]) * 1e3,
                "profiled_update": {
                    "wall_ms": prof["wall"], "device_busy_ms": prof["busy"],
                    "kernels_summed_ms": prof["kernels"],
                    "idle_share": 1 - prof["busy"] / prof["wall"],
                    "collective_share": coll / prof["kernels"],
                    **{f"{k}_share": prof[k] / prof["kernels"]
                       for k in KINDS},
                    "k1_ms_per_call": prof["K1"] / max(got["k1"], 1),
                    "k2_ms_per_call": prof["K2"] / max(got["k2"], 1),
                    "k1_launches": got["k1"], "k2_launches": got["k2"]},
                "heads_a_rank": cfg.text.num_attention_heads // shape[2],
                "peak_gib_by_rank": [e["peak"] / 2 ** 30 for e in every],
                "init_peak_gib_by_rank": [e["init_peak"] / 2 ** 30
                                          for e in every],
                "idle_share_by_rank": [
                    1 - e["prof"]["busy"] / e["prof"]["wall"]
                    for e in every],
                "collective_share_by_rank": [
                    sum(e["prof"][k] for k in KINDS) / e["prof"]["kernels"]
                    for e in every],
                "seconds": time.perf_counter() - t0, "cards": smi}
            lines[shape] = line
            (out / ("mesh_" + "x".join(map(str, shape)) + ".json")
             ).write_text(json.dumps(line))
            print(json.dumps(line), flush=True)
    if rank == 0:
        losses = [lines[s]["losses"] for s in MESHES]
        gap = max(abs(a - b) for ls in losses for a, b in zip(ls, losses[0]))
        print(json.dumps({"losses_agree": gap <= LOSS_BAR, "largest_gap": gap,
                          "bar": LOSS_BAR}), flush=True)
    t0 = time.perf_counter()
    distributed.shutdown()
    print(json.dumps({"rank": rank, "teardown_s": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
