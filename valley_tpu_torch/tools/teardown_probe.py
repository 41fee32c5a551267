"""Where an NCCL world's teardown hangs: one world of cards runs a few
collectives, then calls ``barrier`` and ``destroy_process_group``, each
timed, one JSON line a rank:

    torchrun --standalone --nproc_per_node 2 \\
        -m valley_tpu_torch.tools.teardown_probe --mode graph

``--mode graph`` captures one all-reduce in a CUDA graph (after an eager
one, which sets NCCL's communicator up), replays it and keeps the graph
alive through a bare ``destroy_process_group``, as the serving engine's
decode graphs were kept; ``graph_freed`` frees the graph and its pool
first; ``graph_shutdown`` keeps it and takes the group down through
`parallel.distributed.shutdown`, which releases the graphs captured under
the group (the port's teardown); ``eager`` runs the collectives the
trainer runs (all-reduce, all-gather, reduce-scatter, over the world and a
subgroup) eagerly, with no graph.  A step that has
not returned after ``--limit`` seconds is reported as hung on its line and
the process leaves with code 3 (the probe exists to see where a teardown
stops, so it must come back).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import torch
import torch.distributed as dist


def _watch(rank: int, step: str, limit: float) -> threading.Timer:
    """A timer that reports ``step`` as hung and ends the process with
    code 3 after ``limit`` seconds unless cancelled."""
    def hung():
        print(json.dumps({"rank": rank, "step": step, "hung_after_s":
                          limit}), flush=True)
        os._exit(3)

    t = threading.Timer(limit, hung)
    t.daemon = True
    t.start()
    return t


def timed(rank: int, step: str, fn, limit: float) -> float:
    watch = _watch(rank, step, limit)
    t0 = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t0
    watch.cancel()
    return seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", required=True, choices=(
        "graph", "graph_freed", "graph_shutdown", "eager"))
    parser.add_argument("--limit", type=float, default=60.0,
                        help="seconds after which a step counts as hung")
    args = parser.parse_args(argv)

    from valley_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        print("teardown_probe runs on the card", file=sys.stderr)
        return 2
    if not distributed.initialize(device="cuda"):
        print("launch under torchrun", file=sys.stderr)
        return 2
    rank, world = distributed.process_index(), distributed.process_count()
    device = distributed.device_for("cuda")
    x = torch.full((1 << 20,), float(rank + 1), device=device)
    dist.all_reduce(x)                    # sets the communicator up
    want = float(world * (world + 1) // 2)
    graph = None
    if args.mode.startswith("graph"):
        y = torch.ones((1 << 20,), device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            dist.all_reduce(y)            # warm on the capture's stream
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            dist.all_reduce(y)
        distributed.hold_graph(graph)
        y.fill_(float(rank + 1))
        graph.replay()
        torch.cuda.synchronize(device)
        ok = bool((y == want).all())
        if args.mode == "graph_freed":
            graph.reset()
            graph = None
            torch.cuda.empty_cache()
    else:
        sub = dist.new_group(list(range(world)))
        g = torch.empty((world << 20,), device=device)
        dist.all_gather_into_tensor(g, x, group=sub)
        r = torch.empty((1 << 20,), device=device)
        dist.reduce_scatter_tensor(r, g)
        torch.cuda.synchronize(device)
        ok = bool((x == want).all()) and bool((r == world * want).all())
    line = {"mode": args.mode, "rank": rank, "world": world,
            "collectives_right": ok}
    line["barrier_s"] = timed(rank, "barrier", dist.barrier, args.limit)
    line["graph_alive"] = graph is not None
    if args.mode == "graph_shutdown":
        line["shutdown_s"] = timed(rank, "distributed.shutdown",
                                   distributed.shutdown, args.limit)
    else:
        line["destroy_s"] = timed(rank, "destroy_process_group",
                                  dist.destroy_process_group, args.limit)
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
