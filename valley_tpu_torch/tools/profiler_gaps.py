"""How often ``torch.profiler`` returns a trace without device events on
the card, and whether a trace taken again after a pause has them.

Each of two child processes takes profiler traces of ten calls of a small
workload (a bf16 GEMV over one of six 12288x4096 weights, as
`chip_smoke.py`'s library timing walks them, then the same product
through ``@``, then an fp32 elementwise sum), cycling through the three,
for a fixed time: back to back for the first half, counting empty traces,
traces short of events and the longest run of empty traces in a row; for
the second half by `chip_smoke.py`'s retry rule (a trace without device
time is taken again after 0.25 s times the attempt number), counting the
calls that needed more than one trace and the most traces any call
needed.  The first child runs with torch's default, CUPTI torn down after
each trace; the second with ``TEARDOWN_CUPTI=0``.  One JSON line per
child.

    python -m valley_tpu_torch.tools.profiler_gaps [seconds per child]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ITERS = 10


def _trace(fn) -> tuple:
    """(device events, a kernel short of ``ITERS`` events) of one trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    return len(dev), any(e.count % ITERS for e in dev)


def child(seconds: float) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((1, 4096), generator=gen, device="cuda").bfloat16()
    ws = [torch.randn((12288, 4096), generator=gen,
                      device="cuda").bfloat16() for _ in range(6)]
    a = torch.randn((4096, 4096), generator=gen, device="cuda")
    it = iter(range(10 ** 9))
    work = [lambda: torch.nn.functional.linear(x, ws[next(it) % len(ws)]),
            lambda: x @ ws[next(it) % len(ws)].t(),
            lambda: (a * 2 + 1).sum()]
    for fn in work:
        fn()
    out = {"teardown_cupti": os.environ.get("TEARDOWN_CUPTI", "default"),
           "back_to_back": {"traces": 0, "empty": 0, "short": 0,
                            "longest_empty_run": 0},
           "with_retry": {"calls": 0, "retried": 0, "most_traces": 0}}
    b2b, run = out["back_to_back"], 0
    t0 = time.time()
    while time.time() - t0 < seconds / 2:
        n, short = _trace(work[b2b["traces"] % len(work)])
        b2b["traces"] += 1
        b2b["empty"] += n == 0
        b2b["short"] += short
        run = run + 1 if n == 0 else 0
        b2b["longest_empty_run"] = max(b2b["longest_empty_run"], run)
    retry = out["with_retry"]
    t0 = time.time()
    while time.time() - t0 < seconds / 2:
        fn = work[retry["calls"] % len(work)]
        attempt = 1
        while _trace(fn)[0] == 0 and attempt < 20:
            attempt += 1
            time.sleep(0.25 * attempt)
        retry["calls"] += 1
        retry["retried"] += attempt > 1
        retry["most_traces"] = max(retry["most_traces"], attempt)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(float(argv[1]))), flush=True)
        return 0
    seconds = argv[0] if argv else "60"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for teardown in (None, "0"):
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        if teardown is not None:
            env["TEARDOWN_CUPTI"] = teardown
        subprocess.run([sys.executable, "-m", __spec__.name, "--child",
                        seconds], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
