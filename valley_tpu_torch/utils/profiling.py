"""Profiling and timing hooks, the port's counterpart of
``valley_tpu/utils/profiling.py``:

* `trace(logdir)`: a context manager around a range of work, writing one
  `torch.profiler` trace (host ops, and the card's kernels where there is
  a card) into ``logdir`` as a ``*.pt.trace.json`` file, the Chrome trace
  format that TensorBoard's PyTorch profiler plugin and `read_trace` read;
* `annotate(name)`: a labelled range inside a trace
  (`torch.profiler.record_function`);
* `StepTimer`: per-step wall-clock times and their summary, with JAX's
  keys and percentile rule;
* `start_server`: refused.  JAX's ``jax.profiler.start_server`` opens a
  port that TensorBoard captures from on demand; torch has no such
  endpoint, so a trace is taken over a known range with `trace` (the
  trainer's ``profile_steps``).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Dict, List, Optional

import torch


def start_server(port: int = 9999):
    raise NotImplementedError(
        "torch has no on-demand profiler endpoint like "
        "jax.profiler.start_server: trace a range of work with "
        "profiling.trace(logdir), or a trainer's updates with profile_steps")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's work and write the trace under ``logdir``.
    The card's queue is drained before the trace stops, so kernels
    launched in the block are in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()


def annotate(name: str):
    return torch.profiler.record_function(name)


def read_trace(logdir: str) -> List[dict]:
    """The events of every trace `trace` wrote under ``logdir``."""
    events = []
    for path in sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json"))):
        with open(path) as f:
            events.extend(json.load(f).get("traceEvents", []))
    return events


def kernel_counts(logdir: str) -> Dict[str, int]:
    """{kernel name: its launches} over the card's kernels in the traces
    under ``logdir`` (empty where the traces hold host ops only)."""
    out: Dict[str, int] = {}
    for ev in read_trace(logdir):
        if ev.get("cat") == "kernel":
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


class StepTimer:
    """Per-step wall-clock times over the last ``window`` steps, with
    their mean, median, 90th percentile and rate (profiling.py:42-71)."""

    def __init__(self, window: int = 100):
        self.window = window
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        self._t0 = None
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._durations:
            return {}
        d = sorted(self._durations)
        n = len(d)
        return {
            "step_time_mean_s": sum(d) / n,
            "step_time_p50_s": d[n // 2],
            "step_time_p90_s": d[min(int(n * 0.9), n - 1)],
            "steps_per_s": n / sum(d),
        }
