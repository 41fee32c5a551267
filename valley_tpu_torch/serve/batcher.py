"""Dynamic request batching for the model worker, the port's counterpart of
``valley_tpu/serve/batcher.py`` over `Engine.generate_tokens`.

The reference serializes requests through a concurrency semaphore and runs
them one at a time (`model_worker.py:461-474`); single-stream decode
leaves most of the card's memory bandwidth idle.  The batcher collects
requests that
arrive within a small window, groups the compatible ones (same prompt
bucket, same frame count), and runs them as ONE batched engine call with
per-row temperature/top_p; each request still receives its own token
stream.

This is window-based (static) batching, not iteration-level continuous
batching: a request joins at a window boundary and rows that finish early
ride along until the whole group stops.  Each group decodes under
``lock`` (the worker's engine lock): on the card a group of B rows replays
the engine's graphs of batch B, bound to one decode state.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_DONE = object()


@dataclasses.dataclass
class _Request:
    input_ids: list
    images: Optional[np.ndarray]     # (1, T, 3, H, W) or None
    temperature: float
    top_p: float
    max_new_tokens: int
    eos_id: int
    out: "queue.Queue[Any]" = dataclasses.field(
        default_factory=lambda: queue.Queue(maxsize=1024))
    bucket: int = 0
    frames: int = 0


class DynamicBatcher:
    def __init__(self, engine, max_batch: int = 4, window_ms: float = 30.0,
                 lock=None):
        self.engine = engine
        self._lock = lock if lock is not None else threading.RLock()
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self.batches_run = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- producer side ---------------------------------------------------

    def submit(self, input_ids, images, temperature, top_p,
               max_new_tokens, eos_id) -> "queue.Queue[Any]":
        req = _Request(list(input_ids), images, float(temperature),
                       float(top_p), int(max_new_tokens), int(eos_id))
        req.bucket = self.engine.pick_bucket(len(req.input_ids))
        req.frames = 0 if images is None else images.shape[1]
        self._queue.put(req)
        return req.out

    # -- consumer loop (single thread == single model executor) ----------

    def _collect(self) -> List[_Request]:
        first = self._queue.get()
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        with torch.inference_mode():
            self._loop_body()

    def _loop_body(self):
        while True:
            batch = self._collect()
            # group compatible requests: same bucket, frame count, eos
            groups: dict = {}
            for r in batch:
                groups.setdefault((r.bucket, r.frames, r.eos_id),
                                  []).append(r)
            for group in groups.values():
                try:
                    with self._lock:
                        self._run_group(group)
                except Exception as e:  # pragma: no cover
                    logger.exception("batched generation failed")
                    for r in group:
                        r.out.put(e)
                        r.out.put(_DONE)

    def _run_group(self, group: List[_Request]):
        from valley_tpu_torch.inference.engine import GenerationConfig

        eng = self.engine
        b = len(group)
        self.batches_run += 1
        self.requests_served += b

        images = None
        if group[0].frames:
            images = np.concatenate([r.images for r in group], axis=0)
        any_sampling = any(r.temperature >= 1e-4 for r in group)
        gen = GenerationConfig(
            max_new_tokens=max(r.max_new_tokens for r in group),
            temperature=np.asarray([r.temperature for r in group],
                                   np.float32) if b > 1
            else group[0].temperature,
            top_p=np.asarray([r.top_p for r in group], np.float32)
            if b > 1 else group[0].top_p,
            do_sample=any_sampling,
            seed=int(np.random.randint(1 << 31)))

        done = [False] * b
        counts = [0] * b
        for toks in eng.generate_tokens(
                [r.input_ids for r in group], images, gen,
                eos_ids=[group[0].eos_id]):
            for i, r in enumerate(group):
                if done[i]:
                    continue
                t = int(toks[i])
                r.out.put(t)
                counts[i] += 1
                if t == r.eos_id or counts[i] >= r.max_new_tokens:
                    done[i] = True
                    r.out.put(_DONE)
            if all(done):
                break
        for i, r in enumerate(group):
            if not done[i]:
                r.out.put(_DONE)

    @staticmethod
    def drain(outq: "queue.Queue[Any]"):
        """Iterate a request's token stream until completion."""
        while True:
            item = outq.get()
            if item is _DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item
