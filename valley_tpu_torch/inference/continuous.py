"""Iteration-level continuous batching, the PyTorch counterpart of
``valley_tpu/inference/continuous.py`` (``ContinuousEngine``).

A fixed pool of B cache rows decodes in lockstep; requests join a free row
at any decode-chunk boundary (prefilled into a cache of their own, then
copied into their row of the shared cache) and leave the moment they
finish, so a long generation never blocks new arrivals.

As in the JAX pool:

* cache *slots* are decoupled from token *positions*: every row writes its
  step's K/V at its own slot with rotary position ``seq[row]`` (per-row
  slots of `llama.forward_hidden`), so rows that joined at different
  times share one (L, B, Smax, Hkv, D) cache;
* inactive rows park at slot ``smax - 1`` and still decode each step; their
  writes clamp into that slot, their output is dropped on the host, and
  their state is rewritten when a request takes the row;
* per-row temperature/top_p ride as (B,) tensors: greedy and sampled
  requests share the pool;
* non-blocking admission: a prefill thread pulls requests, prefills them at
  their own prompt bucket (the smallest engine bucket that holds the
  prompt), and parks the result on a bounded queue; the decode loop splices
  parked rows in at chunk boundaries;
* batched admission: compatible waiting requests (same admission bucket,
  frame count and sampling mode) prefill as one call of a power-of-two
  size up to ``admit_batch``;
* prompt-pad compaction: decode writes start at slot ``len(prompt)``, so a
  row supports ``smax - len(prompt)`` new tokens.

Not ported: speculative decoding in the pool and admission from a
``PrefixCache`` (``speculative=True`` and ``submit(prefix=...)`` raise
NotImplementedError).

PyTorch runs eagerly, so a pooled decode chunk is ``steps`` single-token
steps (a ``ramp`` of shorter chunks while a young row is in the pool), with
one device-to-host copy of the chunk's tokens, as ``Engine._decode`` does.
Two threads drive the device, the prefill thread and the decode loop.
Both launch on the same current stream, so a parked cache that the prefill
thread wrote is complete before the decode loop's copy of it runs, in
stream order.  ``torch.inference_mode`` is entered in each thread (it is
thread-local), and each thread samples from a `torch.Generator` of its own
(a generator is not thread-safe).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from valley_tpu_torch.inference.engine import Engine, sample_token
from valley_tpu_torch.models import llama

logger = logging.getLogger(__name__)

_DONE = object()


@dataclasses.dataclass
class _Request:
    input_ids: list
    images: Optional[np.ndarray]
    temperature: float
    top_p: float
    max_new_tokens: int
    eos_id: int
    out: "queue.Queue[Any]" = dataclasses.field(
        default_factory=lambda: queue.Queue(maxsize=4096))
    emitted: int = 0


class ContinuousEngine:
    """A pool of ``rows`` cache rows of ``bucket + extra_slots`` slots over
    ``engine``'s weights; `submit` queues a request and returns the queue
    its tokens arrive on (then `_DONE`, or an exception and `_DONE`).

    ``steps_run`` counts the pooled decode steps run and
    ``prefill_sizes`` the rows of each admission prefill, so a caller can
    tell how many launches the pool's kernels made."""

    def __init__(self, engine: Engine, rows: int = 4,
                 bucket: Optional[int] = None,
                 extra_slots: Optional[int] = None,
                 steps_per_call: Optional[int] = None,
                 decode_ramp: Optional[Any] = None,
                 speculative: bool = False,
                 spec: Optional[Any] = None,
                 admit_batch: int = 4):
        if speculative or spec is not None:
            raise NotImplementedError(
                "speculative decoding in the pool is not ported yet")
        self.engine = engine
        self.rows = rows
        self.bucket = bucket or engine.buckets[-1]
        extra = extra_slots if extra_slots is not None \
            else engine.max_new_tokens
        self.smax = self.bucket + extra
        self.steps = steps_per_call or engine.steps_per_call
        # the pooled decode ramp: while an active row has emitted fewer
        # tokens than the ramp covers, the pool decodes in that row's next
        # ramp-size chunk; greedy output does not depend on the chunking
        self.ramp = tuple(int(s) for s in decode_ramp) \
            if decode_ramp is not None else engine.decode_ramp
        dev = engine.device
        self._decode_gen = torch.Generator(dev).manual_seed(0)
        self._prefill_gen = torch.Generator(dev).manual_seed(1)
        # prefills run in the prefill thread, and in the caller's during
        # `warmup`: one at a time, so they share the generator safely
        self._prefill_lock = threading.Lock()
        self.steps_run = 0
        self.prefill_sizes: List[int] = []

        self._active: List[Optional[_Request]] = [None] * rows
        self._reset_pool()

        # admission buckets: engine prefill buckets that fit in the pool;
        # a request prefills at the smallest one that holds its prompt
        self._admission_buckets = tuple(
            b for b in engine.buckets if b <= self.bucket) or (self.bucket,)
        if self.bucket not in self._admission_buckets:
            self._admission_buckets = self._admission_buckets + (
                self.bucket,)
        self.admit_batch = max(1, int(admit_batch))
        self._admit_sizes = tuple(
            1 << i for i in range(self.admit_batch.bit_length())
            if (1 << i) <= self.admit_batch)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # each parked item references one row of a prefilled cache on the
        # device; a partly inserted group keeps its whole cache alive, so
        # at most ready_depth + admit_batch - 1 rows are parked
        self.ready_depth = min(8, max(2, rows))
        self._ready: "queue.Queue[tuple]" = queue.Queue(
            maxsize=self.ready_depth)
        self._wake = threading.Event()
        self._closed = False
        self._prefill_thread = threading.Thread(target=self._prefill_loop,
                                                daemon=True)
        self._prefill_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _reset_pool(self):
        """(Re)build the pool's device state; also the recovery path after
        a failed decode chunk, which may have left the cache half written."""
        cfg, rows, dev = self.engine.cfg, self.rows, self.engine.device
        self._cache = llama.init_cache(cfg.text, rows, self.smax,
                                       self.engine.cache_dtype, dev)
        self._valid = torch.zeros((rows, self.smax), dtype=torch.bool,
                                  device=dev)
        self._seq = torch.zeros((rows,), dtype=torch.int64, device=dev)
        self._slot = torch.full((rows,), self.smax - 1, dtype=torch.int64,
                                device=dev)
        self._token = torch.zeros((rows,), dtype=torch.int64, device=dev)
        self._temps = np.zeros((rows,), np.float32)
        self._top_ps = np.ones((rows,), np.float32)

    # -- device state transforms (JAX continuous.py:220-279) ---------------

    def _decode_chunk(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` pooled single-token steps; every row writes at its
        own slot (clamped into the cache for parked rows) and samples with
        its own temperature/top_p.  Returns the tokens (n_steps, rows)."""
        eng = self.engine
        p, text, dev = eng.params["llama"], eng.cfg.text, eng.device
        rows = torch.arange(self.rows, device=dev)
        temps = torch.from_numpy(self._temps).to(dev)
        top_ps = torch.from_numpy(self._top_ps).to(dev)
        token, slot, seq = self._token, self._slot, self._seq
        toks = []
        for _ in range(n_steps):
            self._valid[rows, slot.clamp(max=self.smax - 1)] = True
            hidden, _ = llama.forward_hidden(
                p, text, llama.embed(p, token[:, None]),
                positions=seq[:, None], cache=self._cache, cache_index=slot,
                kv_valid=self._valid, attention=eng.attention)
            logits = llama.logits_from_hidden(p, hidden, eng.attention)[:, 0]
            token = sample_token(logits, self._decode_gen, temps, top_ps,
                                 do_sample=True)
            toks.append(token)
            seq, slot = seq + 1, slot + 1
            self.steps_run += 1
        self._token, self._slot, self._seq = token, slot, seq
        return torch.stack(toks)

    def _insert(self, row_cache: llama.KVCache, row_valid: torch.Tensor,
                row_tok: torch.Tensor, n: int, src: int, b: int) -> None:
        """Copy row ``src`` of a parked batch cache (values and any int8
        scales), its validity and first token into pool row ``b``; decode
        writes start right after the prompt, at slot ``n``."""
        for name in ("k", "v", "k_scale", "v_scale"):
            dst = getattr(self._cache, name)
            if dst is not None:
                dst[:, b].copy_(getattr(row_cache, name)[:, src])
        self._valid[b].copy_(row_valid[src])
        self._token[b] = row_tok[src]
        self._slot[b] = n
        self._seq[b] = n

    # -- public API --------------------------------------------------------

    def submit(self, input_ids, images=None, temperature: float = 0.0,
               top_p: float = 1.0, max_new_tokens: int = 256,
               eos_id: int = 2, prefix=None) -> "queue.Queue[Any]":
        """Queue a request: ``input_ids``, its (1, T, 3, H, W) frames or
        None, its sampling settings and limits.  Returns the queue its
        tokens arrive on (read it with `_drain`)."""
        if prefix is not None:
            raise NotImplementedError(
                "admission from a PrefixCache is not ported yet")
        if self._closed:
            raise RuntimeError("the pool is closed")
        req = _Request(list(input_ids), images, float(temperature),
                       float(top_p), int(max_new_tokens), int(eos_id))
        self._queue.put(req)
        self._wake.set()
        return req.out

    def warmup(self, frames=0) -> None:
        """Run every admission-bucket prefill (at every batched admission
        size, greedy and sampled) and every pooled chunk size once, as the
        JAX pool does to compile them; here it initialises the device
        libraries and builds the kernels before traffic arrives.
        ``frames``: a frame count or a sequence of them (0: text only,
        always included)."""
        frame_list = ((frames,) if isinstance(frames, int) else
                      tuple(frames)) or (0,)
        if 0 not in frame_list:
            frame_list = frame_list + (0,)
        v = self.engine.cfg.vision
        media = [np.zeros((1, t, 3, v.image_size, v.image_size), np.uint8)
                 if t else None for t in frame_list]

        def feasible(bucket, images):
            if images is None:
                return True
            return bucket >= self.engine.cfg.num_patches + images.shape[1] + 4

        for images in media:
            for bucket in self._admission_buckets:
                if not feasible(bucket, images):
                    continue
                for size in self._admit_sizes:
                    if size == 1:
                        continue   # covered by the submits below
                    for temp in (0.0, 0.7):
                        group = [_Request(list(range(2, 2 + bucket)),
                                          images, temp, 1.0, 1, -1)
                                 for _ in range(size)]
                        for item in self._prefill_group(group):
                            self._park(item)
                        for r in group:
                            for _ in _drain(r.out):
                                pass
        new = 1 + sum(self.ramp) + self.steps
        queues = [self.submit(list(range(2, 2 + b)), images=images,
                              max_new_tokens=new, eos_id=-1,
                              temperature=temp)
                  for images in media
                  for b in self._admission_buckets
                  if feasible(b, images)
                  for temp in (0.0, 0.7)]
        for outq in queues:
            for _ in _drain(outq):
                pass

    def close(self, timeout: float = 30.0) -> None:
        """Stop both threads; every request not finished gets an error."""
        self._closed = True
        self._queue.put(None)
        self._wake.set()
        self._prefill_thread.join(timeout)
        self._thread.join(timeout)
        closed = RuntimeError("the pool was closed")
        self._fail_active(closed)
        for q in (self._ready, self._queue):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                _refuse(item[0] if isinstance(item, tuple) else item, closed)

    # -- prefill worker (admission never blocks the decode loop) -----------

    def _admit_key(self, req: _Request):
        """Requests sharing this key prefill as one batched call: the same
        admission bucket, frame count and sampling mode."""
        n = len(req.input_ids)
        bucket = next((b for b in self._admission_buckets if n <= b), None)
        frames = None
        if req.images is not None:
            shape = np.asarray(req.images).shape
            frames = shape[1] if len(shape) >= 2 else None
        return (bucket, frames, req.temperature >= 1e-4)

    def _park(self, item) -> None:
        """Put a prefilled row on the ready queue, waiting while it is full
        (until the pool closes)."""
        while not self._closed:
            try:
                self._ready.put(item, timeout=0.5)
            except queue.Full:
                continue
            self._wake.set()
            return

    def _prefill_loop(self):
        with torch.inference_mode():
            self._prefill_loop_body()

    def _prefill_loop_body(self):
        pending: List[_Request] = []
        while not self._closed:
            if not pending:
                pending.append(self._queue.get())
            # take whatever else is waiting, so a burst admits batched
            while len(pending) < 4 * self.admit_batch:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if any(r is None for r in pending):   # closed
                for r in pending:
                    _refuse(r, RuntimeError("the pool was closed"))
                return
            head = pending.pop(0)
            group = [head]
            if self.admit_batch > 1:
                key0 = self._admit_key(head)
                i = 0
                while i < len(pending) and len(group) < self.admit_batch:
                    if self._admit_key(pending[i]) == key0:
                        group.append(pending.pop(i))
                    else:
                        i += 1
                # power-of-two group sizes; the overflow returns to the
                # front of the queue in order
                size = max(s for s in self._admit_sizes if s <= len(group))
                pending[:0] = group[size:]
                group = group[:size]
            try:
                items = (self._prefill_group(group) if len(group) > 1
                         else [self._prefill_one(group[0])])
            except Exception as e:  # noqa: BLE001 -- deliver, don't die
                logger.exception("prefill failed for request(s)")
                for r in group:
                    _refuse(r, e)
                continue
            for item in items:
                self._park(item)

    def _prefill_group(self, group: List[_Request]) -> list:
        """One batched prefill of ``len(group)`` compatible requests into a
        cache of the pool's ``smax`` slots; returns one ready item per
        request: (request, tokens, cache, valid, prompt length, row).  The
        whole batch's cache is parked and each item inserts its own row
        from it.  Greedy output equals per-request prefills (the model's
        rows are independent)."""
        eng = self.engine
        dev = eng.device
        b = len(group)
        lens = np.asarray([len(r.input_ids) for r in group], np.int64)
        n_max = int(lens.max())
        if n_max > self.bucket:
            raise ValueError(f"prompt of {n_max} tokens exceeds the "
                             f"{self.bucket}-token admission bucket")
        if n_max >= self.smax:
            raise ValueError(f"prompt of {n_max} tokens leaves no decode "
                             f"slots (pool smax={self.smax})")
        if int(lens.min()) == 0:
            raise ValueError("every prompt must contain at least one token")
        bucket = next(bk for bk in self._admission_buckets if n_max <= bk)
        ids = np.zeros((b, bucket), np.int64)
        for i, r in enumerate(group):
            ids[i, :lens[i]] = r.input_ids
        images = None
        if group[0].images is not None:
            # uint8 frames stay uint8 (normalised on the device); anything
            # else goes as float
            arrs = [np.asarray(r.images) for r in group]
            if any(a.dtype != np.uint8 for a in arrs):
                arrs = [np.asarray(a, np.float32) for a in arrs]
            images = np.concatenate(arrs, axis=0)
        temps = torch.tensor([r.temperature for r in group],
                             dtype=torch.float32, device=dev)
        top_ps = torch.tensor([r.top_p for r in group], dtype=torch.float32,
                              device=dev)
        with self._prefill_lock:
            tok, _logits, cache, valid = eng._prefill(
                torch.from_numpy(ids).to(dev),
                eng._prepare_images(images, b),
                torch.from_numpy(lens).to(dev), self._prefill_gen, temps,
                top_ps, group[0].temperature >= 1e-4, self.smax)
            self.prefill_sizes.append(b)
        return [(r, tok, cache, valid, int(lens[i]), i)
                for i, r in enumerate(group)]

    def _prefill_one(self, req: _Request):
        """A single request's admission: `_prefill_group` of one."""
        return self._prefill_group([req])[0]

    # -- scheduler loop ----------------------------------------------------

    def _next_chunk(self) -> int:
        """Steps of the next pooled decode chunk: the smallest
        next-scheduled size over active rows, a ramp entry while any row is
        inside the ramp, ``steps`` once every row has matured."""
        if not self.ramp:
            return self.steps
        best = self.steps
        for req in self._active:
            if req is None:
                continue
            done = req.emitted - 1   # tokens from pooled decode so far
            acc = 0
            for r in self.ramp:
                acc += r
                if done < acc:
                    best = min(best, r)
                    break
        return best

    def _admit(self):
        """Insert parked rows into free pool rows, then move all their
        first tokens to the host in one copy and emit them."""
        admitted = []
        for b in range(self.rows):
            if self._active[b] is not None:
                continue
            try:
                req, tok, row_cache, row_valid, n, src = \
                    self._ready.get_nowait()
            except queue.Empty:
                break
            try:
                self._insert_row(req, tok, row_cache, row_valid, n, src, b)
            except Exception as e:  # noqa: BLE001 -- deliver, don't die
                logger.exception("row insert failed")
                _refuse(req, e)
                self._fail_active(RuntimeError("pool reset"))
                self._reset_pool()
                return
            admitted.append((b, req, tok, src))
        if not admitted:
            return
        firsts = torch.stack([tok[src] for _, _, tok, src in admitted]).cpu()
        for (b, req, _, _), t in zip(admitted, firsts.tolist()):
            req.out.put(t)
            req.emitted = 1
            self._finish_if_done(b, t)

    def _insert_row(self, req, tok, row_cache, row_valid, n: int, src: int,
                    b: int):
        self._insert(row_cache, row_valid, tok, n, src, b)
        self._active[b] = req
        self._temps[b] = req.temperature
        self._top_ps[b] = req.top_p
        # cap generation to the slots left after the (compacted) prompt
        req.max_new_tokens = min(req.max_new_tokens, self.smax - n)

    def _finish_if_done(self, b: int, tok: int):
        req = self._active[b]
        if req is None:
            return
        if tok == req.eos_id or req.emitted >= req.max_new_tokens:
            req.out.put(_DONE)
            self._active[b] = None
            self._temps[b] = 0.0

    def _fail_active(self, err: Exception) -> None:
        for b, req in enumerate(self._active):
            if req is not None:
                _refuse(req, err)
                self._active[b] = None

    def _loop(self):
        with torch.inference_mode():
            self._loop_body()

    def _loop_body(self):
        while not self._closed:
            if all(r is None for r in self._active) and \
                    self._ready.empty():
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            self._admit()
            if all(r is None for r in self._active):
                continue
            n_steps = self._next_chunk()
            try:
                toks_np = self._decode_chunk(n_steps).cpu().numpy()
            except Exception as e:  # noqa: BLE001 -- deliver, don't die
                logger.exception("decode chunk failed")
                self._fail_active(e)
                # the cache may be half written
                self._reset_pool()
                continue
            for step in range(toks_np.shape[0]):
                for b in range(self.rows):
                    req = self._active[b]
                    if req is None:
                        continue
                    # tokens decoded after a row finished within the chunk
                    # are dropped (they stay masked off for the next request)
                    t = int(toks_np[step, b])
                    req.out.put(t)
                    req.emitted += 1
                    self._finish_if_done(b, t)


def _refuse(req: Optional[_Request], err: Exception) -> None:
    """End a request with ``err`` (None: the close sentinel, nothing)."""
    if req is not None:
        req.out.put(err)
        req.out.put(_DONE)


def _drain(outq, timeout: Optional[float] = None):
    """Yield a request's tokens until it is done; raise the exception the
    pool delivered, or `queue.Empty` when ``timeout`` seconds pass without
    an item."""
    while True:
        item = outq.get(timeout=timeout)
        if item is _DONE:
            return
        if isinstance(item, Exception):
            raise item
        yield item
