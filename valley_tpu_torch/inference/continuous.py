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
  row supports ``smax - len(prompt)`` new tokens;
* speculative mode (``speculative=True``): each pooled "step" is a verify
  round (`graphs.spec_round`) that drafts per row from the row's own token
  history and advances each row by its own 1 + m accepted tokens; greedy
  rows verify against their argmax as a point mass, so one graph serves
  any mix of greedy and sampled rows.  When the pool's acceptance EMA
  falls below `speculative.resolved_disable_below` the pool decodes plain
  chunks (still appending to the histories) and re-probes every
  ``reprobe_chunks`` chunks.  At B (D + 1) rows the verify products are
  plain matrix products, which the JAX package leaves to XLA and the port
  to the library;
* prefix admission (``submit(prefix=...)``, JAX continuous.py:571): a
  request whose prompt starts with a `PrefixCache`'s ids admits from its
  cached KV fragment: the fragment is padded into a row, extended by the
  request's suffix (`Engine._extend`, a pow-2 chunk) and compacted, so the
  row has the shape a plainly prefilled row has (slot = position = its
  live tokens); such requests admit one at a time.

A pooled decode chunk is ``steps`` single-token steps or verify rounds (a
``ramp`` of shorter chunks while a young row is in the pool), with one
device-to-host copy of the chunk's tokens.  On the card the chunk is one
replay of a CUDA graph of ``n_steps`` steps (or rounds) over the pool's
state (``inference/graphs.py``), one graph per chunk size and kind, as the
JAX pool compiles one executable per ``n_steps``: the state is fixed and
the pool always samples.  The graphs
are captured by the decode loop the first time a size runs (`warmup` runs
every size), holding ``_prefill_lock``: capture is global, so no other
thread may make a CUDA call meanwhile, and every CUDA call of the prefill
thread is made under that lock.  A failed chunk resets the pool's state
and drops its graphs, which are captured again.  On the CPU, or with
``eager=True``, the same steps run eagerly.

Two threads drive the device, the prefill thread and the decode loop.
Both launch on the same current stream, so a parked cache that the prefill
thread wrote is complete before the decode loop's copy of it runs, in
stream order.  ``torch.inference_mode`` is entered in each thread (it is
thread-local), and each thread samples from a `torch.Generator` of its own
(a generator is not thread-safe).

On a mesh (``Engine(mesh=)``, one process a device) every rank runs the
same pool, and every device call must come in the same order on every rank
(the collectives pair up by order).  The pool then runs under the
process's `parallel.lockstep.Lockstep`, made by the lead (rank 0) through
`lockstep.make(..., proxy=False)`: the lead's `submit` sends each request
to every rank, and its one loop thread (no prefill thread) decides each
iteration on the host (which waiting requests to admit, from what arrived
by then; the chunk's size and kind, from its clock-free schedule and the
speculative control) and sends it as two calls, the admission
(`_tp_admit`) and the chunk (`_run_chunk`), which every rank makes under
the lock.  The followers' pools run no thread and deliver no tokens.  A
failed prefill, insert or chunk is then not recovered from on its rank (a
request refused alike on every rank aside): it goes on to the lockstep,
which stops the world.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from valley_tpu_torch.inference.engine import (Engine, _compact_cache,
                                               _grow_cache)
from valley_tpu_torch.inference.graphs import (DecodeGraphs, DecodeState,
                                               SpecState, spec_round)
from valley_tpu_torch.inference.speculative import (SpecConfig,
                                                    resolved_disable_below)
from valley_tpu_torch.models import llama
from valley_tpu_torch.parallel import lockstep

logger = logging.getLogger(__name__)

_DONE = object()


class _Sink:
    """A follower rank's request queue: its tokens reach no reader."""

    def put(self, _item) -> None:
        pass


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
    prefix: Any = None       # a PrefixCache its input_ids start with
    seq: int = 0             # its place in submission order


class ContinuousEngine:
    """A pool of ``rows`` cache rows of ``bucket + extra_slots`` slots over
    ``engine``'s weights; `submit` queues a request and returns the queue
    its tokens arrive on (then `_DONE`, or an exception and `_DONE`).

    ``steps_run`` counts the pooled decode steps run, ``rounds_run`` the
    pooled verify rounds, ``prefill_sizes`` the rows of each admission
    prefill and ``prefix_chunks`` the suffix chunk of each admission from a
    prefix (`Engine._extend`), so a caller can tell how many launches the
    pool's kernels made; ``spec_rounds``, ``spec_emitted``, ``spec_disables`` and
    ``spec_reprobes`` are the speculative telemetry (row rounds, their
    tokens, pauses, re-probes).
    ``eager=True`` decodes without graphs on the card (the reference the
    graphs are held to)."""

    def __init__(self, engine: Engine, rows: int = 4,
                 bucket: Optional[int] = None,
                 extra_slots: Optional[int] = None,
                 steps_per_call: Optional[int] = None,
                 decode_ramp: Optional[Any] = None,
                 speculative: bool = False,
                 spec: Optional[Any] = None,
                 admit_batch: int = 4,
                 eager: bool = False):
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
        # `warmup`: one at a time, so they share the generator safely; the
        # decode loop holds it while it captures a graph, and a serving
        # worker while it runs the engine outside the pool (reentrant, so
        # that such a caller may nest it)
        self._prefill_lock = threading.RLock()
        self.graphs_on = engine.use_graphs and not eager
        self.steps_run = 0
        self.rounds_run = 0
        self.prefill_sizes: List[int] = []
        self.prefix_chunks: List[int] = []

        # speculative mode (JAX continuous.py:103-131): a round emits 1 ..
        # D + 1 tokens per row; the history holds a row's prompt and every
        # token it emitted
        self._spec = (spec or SpecConfig()) if speculative else None
        if self._spec is not None:
            self.hist_max = self.smax + self._spec.draft_len + 1
        # the pool-wide acceptance-adaptive control: below break-even the
        # pool decodes plain chunks and re-probes every reprobe_chunks
        self._spec_live = True
        self._plain_left = 0
        self._acc_ema: Optional[float] = None
        self._warming = False
        self.spec_rounds = 0
        self.spec_emitted = 0
        self.spec_disables = 0
        self.spec_reprobes = 0
        # warmup's chunk sizes, overriding the ramp for the next chunks
        self._force_chunks: List[int] = []

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
        self._wake = threading.Event()
        self._closed = False
        self._prefill_thread = self._thread = None
        self._lockstep = None
        if engine.mesh is not None:
            self._lockstep = lockstep.current()
            if self._lockstep is None:
                raise RuntimeError(
                    "a pool over a mesh runs its ranks in lockstep: make a "
                    "parallel.lockstep.Lockstep on every rank and the pool "
                    "on the lead with lockstep.make(..., proxy=False)")
            # requests waiting for admission, in submission order; the
            # admission's items park unbounded (the lead admits no more
            # than there are free rows)
            self._pending: List[_Request] = []
            self._seq = 0
            self._ready: "queue.Queue[tuple]" = queue.Queue()
            return
        self._ready = queue.Queue(maxsize=self.ready_depth)
        self._prefill_thread = threading.Thread(target=self._prefill_loop,
                                                daemon=True)
        self._prefill_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _reset_pool(self):
        """(Re)build the pool's device state and drop its graphs (captured
        again at their next chunk); also the recovery path after a failed
        decode chunk, which may have left the cache half written."""
        eng = self.engine
        self._state = DecodeState.empty(eng, self.rows, self.smax)
        if self._spec is not None:
            self._state = SpecState.over(self._state, self.hist_max)
        self._graphs = self._spec_graphs = None
        if self.graphs_on:
            self._graphs = DecodeGraphs(self._state, eng._step,
                                        self._decode_gen)
            if self._spec is not None:
                self._spec_graphs = DecodeGraphs(
                    self._state, self._spec_step, self._decode_gen,
                    self._graphs.pool)
        self._temps = np.zeros((self.rows,), np.float32)
        self._top_ps = np.ones((self.rows,), np.float32)

    # -- device state transforms (JAX continuous.py:220-279) ---------------

    def _load_sampling(self, graphs: Optional[DecodeGraphs],
                       n_steps: int) -> None:
        """Refill the rows' temperature/top_p, and capture ``graphs``'
        graph of ``n_steps`` if it is not yet captured."""
        s = self._state
        s.temperature.copy_(torch.from_numpy(self._temps))
        s.top_p.copy_(torch.from_numpy(self._top_ps))
        if graphs is not None and (n_steps, True) not in graphs.keys():
            with self._prefill_lock:
                graphs.capture(n_steps, True)

    def _decode_chunk(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` pooled single-token steps; every row writes at its
        own slot (clamped into the cache for parked rows) and samples with
        its own temperature/top_p.  Returns the tokens (n_steps, rows)."""
        self._load_sampling(self._graphs, n_steps)
        self.steps_run += n_steps
        return self.engine._decode_chunk(self._state, n_steps, True,
                                         self._decode_gen, self._graphs)

    def _spec_step(self, state: SpecState, generator, do_sample: bool):
        eng = self.engine
        return spec_round(eng.params["llama"], eng.cfg.text, eng.attention,
                          state, generator, do_sample, self._spec.draft_len,
                          self._spec.ngram)

    def _spec_chunk(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` pooled verify rounds (JAX continuous.py:281-350):
        each row drafts from its own history and advances by its own 1 + m.
        Returns (n_steps, rows, D + 2): each round's tokens and counts."""
        self._load_sampling(self._spec_graphs, n_steps)
        self.rounds_run += n_steps
        if self._spec_graphs is not None:
            return self._spec_graphs.run(n_steps, True)
        return torch.stack([self._spec_step(self._state, self._decode_gen,
                                            True) for _ in range(n_steps)])

    def _append_hist(self, toks: torch.Tensor) -> None:
        """Append a plain chunk's tokens (n_steps, rows) to every row's
        history, so that a re-probe drafts from fresh context (JAX
        continuous.py:365-377; a start near the end clamps)."""
        s = self._state
        n = toks.shape[0]
        start = s.hist_len.clamp(max=self.hist_max - n)
        s.hist.scatter_(1, start[:, None] + torch.arange(
            n, device=toks.device), toks.t())
        s.hist_len.add_(n)

    def _insert(self, row_cache: llama.KVCache, row_valid: torch.Tensor,
                row_tok: torch.Tensor, n: int, src: int, b: int) -> None:
        """Copy row ``src`` of a parked batch cache (values and any int8
        scales), its validity and first token into pool row ``b``; decode
        writes start right after the prompt, at slot ``n``."""
        s = self._state
        for name in ("k", "v", "k_scale", "v_scale"):
            dst = getattr(s.cache, name)
            if dst is not None:
                dst[:, b].copy_(getattr(row_cache, name)[:, src])
        s.valid[b].copy_(row_valid[src])
        s.token[b] = row_tok[src]
        s.slot[b] = n
        s.seq[b] = n

    # -- public API --------------------------------------------------------

    def submit(self, input_ids, images=None, temperature: float = 0.0,
               top_p: float = 1.0, max_new_tokens: int = 256,
               eos_id: int = 2, prefix=None) -> "queue.Queue[Any]":
        """Queue a request: ``input_ids``, its (1, T, 3, H, W) frames or
        None, its sampling settings and limits.  Returns the queue its
        tokens arrive on (read it with `_drain`).  With ``prefix`` (a
        `PrefixCache` of this pool's engine whose ids ``input_ids`` start
        with; no ``images``: the prefix holds the media) the request admits
        from the cached prefix, prefilling only its suffix."""
        if self._closed:
            raise RuntimeError("the pool is closed")
        if prefix is not None and images is not None:
            raise ValueError("a prefix request takes no images: its "
                             "PrefixCache holds the media")
        if self._lockstep is not None:
            self._start_tp_loop()
            return self._lockstep.call(
                self, "_enqueue", list(input_ids), images, float(temperature),
                float(top_p), int(max_new_tokens), int(eos_id), prefix)
        req = _Request(list(input_ids), images, float(temperature),
                       float(top_p), int(max_new_tokens), int(eos_id),
                       prefix=prefix)
        self._queue.put(req)
        self._wake.set()
        return req.out

    # -- lockstep (a pool over a mesh; module docstring) -------------------

    def _start_tp_loop(self) -> None:
        """The lead's loop thread, started at the first request (the pool
        is registered with the lockstep by then)."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._tp_loop,
                                            daemon=True)
            self._thread.start()

    def _enqueue(self, input_ids, images, temperature, top_p,
                 max_new_tokens, eos_id, prefix):
        """Every rank's half of a lead's `submit`: the request waits in
        submission order; a follower's delivers nowhere."""
        req = _Request(input_ids, images, temperature, top_p, max_new_tokens,
                       eos_id, prefix=prefix, seq=self._seq)
        if not self._lockstep.lead:
            req.out = _Sink()
        self._seq += 1
        self._pending.append(req)
        self._wake.set()
        return req.out

    def _plan_admission(self) -> List[List[int]]:
        """The lead's choice of the next admission: groups (by submission
        number) of the waiting requests, as the prefill thread groups
        them, no more than there are free rows."""
        free = sum(r is None for r in self._active) - self._ready.qsize()
        pending = list(self._pending)
        groups = []
        while free > 0 and pending:
            group, pending = self._take_group(pending, free)
            groups.append([r.seq for r in group])
            free -= len(group)
        return groups

    def _tp_admit(self, groups: List[List[int]]) -> None:
        """Every rank: prefill the lead's groups, park them, and insert
        what fits into free rows (`_admit`)."""
        for seqs in groups:
            group = [r for r in self._pending if r.seq in seqs]
            self._pending = [r for r in self._pending if r.seq not in seqs]
            for item in self._prefill_items(group):
                self._park(item)
        self._admit()

    def _tp_loop(self):
        with torch.inference_mode():
            while not self._closed:
                if all(r is None for r in self._active) and \
                        self._ready.empty() and not self._pending:
                    self._wake.wait(timeout=1.0)
                    self._wake.clear()
                    continue
                with self._prefill_lock:
                    self._lockstep.call(self, "_tp_admit",
                                        self._plan_admission())
                    if any(r is not None for r in self._active):
                        self._lockstep.call(self, "_run_chunk",
                                            *self._decide_chunk())

    def warmup(self, frames=0) -> None:
        """Run every admission-bucket prefill (at every batched admission
        size, greedy and sampled) and every pooled chunk size once, as the
        JAX pool does to compile them; here it builds the kernels and, on
        the card, captures the graph of every chunk size before traffic
        arrives (in speculative mode every round count and the plain
        fallback's chunks too).  ``frames``: a frame count or a sequence of
        them (0: text only, always included)."""
        self._warming = True   # the adaptive control must not switch modes
        try:
            self._warmup_body(frames)
        finally:
            self._warming = False
            self.reset_speculation()

    def pause_speculation(self, chunks: int) -> None:
        """Decode the next ``chunks`` chunks plain, then re-probe, as the
        adaptive control does below its threshold."""
        self._spec_live = False
        self._plain_left = chunks

    def reset_speculation(self) -> None:
        """Speculate again from the next chunk, with no acceptance history
        and the telemetry at 0 (after a warm-up)."""
        self._spec_live = True
        self._plain_left = 0
        self._acc_ema = None
        self.spec_rounds = self.spec_emitted = self.spec_disables = 0
        self.spec_reprobes = 0

    def _warmup_body(self, frames) -> None:
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
                        if self._lockstep is None:
                            outs = self._warm_group(bucket, images, size,
                                                    temp)
                        else:
                            self._start_tp_loop()
                            outs = self._lockstep.call(
                                self, "_warm_group", bucket, images, size,
                                temp)
                        for outq in outs:
                            for _ in _drain(outq):
                                pass
        new = 1 + sum(self.ramp) + self.steps
        # one request alone first: it decodes every ramp size, then steps
        for _ in _drain(self.submit([2, 3], max_new_tokens=new, eos_id=-1)):
            pass
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
        if self._spec is not None:
            # a round emits 1 .. D + 1 tokens, so the token-counted ramp
            # above visits the round counts by acceptance: force one chunk
            # of every scheduled size, with a budget no such chunk can
            # exhaust (JAX continuous.py:483-512)
            sizes = sorted(set(self.ramp) | {self.steps})
            short = list(range(2, 2 + self._admission_buckets[0]))
            self._force_chunks = list(sizes)
            for _ in _drain(self.submit(
                    short, max_new_tokens=sum(sizes)
                    * (self._spec.draft_len + 1) + 2, eos_id=-1)):
                pass
            # and the plain fallback's chunks
            self.pause_speculation(1 << 30)
            self._force_chunks = list(sizes)
            for _ in _drain(self.submit(short, max_new_tokens=sum(sizes) + 2,
                                        eos_id=-1)):
                pass
            self._force_chunks = []

    def _warm_group(self, bucket: int, images, size: int, temp: float):
        """One batched admission of ``size`` warm-up requests, parked for
        the decode loop; their queues."""
        group = [_Request(list(range(2, 2 + bucket)), images, temp, 1.0, 1,
                          -1) for _ in range(size)]
        if self._lockstep is not None and not self._lockstep.lead:
            for r in group:
                r.out = _Sink()
        for item in self._prefill_group(group):
            self._park(item)
        return [r.out for r in group]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the threads; every request not finished gets an error."""
        self._closed = True
        self._queue.put(None)
        self._wake.set()
        for th in (self._prefill_thread, self._thread):
            if th is not None:
                th.join(timeout)
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

    def _take_group(self, pending: List[_Request], most: int):
        """The next admission group from the front of ``pending`` (its
        head and the compatible requests after it, a power-of-two count of
        at most ``admit_batch`` and ``most``), and the rest in order."""
        pending = list(pending)
        head = pending.pop(0)
        group = [head]
        if head.prefix is None and self.admit_batch > 1:
            key0 = self._admit_key(head)
            i = 0
            while i < len(pending) and len(group) < min(self.admit_batch,
                                                        most):
                r = pending[i]
                if r.prefix is None and self._admit_key(r) == key0:
                    group.append(pending.pop(i))
                else:
                    i += 1
            # power-of-two group sizes; the overflow returns to the
            # front of the queue in order
            size = max(s for s in self._admit_sizes if s <= len(group))
            pending[:0] = group[size:]
            group = group[:size]
        return group, pending

    def _prefill_items(self, group: List[_Request]) -> list:
        """The ready items of one admission group; a failed prefill
        refuses the group's requests and gives none."""
        try:
            return (self._prefill_group(group) if len(group) > 1
                    else [self._prefill_one(group[0])])
        except Exception as e:  # noqa: BLE001 -- deliver, don't die
            if self._stops_world(e):
                raise
            logger.exception("prefill failed for request(s)")
            for r in group:
                _refuse(r, e)
            return []

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
            group, pending = self._take_group(pending, self.admit_batch)
            for item in self._prefill_items(group):
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
        # every CUDA call of a prefill is made under the lock (see the
        # module docstring)
        with self._prefill_lock:
            temps = torch.tensor([r.temperature for r in group],
                                 dtype=torch.float32, device=dev)
            top_ps = torch.tensor([r.top_p for r in group],
                                  dtype=torch.float32, device=dev)
            tok, _logits, cache, valid = eng._prefill(
                torch.from_numpy(ids).to(dev),
                eng._prepare_images(images, b),
                torch.from_numpy(lens).to(dev), self._prefill_gen, temps,
                top_ps, group[0].temperature >= 1e-4, self.smax)
            self.prefill_sizes.append(b)
        return [(r, tok, cache, valid, int(lens[i]), i)
                for i, r in enumerate(group)]

    def _prefill_one(self, req: _Request):
        """A single request's admission: `_prefill_from_prefix` for a
        prefix request, else `_prefill_group` of one."""
        if req.prefix is not None:
            return self._prefill_from_prefix(req)
        return self._prefill_group([req])[0]

    def _prefill_from_prefix(self, req: _Request):
        """Admission from a `PrefixCache` (JAX continuous.py:571-616): the
        cached (system prompt and media) fragment grown into a row big
        enough for it and the suffix's pow-2 chunk, extended by the suffix
        (`Engine._extend`, sampling the first token at the request's
        settings), compacted and cut to the pool's ``smax`` slots.  The
        compacted row has slot = position = its live tokens, the shape a
        plainly prefilled row has.  Returns one ready item."""
        eng = self.engine
        dev = eng.device
        pc = req.prefix
        pre = list(pc.prefix_ids)
        if req.input_ids[:len(pre)] != pre:
            raise ValueError("input_ids do not start with the prefix")
        suffix = req.input_ids[len(pre):]
        c = len(suffix)
        if c == 0:
            raise ValueError("no suffix tokens after the prefix")
        cb = 1 << max(4, (c - 1).bit_length())   # pow-2 chunk >= 16
        # the fragment spans its whole prefix bucket: extend in a buffer
        # holding it and the chunk, compact the padding away, then cut the
        # row to the pool's size
        tmp_len = max(self.smax, pc._slot + cb)
        ids = torch.zeros((1, cb), dtype=torch.long)
        ids[0, :c] = torch.tensor(suffix)
        with self._prefill_lock:
            cache, valid = _grow_cache(pc._frag, pc._valid, tmp_len)
            tok, _logits, cache, valid, _seq = eng._extend(
                cache, valid, ids.to(dev), torch.tensor([c], device=dev),
                torch.tensor([pc._seq], device=dev), pc._slot,
                self._prefill_gen, req.temperature, req.top_p,
                req.temperature >= 1e-4)
            cache, valid, n_valid = _compact_cache(cache, valid)
            n = int(n_valid[0])
            if n >= self.smax:
                raise ValueError(f"prompt of {n} tokens leaves no decode "
                                 f"slots (pool smax={self.smax})")
            if tmp_len > self.smax:
                cache = llama.KVCache(*(
                    None if x is None else x[:, :, :self.smax]
                    for x in (cache.k, cache.v, cache.k_scale,
                              cache.v_scale)))
                valid = valid[:, :self.smax]
            self.prefix_chunks.append(cb)
        return (req, tok, cache, valid, n, 0)

    # -- scheduler loop ----------------------------------------------------

    def _next_chunk(self) -> int:
        """Steps of the next pooled decode chunk: the smallest
        next-scheduled size over active rows, a ramp entry while any row is
        inside the ramp, ``steps`` once every row has matured (warmup's
        forced sizes first)."""
        if self._force_chunks:
            return self._force_chunks.pop(0)
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
                if self._stops_world(e):
                    raise
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
        if self._spec is not None:
            # a round writes D + 1 slots: keep the window in the cache
            req.max_new_tokens = min(
                req.max_new_tokens, self.smax - n - (self._spec.draft_len + 1))
            # the row's history: its prompt and first token
            self._state.load_hist(b, req.input_ids, tok[src])

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
            self._run_chunk(*self._decide_chunk())

    def _stops_world(self, err: Exception) -> bool:
        """Whether ``err`` goes on to the lockstep, which stops the world,
        rather than being recovered from here: on a mesh, any failure but
        a refusal every rank meets alike (`lockstep.alike`), since the
        other ranks' pools went on and may wait in a collective."""
        return self._lockstep is not None and not lockstep.alike(err)

    def _decide_chunk(self) -> tuple:
        """(steps, speculative) of the next chunk: `_next_chunk`'s size,
        and a verify round unless speculation is off or paused (the
        re-probe countdown advances here)."""
        n_steps = self._next_chunk()
        use_spec = self._spec is not None
        if use_spec and not self._spec_live:
            # paused: plain chunks until the re-probe countdown ends
            use_spec = False
            self._plain_left -= 1
            if self._plain_left <= 0:
                self._spec_live = True
                self.spec_reprobes += 1
        return n_steps, use_spec

    def _run_chunk(self, n_steps: int, use_spec: bool) -> None:
        """Decode one chunk of the active rows and deliver its tokens."""
        active = [b for b in range(self.rows)
                  if self._active[b] is not None]
        counts = None
        try:
            if use_spec:
                out = self._spec_chunk(n_steps).cpu().numpy()
                toks_np, counts = out[..., :-1], out[..., -1]
            else:
                toks = self._decode_chunk(n_steps)
                if self._spec is not None:
                    self._append_hist(toks)
                toks_np = toks.cpu().numpy()
        except Exception as e:  # noqa: BLE001 -- deliver, don't die
            if self._stops_world(e):
                raise
            logger.exception("decode chunk failed")
            self._fail_active(e)
            # the cache may be half written
            self._reset_pool()
            return
        if counts is not None:
            self._observe(counts[:, active])
        for step in range(toks_np.shape[0]):
            for b in range(self.rows):
                req = self._active[b]
                if req is None:
                    continue
                # tokens decoded after a row finished within the chunk
                # are dropped (they stay masked off for the next request)
                row = [int(toks_np[step, b])] if counts is None else \
                    toks_np[step, b, :counts[step, b]].tolist()
                for t in row:
                    req.out.put(t)
                    req.emitted += 1
                    self._finish_if_done(b, t)
                    if self._active[b] is None:
                        break

    def _observe(self, counts: np.ndarray) -> None:
        """Acceptance telemetry and the adaptive decision over the rows
        active when the chunk began (JAX continuous.py:873-902): counts
        (n_steps, active rows) of tokens per row round."""
        if counts.size == 0:
            return
        acc = float(np.mean(counts - 1))
        self.spec_rounds += counts.size
        self.spec_emitted += int(counts.sum())
        self._acc_ema = acc if self._acc_ema is None else \
            self._acc_ema + 0.2 * (acc - self._acc_ema)
        threshold = resolved_disable_below(self._spec, self.engine)
        if self._spec.adaptive and not self._warming and \
                self._acc_ema < threshold:
            self._spec_live = False
            self._plain_left = self._spec.reprobe_chunks
            self.spec_disables += 1
            logger.info("pool speculation paused (acceptance EMA %.2f < "
                        "%.2f); re-probe in %d chunks", self._acc_ema,
                        threshold, self._plain_left)
            # the probe must measure fresh traffic
            self._acc_ema = None


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
