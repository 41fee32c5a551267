"""Fused decode calls as CUDA graphs: the PyTorch counterpart of the JAX
engine's jitted ``n_steps`` decode scan (``valley_tpu/inference/engine.py``
``_decode_impl``), of the JAX pool's (``continuous.py`` ``_decode_impl``)
and of the speculative verify rounds (``speculative.py`` ``_rounds_impl``,
``continuous.py`` ``_spec_decode_impl``).

`DecodeState` holds every tensor a decode step reads and advances: the KV
cache, the (B, Smax) ``valid`` mask, each row's token, rotary position and
cache slot, and its temperature and top_p.  `decode_step` runs one step on
it in place, with no host synchronisation, no host-to-device copy and no
Python number that depends on the request, so the same step runs eagerly
(on the CPU, or when a caller asks for it by name) and inside a capture.

`SpecState` adds each row's token history (the n-gram drafts' lookup
table), and `spec_round` runs one speculative verify round on it the same
way: draft from the history, verify the draft with one (D + 1)-token
forward through the cache, accept, and advance each row by what it
accepted.

`DecodeGraphs` captures ``n_steps`` such steps (or rounds) into one CUDA
graph per (``n_steps``, ``do_sample``) and replays it: one launch of the whole chunk,
where the eager loop makes some forty launches per layer and step from
Python.  The graphs are bound to the addresses of one `DecodeState`, so a
caller refills that state in place before each replay (and may not replace
its tensors).  Every graph of an owner shares one memory pool
(`torch.cuda.graph_pool_handle`).  A failed capture raises: there is no
fallback to the eager loop.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import _build
from valley_tpu_torch.parallel import distributed


def _per_row(value, rows: int, device) -> torch.Tensor:
    """A sampling setting (one number, or one per row) as a (rows,) fp32
    tensor."""
    return torch.as_tensor(np.asarray(value, np.float32)).to(
        device).expand(rows).clone()


@dataclasses.dataclass
class DecodeState:
    """The tensors a decode step reads and advances in place (B rows)."""
    cache: llama.KVCache
    valid: torch.Tensor        # (B, Smax) bool: attendable slots
    token: torch.Tensor        # (B,) int64: the token fed to the next step
    seq: torch.Tensor          # (B,) int64: its rotary position
    slot: torch.Tensor         # (B,) int64: the cache slot it is written to
    temperature: torch.Tensor  # (B,) fp32
    top_p: torch.Tensor        # (B,) fp32

    @classmethod
    def empty(cls, engine, rows: int, smax: int) -> "DecodeState":
        """A zeroed state over a cache of ``engine``'s (`Engine.init_cache`):
        every row at slot ``smax - 1``, greedy."""
        device = engine.device

        def vec(fill, dtype):
            return torch.full((rows,), fill, dtype=dtype, device=device)

        return cls(engine.init_cache(rows, smax),
                   torch.zeros((rows, smax), dtype=torch.bool,
                               device=device),
                   vec(0, torch.int64), vec(0, torch.int64),
                   vec(smax - 1, torch.int64), vec(0.0, torch.float32),
                   vec(1.0, torch.float32))

    @classmethod
    def start(cls, cache, valid, token, seq, slot: int, temperature,
              top_p) -> "DecodeState":
        """A state over ``cache`` and ``valid`` (advanced in place) whose
        rows feed copies of ``token`` at positions ``seq``, all at cache
        slot ``slot``, with a temperature and top_p for all rows or one
        each (sequences of B)."""
        b, dev = token.shape[0], token.device
        return cls(cache, valid, token.clone(), seq.clone(),
                   torch.full((b,), slot, dtype=torch.int64, device=dev),
                   _per_row(temperature, b, dev), _per_row(top_p, b, dev))

    @torch.inference_mode()
    def load(self, valid, token, seq, slot: int, temperature: float,
             top_p: float) -> None:
        """Refill the state in place, as `start` would make it (the cache
        is the caller's to write)."""
        self.valid.copy_(valid)
        self.token.copy_(token)
        self.seq.copy_(seq)
        self.slot.fill_(slot)
        self.temperature.copy_(_per_row(temperature, self.rows, "cpu"))
        self.top_p.copy_(_per_row(top_p, self.rows, "cpu"))

    @property
    def rows(self) -> int:
        return self.token.shape[0]


    def _small(self) -> Tuple[torch.Tensor, ...]:
        return (self.valid, self.token, self.seq, self.slot)

    def snapshot(self) -> Tuple[torch.Tensor, ...]:
        """Copies of everything but the cache: enough to run the same
        steps again after `restore`, since a step writes its slot of the
        cache before it reads it."""
        return tuple(t.clone() for t in self._small())

    @torch.inference_mode()
    def restore(self, saved: Tuple[torch.Tensor, ...]) -> None:
        for t, v in zip(self._small(), saved):
            t.copy_(v)


@dataclasses.dataclass
class SpecState(DecodeState):
    """A `DecodeState` with each row's token history: the prompt and every
    token emitted so far, from which `spec_round` drafts.  It may share its
    decode tensors with a `DecodeState` (`over`), so that plain decode
    steps and verify rounds advance the same cache and rows."""
    hist: torch.Tensor = None      # (B, Hmax) int64
    hist_len: torch.Tensor = None  # (B,) int64: the tokens hist holds

    @classmethod
    def over(cls, state: DecodeState, hmax: int) -> "SpecState":
        """A state over ``state``'s tensors (shared, not copied) with a
        zeroed (B, ``hmax``) history."""
        dev = state.token.device
        return cls(state.cache, state.valid, state.token, state.seq,
                   state.slot, state.temperature, state.top_p,
                   torch.zeros((state.rows, hmax), dtype=torch.int64,
                               device=dev),
                   torch.zeros((state.rows,), dtype=torch.int64, device=dev))

    @torch.inference_mode()
    def load_hist(self, row: int, ids, first: torch.Tensor) -> None:
        """Row ``row``'s history: the prompt ``ids`` (host ints) and the
        first sampled token ``first`` (a one-element device tensor)."""
        n = len(ids)
        self.hist[row].zero_()
        self.hist[row, :n] = torch.tensor(list(ids), dtype=torch.int64)
        self.hist[row, n:n + 1] = first.reshape(1)
        self.hist_len[row] = n + 1

    def _small(self) -> Tuple[torch.Tensor, ...]:
        return super()._small() + (self.hist, self.hist_len)


def decode_step(params, cfg, attention, state: DecodeState,
                generator: Optional[torch.Generator],
                do_sample: bool) -> torch.Tensor:
    """One single-token step of every row, in place: mark each row's slot
    valid (clamped into the cache, as JAX's dynamic_update_slice clamps:
    the pool parks idle rows past the end), write the token's K/V there at
    its rotary position, attend, sample, and advance token, position and
    slot.  Returns the sampled tokens (B,)."""
    from valley_tpu_torch.inference.engine import sample_token

    s = state
    smax = s.valid.shape[1]
    s.valid.scatter_(1, s.slot.clamp(max=smax - 1)[:, None], True)
    hidden, _ = llama.forward_hidden(
        params, cfg, llama.embed(params, s.token[:, None]),
        positions=s.seq[:, None], cache=s.cache, cache_index=s.slot,
        kv_valid=s.valid, attention=attention)
    logits = llama.logits_from_hidden(params, hidden, attention)[:, 0]
    tok = sample_token(logits, generator, s.temperature, s.top_p, do_sample)
    s.token.copy_(tok)
    s.seq.add_(1)
    s.slot.add_(1)
    return tok


def spec_round(params, cfg, attention, state: SpecState,
               generator: Optional[torch.Generator], do_sample: bool,
               draft_len: int, ngram: int) -> torch.Tensor:
    """One speculative verify round of every row, in place (JAX
    speculative.py:258-318 for one row, continuous.py:281-350 for a pool):
    draft ``draft_len`` tokens from the row's history (`ngram_draft`),
    write the K/V of [token, draft] at the row's slots and attend them over
    the cache (the plain attention of an appended chunk, as JAX's
    ``use_flash=False``), take the (D + 1)-row logits, and accept: greedy,
    the longest prefix of the draft that equals the argmax plus the argmax
    after it; sampled, `spec_sample_round` against each row's filtered
    distribution (a row with temperature < 1e-4 against its argmax as a
    point mass, which reduces to the greedy rule, as the JAX pool does).
    Marks the slots of the token and the m accepted drafts valid, writes
    the emitted tokens into the history, and advances token, position and
    slot by 1 + m.  Returns (B, D + 2): the D + 1 emitted tokens (the first
    1 + m are the round's) and 1 + m in the last column."""
    from valley_tpu_torch.inference.engine import filter_logits
    from valley_tpu_torch.inference.speculative import (ngram_draft,
                                                        spec_sample_round)

    s = state
    dev = s.token.device
    d1 = draft_len + 1
    draft = ngram_draft(s.hist, s.hist_len, draft_len, ngram)     # (B, D)
    chunk = torch.cat([s.token[:, None], draft], dim=1)           # (B, D+1)
    ar = torch.arange(d1, device=dev)
    hidden, _ = llama.forward_hidden(
        params, cfg, llama.embed(params, chunk),
        positions=s.seq[:, None] + ar, cache=s.cache, cache_index=s.slot,
        cross_valid=s.valid, attention=attention)
    logits = llama.logits_from_hidden(params, hidden, attention)  # (B,D+1,V)
    greedy = torch.argmax(logits, dim=-1)
    if do_sample:
        probs = torch.softmax(filter_logits(
            logits, s.temperature[:, None], s.top_p[:, None]), dim=-1)
        one_hot = torch.nn.functional.one_hot(
            greedy, logits.shape[-1]).to(probs.dtype)
        probs = torch.where((s.temperature < 1e-4)[:, None, None], one_hot,
                            probs)
        emit, m = spec_sample_round(probs, draft, generator)
    else:
        emit = greedy
        m = torch.cumprod((draft == greedy[:, :draft_len]).long(),
                          dim=1).sum(dim=1)
    n_emit = m + 1
    slots = torch.arange(s.valid.shape[1], device=dev)[None, :]
    s.valid.logical_or_((slots >= s.slot[:, None])
                        & (slots < (s.slot + n_emit)[:, None]))
    # jax.lax.dynamic_update_slice clamps the start into the history
    start = s.hist_len.clamp(max=s.hist.shape[1] - d1)
    s.hist.scatter_(1, start[:, None] + ar, emit)
    s.hist_len.add_(n_emit)
    s.token.copy_(torch.gather(emit, 1, m[:, None])[:, 0])
    s.seq.add_(n_emit)
    s.slot.add_(n_emit)
    return torch.cat([emit, n_emit[:, None]], dim=1)


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor          # (n_steps, B, ...) int64, each replay's
    launches: dict             # {wrapper: launches} of one replay


class DecodeGraphs:
    """The CUDA graphs of fused decode chunks over one `DecodeState`.

    ``step(state, generator, do_sample)`` runs `decode_step` (or
    `spec_round`) on the state and returns a (B, ...) int64 result.  `run`
    replays the graph of (``n_steps``, ``do_sample``), capturing it first
    if it is not yet captured; it returns the graph's own (``n_steps``, B,
    ...) buffer of the steps' results, which the next replay overwrites.  A
    sampled graph draws from ``generator``, registered with the graph, so
    each replay draws fresh numbers from the generator's current seed and
    offset (seed it again to repeat a draw).  ``capture_s`` sums the seconds
    spent capturing; each replay adds the launches its capture recorded to
    the wrappers' counts."""

    def __init__(self, state: DecodeState, step: Callable[..., torch.Tensor],
                 generator: Optional[torch.Generator], pool=None):
        self.state = state
        self._step = step
        self.generator = generator
        self.pool = pool if pool is not None else \
            torch.cuda.graph_pool_handle()
        self._graphs: Dict[Tuple[int, bool], _Graph] = {}
        self.capture_s = 0.0
        # set while a caller decodes on the state (one at a time)
        self.in_use = False

    def keys(self):
        return self._graphs.keys()

    @torch.inference_mode()
    def run(self, n_steps: int, do_sample: bool) -> torch.Tensor:
        entry = self._graphs.get((n_steps, do_sample))
        if entry is None:
            entry = self.capture(n_steps, do_sample)
        entry.graph.replay()
        _build.add_launches(entry.launches)
        return entry.out

    @torch.inference_mode()
    def capture(self, n_steps: int, do_sample: bool) -> _Graph:
        """Capture the graph of (``n_steps``, ``do_sample``); the state is
        left as it was."""
        t0 = time.perf_counter()
        s = self.state
        # one eager step first, on a side stream as capture wants: first
        # use builds and loads the kernels' libraries and sets their
        # attributes, none of which may happen inside a capture.  Restoring
        # the state (and the generator) undoes it; its launches are real
        # and count.
        saved = s.snapshot()
        rng = self.generator.get_state() if do_sample else None
        side = torch.cuda.Stream(device=s.token.device)
        side.wait_stream(torch.cuda.current_stream(s.token.device))
        with torch.cuda.stream(side):
            first = self._step(s, self.generator, do_sample)
        torch.cuda.current_stream(s.token.device).wait_stream(side)
        s.restore(saved)
        if rng is not None:
            self.generator.set_state(rng)
        out = torch.empty((n_steps,) + tuple(first.shape), dtype=torch.int64,
                          device=s.token.device)
        graph = torch.cuda.CUDAGraph()
        if do_sample:
            graph.register_generator_state(self.generator)
        # an engine and its graphs hold each other, so dead graphs wait for
        # the cyclic collector; destroying one during a capture invalidates
        # the capture, so they go now and the collector waits until after
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.recording_launches() as launches:
                with torch.cuda.graph(graph, pool=self.pool):
                    for i in range(n_steps):
                        out[i].copy_(self._step(s, self.generator,
                                                do_sample))
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(s.token.device).synchronize()
        # a graph over a mesh may hold NCCL's communicator: the process
        # group's teardown releases it first
        distributed.hold_graph(graph)
        entry = _Graph(graph, out, launches)
        self._graphs[(n_steps, do_sample)] = entry
        self.capture_s += time.perf_counter() - t0
        return entry
