"""Self-speculative decoding, the PyTorch counterpart of
``valley_tpu/inference/speculative.py``: n-gram lookup drafts, verified
several tokens per pass over the weights.

A round drafts D tokens by matching the last ``ngram`` tokens of the
history (prompt and reply so far) against earlier ones, deepest match
first (prompt-lookup decoding: no draft model), and verifies the draft with
one (D + 1)-token forward through the cache (`graphs.spec_round`): the
weight traffic of one decode step, shared by every accepted token.

* Greedy: a draft token survives only if it equals the model's argmax at
  its position, and the first disagreement is replaced by that argmax, so
  the tokens are plain greedy decode's up to the numerics of the
  (D + 1)-row products (on the card the decode GEMVs give each row the
  same bits at any row count; attention over the appended chunk is the
  plain version).
* Sampled: speculative-sampling rejection against a point-mass draft
  (`spec_sample_round`) under the filtered distribution `sample_token`
  draws from, so the emitted sequence is distributed exactly as
  sequential sampling.  The draws differ from JAX's (threefry keys against
  a ``torch.Generator``), and from the plain engine's.

Rounds run ``rounds_per_call`` at a time, with one device-to-host copy of
their (R, D + 2) tokens and counts.  On the card `SpecDecoder`'s rounds
are one replay of a CUDA graph of R rounds (`graphs.DecodeGraphs`), one
graph per (bucket, cache length, R, ``do_sample``), shared by every
decoder of one engine and configuration as JAX shares one jit; its state
shares the tensors of the engine's decode graphs at that cache length, so
the adaptive switch to plain decode replays the engine's own decode graph
on the same cache.  Sessions (`SpecChatSession`) run their rounds eagerly,
as plain sessions decode.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch

from valley_tpu_torch.inference.engine import (ChatSession, Engine,
                                               GenerationConfig, stream_text)
from valley_tpu_torch.inference.graphs import (DecodeGraphs, DecodeState,
                                               SpecState, spec_round)

# guards the per-engine shared graphs and telemetry (decoders are made and
# counted from concurrent request threads)
_SHARED_LOCK = threading.Lock()


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, draft_len: int,
                ngram: int = 2) -> torch.Tensor:
    """Longest-match-first n-gram lookup over each row's history (JAX
    speculative.py:57-88), with static shapes and no host synchronisation.

    hist: (B, Hmax) int64; hist_len: (B,) the tokens each row holds.
    Returns (B, ``draft_len``) proposed continuations (garbage where no
    match: verification rejects it).  Match lengths ``ngram`` .. 2 are
    tried deepest first; within a length the latest occurrence wins.  The
    indices clamp into the history as JAX's dynamic index and slice do."""
    hmax = hist.shape[-1]
    idx = torch.arange(hmax, device=hist.device)
    hl = hist_len[:, None]
    start = torch.zeros_like(hist_len)
    found = torch.zeros_like(hist_len, dtype=torch.bool)
    for g in range(max(2, ngram), 1, -1):
        # ok[i]: hist[i : i + g] matches the last g tokens
        ok = torch.ones_like(hist, dtype=torch.bool)
        for j in range(g):
            tail = torch.gather(hist, 1, (hl - g + j).clamp(0, hmax - 1))
            ok &= torch.roll(hist, -j, dims=1) == tail
        # a candidate must leave room and precede the tail itself
        ok &= idx[None, :] + g <= hl - g
        j_star = torch.argmax(torch.where(ok, idx, -1), dim=1)  # latest
        has = ok.any(dim=1)
        start = torch.where(has & ~found, j_star + g, start)
        found |= has
    at = start.clamp(0, hmax - draft_len)[:, None] + \
        torch.arange(draft_len, device=hist.device)
    return torch.gather(hist, 1, at)


def spec_sample_round(probs: torch.Tensor, draft: torch.Tensor,
                      generator: Optional[torch.Generator]):
    """One speculative-sampling rejection round of each row against a
    point-mass draft (JAX ``_spec_sample_round``, speculative.py:90-126).

    probs: (B, D + 1, V) target distributions (position i conditions on
    draft[:i] accepted); draft: (B, D).  Returns (emit (B, D + 1), m (B,)):
    ``emit[:m + 1]`` are a row's tokens, its m accepted drafts and one
    correction.  Draft i is accepted with probability p_i(draft_i); the
    first rejection resamples from p_i with draft_i zeroed, full acceptance
    samples a bonus token from p_D.  The categorical draw is
    `sample_token`'s: argmax of p / q with q ~ Exp(1), made without a check
    that reads the device from the host, so a CUDA graph captures it."""
    b, d = draft.shape
    v = probs.shape[-1]
    u = torch.rand((b, d), generator=generator, device=probs.device)
    p_draft = torch.gather(probs[:, :d], 2, draft[:, :, None])[..., 0]
    m = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    p_m = torch.gather(probs, 1, m[:, None, None].expand(b, 1, v))[:, 0]
    draft_at_m = torch.gather(
        torch.cat([draft, draft.new_full((b, 1), -1)], dim=1), 1,
        m[:, None])                       # -1 on full acceptance
    p_corr = torch.where(torch.arange(v, device=probs.device) == draft_at_m,
                         0.0, p_m)
    noise = torch.empty_like(p_corr).exponential_(1, generator=generator)
    corr = torch.argmax(p_corr / noise, dim=1)
    emit = torch.where(torch.arange(d + 1, device=probs.device) < m[:, None],
                       torch.cat([draft, draft.new_zeros((b, 1))], dim=1),
                       corr[:, None])
    return emit, m


@dataclasses.dataclass
class SpecConfig:
    """The JAX package's defaults (speculative.py:128-167): ngram 4 and
    D = 8 were tuned there from measured acceptance on real text.

    Acceptance-adaptive control: a reply starts with one ``probe_rounds``
    call; afterwards, whenever its cumulative acceptance (accepted drafts
    per round) falls below `resolved_disable_below`, the reply finishes on
    plain decode (greedy output is the same either way; sampling stays
    distribution-exact).  Sessions re-probe each turn; the pool pauses and
    re-probes every ``reprobe_chunks`` plain chunks."""

    draft_len: int = 8        # drafted tokens per round (D)
    ngram: int = 4            # longest match length, tried deepest first
    rounds_per_call: int = 16  # rounds per call (one graph replay)
    adaptive: bool = True
    disable_below: Optional[float] = None  # accepted drafts/round
    probe_rounds: int = 4     # the first call's rounds per reply
    reprobe_chunks: int = 32  # pool: plain chunks between re-probes


# The JAX package's thresholds (speculative.py:171-175), kept for parity:
# break-even acceptances it measured for its weight modes, less a margin.
# They are not measured on the card here.
DISABLE_BELOW_DEFAULT = 0.40
DISABLE_BELOW_W4 = 1.70


def _packed_int4(engine) -> bool:
    """Whether the engine's decoder weights are nibble-packed int4."""
    layers = engine.params["llama"]["layers"]
    return any(p.dtype == torch.uint8 for p in layers.parameters())


def resolved_disable_below(spec: SpecConfig, engine) -> float:
    """The adaptive threshold for ``engine``'s weight mode, read at every
    check (warmup may set ``spec.disable_below`` for a while): an explicit
    value, else `DISABLE_BELOW_W4` for packed int4 weights (the port's one
    4-bit storage) and `DISABLE_BELOW_DEFAULT` otherwise."""
    if spec.disable_below is not None:
        return spec.disable_below
    return DISABLE_BELOW_W4 if _packed_int4(engine) else \
        DISABLE_BELOW_DEFAULT


class SpecDecoder:
    """An `Engine` with speculative generation of one prompt: greedy
    output equals `Engine.generate_tokens`', sampled output follows the
    exact `sample_token` distribution.

    Decoders of one engine and (``draft_len``, ``ngram``) share their CUDA
    graphs and their telemetry (``total_rounds``, ``total_emitted``, and
    ``disabled``, the replies that fell back to plain decode), as JAX's
    share one jit (speculative.py:199-223): sessions and prefix spawns make
    a decoder per reply."""

    def __init__(self, engine: Engine, spec: Optional[SpecConfig] = None):
        self.engine = engine
        self.spec = spec or SpecConfig()
        with _SHARED_LOCK:
            shared = engine.__dict__.setdefault("_spec_shared", {})
            key = (self.spec.draft_len, self.spec.ngram)
            st = shared.get(key)
            if st is None:
                st = shared[key] = {"rounds": 0, "emitted": 0,
                                    "disabled": 0, "graphs": {}}
        self._shared = st
        # {(bucket, cache length): DecodeGraphs of the rounds}
        self.graph_sets = st["graphs"]

    def _count(self, rounds: int = 0, emitted: int = 0,
               disabled: int = 0) -> None:
        with _SHARED_LOCK:
            self._shared["rounds"] += rounds
            self._shared["emitted"] += emitted
            self._shared["disabled"] += disabled

    # emitted = accepted drafts + one correction per round, so accepted
    # drafts per round = emitted / rounds - 1
    @property
    def total_rounds(self) -> int:
        return self._shared["rounds"]

    @total_rounds.setter
    def total_rounds(self, v: int) -> None:
        self._shared["rounds"] = v

    @property
    def total_emitted(self) -> int:
        return self._shared["emitted"]

    @total_emitted.setter
    def total_emitted(self, v: int) -> None:
        self._shared["emitted"] = v

    @property
    def disabled(self) -> int:
        return self._shared["disabled"]

    # -- device side ------------------------------------------------------

    def _round(self, state: SpecState, generator, do_sample: bool):
        eng = self.engine
        return spec_round(eng.params["llama"], eng.cfg.text, eng.attention,
                          state, generator, do_sample, self.spec.draft_len,
                          self.spec.ngram)

    @torch.inference_mode()
    def _rounds(self, state: SpecState, n_rounds: int, do_sample: bool,
                generator, graphs: Optional[DecodeGraphs] = None
                ) -> torch.Tensor:
        """``n_rounds`` rounds of ``state``: one replay of ``graphs``'
        graph, or (without ``graphs``) the same rounds run eagerly.
        Returns (n_rounds, B, D + 2): each round's tokens and count."""
        if graphs is not None:
            return graphs.run(n_rounds, do_sample)
        return torch.stack([self._round(state, generator, do_sample)
                            for _ in range(n_rounds)])

    def _round_loop(self, state: SpecState, do_sample: bool, generator,
                    graphs: Optional[DecodeGraphs] = None
                    ) -> Iterator[Tuple[int, Optional[list]]]:
        """The rounds of ``state``, call after call (JAX's {probe, steady}
        round counts, one graph each): yields (the call's round count, the
        round's emitted tokens) for each round, counted in the telemetry
        first, and (the round count, None) when a call ends with
        speculation still on; returns when the adaptive switch turns it
        off (counted in `disabled`).  A caller that stops iterating leaves
        the rest of its call's rounds uncounted, as JAX does."""
        spec = self.spec
        tot_rounds = tot_accept = 0
        while True:
            n_rounds = min(spec.probe_rounds, spec.rounds_per_call) \
                if tot_rounds == 0 else spec.rounds_per_call
            out = self._rounds(state, n_rounds, do_sample, generator,
                               graphs).cpu().numpy()          # (R, 1, D+2)
            for r in range(n_rounds):
                count = int(out[r, 0, -1])
                self._count(rounds=1, emitted=count)
                tot_rounds += 1
                tot_accept += count - 1
                yield n_rounds, out[r, 0, :count].tolist()
            if spec.adaptive and tot_accept / max(1, tot_rounds) \
                    < resolved_disable_below(spec, self.engine):
                self._count(disabled=1)
                return
            yield n_rounds, None

    def cache_len(self, bucket: int) -> int:
        """The cache slots of a prompt of ``bucket``: the engine's
        ``max_new_tokens`` and room for a final call that overshoots it by
        a whole call.  A function of the bucket alone, as
        `Engine.generate_tokens`'s is, so that requests of every
        ``max_new_tokens`` replay one set of graphs a bucket (JAX sizes the
        cache by the request's; the slots past it stay masked)."""
        spec = self.spec
        return (bucket + self.engine.max_new_tokens
                + spec.rounds_per_call * (spec.draft_len + 1))

    @torch.inference_mode()
    def graphs_for(self, bucket: int, cache_len: int) -> DecodeGraphs:
        """The round graphs of a prompt of ``bucket`` at ``cache_len``,
        bound to a `SpecState` over the engine's decode state at that cache
        length (`Engine.graphs_for`), with a ``bucket + cache_len`` history
        (JAX's ``hmax``); made at first use (on the card)."""
        key = (bucket, cache_len)
        with _SHARED_LOCK:
            graphs = self.graph_sets.get(key)
        if graphs is None:
            base = self.engine.graphs_for(1, cache_len)
            graphs = DecodeGraphs(SpecState.over(base.state,
                                                 bucket + cache_len),
                                  self._round, base.generator, base.pool)
            with _SHARED_LOCK:
                graphs = self.graph_sets.setdefault(key, graphs)
        return graphs

    # -- host side --------------------------------------------------------

    def generate_tokens(self, input_ids: Sequence[int], images=None,
                        gen: Optional[GenerationConfig] = None,
                        eos_ids: Sequence[int] = (2,),
                        eager: bool = False) -> Iterator[int]:
        """Yield the generated token ids one by one (JAX
        speculative.py:320-429).  On the card each call of rounds replays
        a CUDA graph, into whose state (the engine's decode state at this
        cache length) the prompt is prefilled; ``eager=True``, or the CPU,
        runs the same rounds eagerly on a cache of the request's own."""
        eng, spec = self.engine, self.spec
        gen = gen or GenerationConfig()
        # the worker's rule: temperature < 1e-4 is greedy
        do_sample = bool(gen.do_sample) and gen.temperature >= 1e-4
        prompt = list(input_ids)
        ids, lens, bucket = eng._pad([prompt])
        media = eng._prepare_images(images, 1)
        max_new = min(gen.max_new_tokens, eng.max_new_tokens)
        cache_len = self.cache_len(bucket)
        base = graphs = None
        if eng.use_graphs and not eager:
            graphs = self.graphs_for(bucket, cache_len)
            base = eng.graphs_for(1, cache_len)
            if base.in_use:
                raise RuntimeError(
                    f"another request of this engine is decoding at cache "
                    f"length {cache_len}: its graphs are bound to one "
                    "state; finish or close it first")
            base.in_use = True
        try:
            yield from self._generate(prompt, ids, lens, bucket, media,
                                      cache_len, max_new, gen, do_sample,
                                      eos_ids, graphs, base)
        finally:
            if base is not None:
                base.in_use = False

    def _generate(self, prompt, ids, lens, bucket: int, media,
                  cache_len: int,
                  max_new: int, gen: GenerationConfig, do_sample: bool,
                  eos_ids, graphs: Optional[DecodeGraphs],
                  base: Optional[DecodeGraphs]) -> Iterator[int]:
        eng, spec = self.engine, self.spec
        if graphs is not None:
            generator = graphs.generator.manual_seed(gen.seed)
            state = graphs.state
            tok, _, _, valid = eng._prefill(
                ids, media, lens, generator, gen.temperature, gen.top_p,
                do_sample, cache_len, cache=state.cache)
            state.load(valid, tok, lens, bucket, gen.temperature, gen.top_p)
        else:
            generator = torch.Generator(eng.device).manual_seed(gen.seed)
            tok, _, cache, valid = eng._prefill(
                ids, media, lens, generator, gen.temperature, gen.top_p,
                do_sample, cache_len)
            state = SpecState.over(DecodeState.start(
                cache, valid, tok, lens, bucket, gen.temperature,
                gen.top_p), bucket + cache_len)
        state.load_hist(0, prompt, tok)

        first = int(tok[0])
        yield first
        emitted = 1
        eos = set(int(e) for e in eos_ids)
        if first in eos or emitted >= max_new:
            return
        # the final call may overshoot; its surplus is not yielded
        for _, toks in self._round_loop(state, do_sample, generator,
                                        graphs):
            for t in toks or ():
                yield t
                emitted += 1
                if t in eos or emitted >= max_new:
                    return
        # acceptance fell below break-even: plain decode of the same state
        # for the rest of the reply, in the steady steps_per_call chunks
        # (surplus tokens dropped; the cache's slack covers the overshoot,
        # except on tiny test configs, where it clamps, as in JAX)
        while True:
            n_steps = max(1, min(eng.steps_per_call,
                                 cache_len - int(state.slot[0])))
            toks = eng._decode_chunk(state, n_steps, do_sample, generator,
                                     base)
            for t in toks[:, 0].tolist():
                yield t
                emitted += 1
                if t in eos or emitted >= max_new:
                    return

    def generate(self, tokenizer, input_ids: Sequence[int], images=None,
                 gen: Optional[GenerationConfig] = None) -> Iterator[str]:
        """Streaming text, as `Engine.generate` gives it."""
        gen = gen or GenerationConfig()
        eos = [getattr(tokenizer, "eos_token_id", 2) or 2]
        yield from stream_text(
            self.generate_tokens(list(input_ids), images, gen, eos_ids=eos),
            tokenizer, gen)


class SpecChatSession(ChatSession):
    """A `ChatSession` whose turns decode by speculative rounds (JAX
    speculative.py:444-581), eagerly, as plain sessions decode: the draft
    table is the whole conversation so far.  Greedy turns equal a plain
    session's; the KV bookkeeping is the plain session's, since a round
    writes the accepted tokens at the same consecutive slots."""

    def __init__(self, engine: Engine, gen: Optional[GenerationConfig] = None,
                 extra_slots: Optional[int] = None,
                 spec: Optional[SpecConfig] = None):
        super().__init__(engine, gen or GenerationConfig(do_sample=False),
                         extra_slots)
        self._decoder = SpecDecoder(engine, spec)
        self._hist: list = []    # the conversation's ids (lookup table)
        # a round writes D + 1 slots and the final call may run a whole
        # call of rounds past the kept tokens
        sp = self._decoder.spec
        self._decode_slack = (sp.rounds_per_call + 1) * (sp.draft_len + 1)

    def chat(self, new_ids, images=None, tokenizer=None, eos_ids=(2,),
             on_token=None) -> list:
        base = len(self._hist)
        self._hist.extend(int(t) for t in new_ids)
        tokens = super().chat(new_ids, images=images, tokenizer=tokenizer,
                              eos_ids=eos_ids, on_token=on_token)
        # the history keeps only the kept reply (emissions past a stop
        # would poison later lookups)
        del self._hist[base + len(new_ids):]
        self._hist.extend(tokens)
        return tokens

    def _decode_loop(self, cache, valid, tok, seq: int, slot: int,
                     max_new: int, eos_arr, tokenizer, on_token):
        from valley_tpu_torch.inference.engine import _STOP_WINDOW

        eng, gen = self.engine, self.gen
        spec = self._decoder.spec
        t0 = int(tok[0])
        tokens = [t0]
        if on_token:
            on_token(t0)
        stopped = t0 in eos_arr
        # the lookup history: the conversation so far and this reply, in a
        # power-of-two buffer with room for a call's overshoot
        n0 = len(self._hist)
        d1 = spec.draft_len + 1
        need = n0 + 1 + max_new + (spec.rounds_per_call + 1) * d1
        hmax = 1 << max(8, (need - 1).bit_length())
        dev = eng.device
        state = SpecState.over(DecodeState.start(
            cache, valid, tok, torch.tensor([seq], device=dev), slot,
            gen.temperature, gen.top_p), hmax)
        state.load_hist(0, self._hist, tok)
        do_sample = bool(gen.do_sample) and gen.temperature >= 1e-4
        if stopped or len(tokens) >= max_new:
            return tokens, int(state.slot[0])
        for n_rounds, toks in self._decoder._round_loop(state, do_sample,
                                                        self.generator):
            if toks is None:
                if tokenizer is not None and gen.stop and any(
                        s in tokenizer.decode(
                            # this call's emissions and a straddle window
                            tokens[-(n_rounds * d1 + _STOP_WINDOW):],
                            skip_special_tokens=True) for s in gen.stop):
                    break
                continue
            for t in toks:
                tokens.append(t)
                if on_token:
                    on_token(t)
                if t in eos_arr:
                    stopped = True
                    break
            if stopped or len(tokens) >= max_new:
                del tokens[max_new:]
                break
        else:
            # speculation turned off: finish the turn on the plain loop; it
            # takes the pending token as its first, so skip streaming it
            # again and splice
            skip_first = [True]

            def tail_cb(t):
                if skip_first[0]:
                    skip_first[0] = False
                elif on_token:
                    on_token(t)

            sub_toks, end_slot = ChatSession._decode_loop(
                self, cache, valid, state.token, int(state.seq[0]),
                int(state.slot[0]), max_new - len(tokens) + 1, eos_arr,
                tokenizer, tail_cb)
            return tokens[:-1] + sub_toks, end_slot
        return tokens, int(state.slot[0])
