"""Streaming inference engine, the PyTorch counterpart of
``valley_tpu/inference/engine.py``: a batch of ragged prompts prefilled
together and decoded in lockstep (the continuous-batching pool built on it
is ``inference/continuous.py``), and multi-turn conversations that keep
their cache across turns (`ChatSession`, `PrefixCache`).

The cache state is the JAX engine's: the prompt is right-padded to a length
bucket and prefilled at slot 0; decode writes from slot ``bucket`` on,
while the rotary position is the true sequence length, so slots
``[prompt_len, bucket)`` stay invalid throughout decode and attention reads
the (B, Smax) ``valid`` mask, never a length.  The cache holds ``bucket +
max_new_tokens + steps_per_call`` slots, as in the JAX engine.

PyTorch runs eagerly, so each decode step is one forward pass; tokens are
handed to the caller in chunks of ``steps_per_call`` (after a
``decode_ramp`` of shorter chunks), with one device-to-host copy per
chunk, as the JAX engine's fused decode calls do.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops.attention import KERNELS, Attention


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 1024
    temperature: float = 1.0
    top_p: float = 1.0
    do_sample: bool = False
    stop: Sequence[str] = ("###",)
    seed: int = 0
    stream_interval: int = 2


def filter_logits(logits: torch.Tensor, temperature, top_p) -> torch.Tensor:
    """Temperature-scale and nucleus-filter logits ((..., V) -> same
    shape); ``softmax`` of the result is the distribution `sample_token`
    draws from.  ``temperature``/``top_p`` are scalars or per-row (B,)."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    t_col = temperature[..., None] if temperature.ndim else temperature
    p_col = top_p[..., None] if top_p.ndim else top_p
    scaled = logits / torch.clamp(t_col, min=1e-4)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose exclusive cumulative probability is < top_p
    cutoff_idx = (cum - probs < p_col).sum(dim=-1) - 1
    cutoff_idx = torch.remainder(cutoff_idx, scaled.shape[-1])
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx[..., None])
    return torch.where(scaled < cutoff, -1e9, scaled)


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature, top_p, do_sample: bool) -> torch.Tensor:
    """Greedy / temperature / nucleus sampling over (B, V) logits; rows with
    temperature < 1e-4 take the argmax (the worker's rule)."""
    greedy = torch.argmax(logits, dim=-1)
    if not do_sample:
        return greedy
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    probs = torch.softmax(filter_logits(logits, temperature, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature < 1e-4, greedy, sampled)


@dataclasses.dataclass
class Prefilled:
    """State after a prompt's prefill: the first sampled token (B,), its
    fp32 logits (B, V), the written cache and its validity mask."""
    token: torch.Tensor
    logits: torch.Tensor
    cache: llama.KVCache
    valid: torch.Tensor
    bucket: int


class Engine:
    """Holds the weights on their device and runs prefill and decode.

    ``cache_dtype=torch.int8`` keeps the KV cache in int8 with per-slot,
    per-head bf16 scales (`llama.init_cache`), as the JAX engine does for
    ``jnp.int8``; the weights may be fused (`llama.fuse_llama_params`) and
    int8 or packed int4 (`ops.quant.quantize_llama_params`).
    ``attention`` picks the CUDA kernels (default; tensors on the CPU take
    their plain versions) or the plain versions (`ops.attention.PLAIN`),
    for comparing the two on the card.
    """

    def __init__(self, cfg: ValleyConfig, params: valley.ValleyWeights,
                 buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
                 max_new_tokens: int = 1024,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 steps_per_call: int = 4,
                 decode_ramp: Sequence[int] = (),
                 attention: Attention = KERNELS):
        self.cfg = cfg
        self.params = params
        self.device = params["llama"]["embed"].device
        self.buckets = tuple(sorted(buckets))
        self.max_new_tokens = max_new_tokens
        self.cache_dtype = cache_dtype
        self.steps_per_call = max(1, steps_per_call)
        self.decode_ramp = tuple(int(s) for s in decode_ramp if int(s) > 0)
        self.attention = attention

    def pick_bucket(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _prepare_images(self, images, batch: int) -> Optional[torch.Tensor]:
        """Host media (``batch``, T, 3, H, W) -> device frames, or None for
        text-only prompts.  uint8 frames move as uint8 and are normalised
        on the device; float frames move as bf16."""
        if images is None:
            return None
        t = images if isinstance(images, torch.Tensor) \
            else torch.from_numpy(np.asarray(images))
        if t.dim() != 5 or t.shape[0] != batch:
            raise ValueError(f"want frames ({batch}, T, 3, H, W) for {batch} "
                             f"prompts, got {tuple(t.shape)}")
        if t.dtype != torch.uint8:
            t = t.to(torch.float32).to(torch.bfloat16)
        return t.to(self.device)

    def _ramp_iter(self) -> Iterator[int]:
        """Tokens per decode chunk: the ramp once, then steps_per_call."""
        yield from self.decode_ramp
        while True:
            yield self.steps_per_call

    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, images: Optional[torch.Tensor],
                 prompt_len: torch.Tensor, generator: torch.Generator,
                 temperature, top_p, do_sample: bool, cache_len: int):
        """Prefill (B, bucket) ids into a fresh cache of ``cache_len``
        slots (JAX _prefill_impl, engine.py:257-286) and sample each row's
        first token; ``temperature``/``top_p`` are scalars or per-row (B,)
        tensors.  Returns (tokens (B,), logits (B, V), cache, valid)."""
        cfg = self.cfg
        embeds = valley.build_inputs_embeds(self.params, cfg, ids, images)
        cache = llama.init_cache(cfg.text, ids.shape[0], cache_len,
                                 self.cache_dtype, self.device)
        slots = torch.arange(cache_len, device=self.device)
        kv_valid = slots[None, :] < prompt_len[:, None]       # (B, Smax)
        hidden, cache = llama.forward_hidden(
            self.params["llama"], cfg.text, embeds, cache=cache,
            cache_index=0, kv_valid=kv_valid, attention=self.attention)
        last = torch.gather(hidden, 1, (prompt_len - 1)[:, None, None].expand(
            -1, 1, hidden.shape[-1]))                          # (B, 1, H)
        logits = llama.logits_from_hidden(self.params["llama"], last,
                                          self.attention)[:, 0]
        tok = sample_token(logits, generator, temperature, top_p, do_sample)
        return tok, logits, cache, kv_valid

    @torch.inference_mode()
    def _decode(self, cache: llama.KVCache, valid: torch.Tensor,
                token: torch.Tensor, slot: int, seq_len: torch.Tensor,
                generator: torch.Generator, gen: GenerationConfig,
                n_steps: int):
        """``n_steps`` single-token steps from slot ``slot``; ``seq_len``
        (B,) is the rotary position of the incoming token.  Updates the
        cache and ``valid`` in place.  Returns (tokens (n_steps, B),
        seq_len)."""
        p = self.params["llama"]
        toks = []
        for i in range(n_steps):
            valid[:, slot + i] = True
            hidden, cache = llama.forward_hidden(
                p, self.cfg.text, llama.embed(p, token[:, None]),
                positions=seq_len[:, None], cache=cache,
                cache_index=slot + i, kv_valid=valid,
                attention=self.attention)
            logits = llama.logits_from_hidden(p, hidden, self.attention)[:, 0]
            token = sample_token(logits, generator, gen.temperature,
                                 gen.top_p, gen.do_sample)
            toks.append(token)
            seq_len = seq_len + 1
        return torch.stack(toks), seq_len

    @torch.inference_mode()
    def _extend(self, cache: llama.KVCache, valid: torch.Tensor,
                ids: torch.Tensor, new_len: torch.Tensor,
                seq_len: torch.Tensor, slot0: llama.Slots,
                generator: torch.Generator, temperature, top_p,
                do_sample: bool):
        """Append a right-padded (B, C) chunk of conversation tokens to a
        session's cache at slot ``slot0`` (JAX _extend_impl,
        engine.py:319-343): rotary positions ``seq_len + arange(C)``, the
        chunk attending every valid slot and itself causally, its first
        ``new_len`` slots marked valid (the pad slots stay invalid), and
        each row's next token sampled from its last real token's logits.
        The cache is written in place; ``valid`` is not (a new mask is
        returned, so the same chunk can be appended again to the same
        state).  Returns (tokens (B,), logits (B, V), cache, valid,
        seq_len + new_len)."""
        p = self.params["llama"]
        c = ids.shape[1]
        positions = seq_len[:, None] + torch.arange(c, device=self.device)
        hidden, cache = llama.forward_hidden(
            p, self.cfg.text, llama.embed(p, ids), positions=positions,
            cache=cache, cache_index=slot0, cross_valid=valid,
            attention=self.attention)
        rel = torch.arange(cache.max_len, device=self.device)[None, :] - \
            torch.as_tensor(slot0, device=self.device).reshape(-1, 1)
        valid = valid | ((rel >= 0) & (rel < new_len[:, None]))
        last = torch.gather(hidden, 1, (new_len - 1)[:, None, None].expand(
            -1, 1, hidden.shape[-1]))
        logits = llama.logits_from_hidden(p, last, self.attention)[:, 0]
        tok = sample_token(logits, generator, temperature, top_p, do_sample)
        return tok, logits, cache, valid, seq_len + new_len

    def prefill(self, input_ids: Sequence[Sequence[int]], images=None,
                gen: Optional[GenerationConfig] = None,
                generator: Optional[torch.Generator] = None) -> Prefilled:
        """Pad the prompts to the bucket of the longest and prefill them
        together (with their (B, T, 3, H, W) frames, if any): each row's
        first token, its logits and the cache."""
        gen = gen or GenerationConfig()
        if not input_ids or any(len(x) == 0 for x in input_ids):
            raise ValueError("every prompt must contain at least one token")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(gen.seed)
        lens = np.array([len(x) for x in input_ids], np.int64)
        bucket = self.pick_bucket(int(lens.max()))
        ids = np.zeros((len(input_ids), bucket), np.int64)
        for i, row in enumerate(input_ids):
            ids[i, :len(row)] = row
        tok, logits, cache, valid = self._prefill(
            torch.from_numpy(ids).to(self.device),
            self._prepare_images(images, len(input_ids)),
            torch.from_numpy(lens).to(self.device), generator,
            gen.temperature, gen.top_p, gen.do_sample,
            bucket + self.max_new_tokens + self.steps_per_call)
        return Prefilled(tok, logits, cache, valid, bucket)

    def generate_tokens(self, input_ids: Sequence[Sequence[int]],
                        images=None,
                        gen: Optional[GenerationConfig] = None,
                        eos_ids: Sequence[int] = (2,),
                        ) -> Iterator[np.ndarray]:
        """Yield one (B,) int32 token array per generated step for the B
        ragged prompts, decoded in lockstep until every row has stopped
        (a row's tokens after its eos are the model's and are still
        yielded, as in JAX)."""
        gen = gen or GenerationConfig()
        generator = torch.Generator(self.device).manual_seed(gen.seed)
        state = self.prefill(input_ids, images, gen, generator)
        tok, cache, valid = state.token, state.cache, state.valid
        seq_len = torch.tensor([len(x) for x in input_ids],
                               device=self.device)
        slot = state.bucket   # the prompt chunk occupied [0, bucket)

        max_new = min(gen.max_new_tokens, self.max_new_tokens)
        if max_new <= 0:
            return
        alive = np.ones(len(input_ids), bool)
        eos_arr = np.asarray(eos_ids)
        tok_np = tok.cpu().numpy().astype(np.int32)
        yield tok_np
        alive &= ~np.isin(tok_np, eos_arr)
        step = 1
        sched = self._ramp_iter()
        while step < max_new and alive.any():
            n_steps = min(next(sched), max_new - step)
            toks, seq_len = self._decode(cache, valid, tok, slot, seq_len,
                                         generator, gen, n_steps)
            slot += n_steps
            tok = toks[-1]
            toks_np = toks.cpu().numpy().astype(np.int32)   # (n_steps, B)
            for i in range(n_steps):
                if not alive.any():
                    return
                yield toks_np[i]
                alive &= ~np.isin(toks_np[i], eos_arr)
                step += 1

    def generate(self, tokenizer, input_ids: Sequence[int], images=None,
                 gen: Optional[GenerationConfig] = None) -> Iterator[str]:
        """Single-prompt streaming generation: the accumulated text every
        ``stream_interval`` tokens and at the end, with keyword stopping."""
        gen = gen or GenerationConfig()
        eos = [getattr(tokenizer, "eos_token_id", 2) or 2]
        yield from stream_text(
            (int(t[0]) for t in self.generate_tokens(
                [list(input_ids)], images, gen, eos_ids=eos)),
            tokenizer, gen)


def stream_text(token_iter, tokenizer, gen: GenerationConfig
                ) -> Iterator[str]:
    """Token ids -> accumulated-text chunks every ``stream_interval``
    tokens, cut at the first stop string."""
    out_tokens: list[int] = []
    text = ""
    for step, tok in enumerate(token_iter):
        out_tokens.append(int(tok))
        if (step + 1) % gen.stream_interval == 0:
            text = tokenizer.decode(out_tokens, skip_special_tokens=True)
            stopped, text = _apply_stops(text, gen.stop)
            yield text
            if stopped:
                return
    text = tokenizer.decode(out_tokens, skip_special_tokens=True)
    _, text = _apply_stops(text, gen.stop)
    yield text


# Rolling window (tokens) for incremental stop detection: a stop string
# spans a handful of tokens.
_STOP_WINDOW = 48


def find_stop_index(tokens: Sequence[int], stops: Sequence[str],
                    tokenizer, window: int = _STOP_WINDOW) -> Optional[int]:
    """Smallest count ``i`` such that decoding ``tokens[:i]`` shows a stop
    string, searched over a rolling window of the trailing ``window``
    tokens; None when no stop appears."""
    for i in range(1, len(tokens) + 1):
        text = tokenizer.decode(tokens[max(0, i - window):i],
                                skip_special_tokens=True)
        if any(s in text for s in stops):
            return i
    return None


def _apply_stops(text: str, stops: Sequence[str]) -> tuple[bool, str]:
    for s in stops:
        idx = text.find(s)
        if idx >= 0:
            return True, text[:idx]
    return False, text


# -- multi-turn sessions ----------------------------------------------------

@torch.inference_mode()
def _trim_valid(valid: torch.Tensor, keep_below: int, drop_until: int
                ) -> None:
    """Invalidate slots [keep_below, drop_until) in place (engine.py:681-687):
    tokens decoded past the stopping point must not reach later turns."""
    valid[:, keep_below:drop_until] = False


@torch.inference_mode()
def _compact_cache(cache: llama.KVCache, valid: torch.Tensor):
    """Pack each row's valid slots to the front, in their order
    (engine.py:690-708): a stable permutation of the slot axis applied to
    K, V and the scales, reclaiming the chunks' pow-2 padding and trimmed
    slots.  Decode attention does not see slot order (rotary positions live
    in the stored K; validity is the mask).  Returns (cache, valid,
    n_valid (B,)), new tensors."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    rows = torch.arange(valid.shape[0], device=valid.device)[:, None]

    def gather(x):
        return None if x is None else x[:, rows, order]

    cache = llama.KVCache(*(gather(x) for x in (cache.k, cache.v,
                                                cache.k_scale,
                                                cache.v_scale)))
    n_valid = valid.sum(dim=1)
    slots = torch.arange(valid.shape[1], device=valid.device)
    return cache, slots[None, :] < n_valid[:, None], n_valid


@torch.inference_mode()
def _grow_cache(frag: llama.KVCache, valid: torch.Tensor, total_len: int):
    """Fresh session-size buffers (slot axis 2) holding a prefix fragment at
    the front (engine.py:560-574): a session decoding into them never
    writes the stored fragment."""
    def grow(x):
        if x is None:
            return None
        out = x.new_zeros(x.shape[:2] + (total_len,) + x.shape[3:])
        out[:, :, :x.shape[2]] = x
        return out

    new_valid = valid.new_zeros((valid.shape[0], total_len))
    new_valid[:, :valid.shape[1]] = valid
    return llama.KVCache(*(grow(x) for x in (frag.k, frag.v, frag.k_scale,
                                             frag.v_scale))), new_valid


class ChatSession:
    """Multi-turn generation with the KV cache kept across turns (B = 1), the
    counterpart of JAX's ``ChatSession`` (engine.py:711-892).

    The first turn prefills into a cache with room for later turns; each
    later turn appends only its new tokens (`Engine._extend`) instead of
    prefilling the whole conversation again.  Pass the new token ids of
    each turn, framed as the conversation template frames them (the '###'
    separators: deltas are tokenized alone).  Tokens decoded past an eos or
    a stop string are trimmed from the cache.  The session samples from a
    ``torch.Generator`` seeded from ``gen.seed``.  ``prefills``,
    ``extends``, ``decode_steps`` and ``compactions`` count what it ran.
    """

    def __init__(self, engine: Engine, gen: Optional[GenerationConfig] = None,
                 extra_slots: Optional[int] = None):
        self.engine = engine
        self.gen = gen or GenerationConfig()
        self.generator = torch.Generator(engine.device).manual_seed(
            self.gen.seed)
        # (cache, valid, conversation length, next free slot, pending token)
        self._state = None
        self.extra_slots = extra_slots
        # room the JAX session keeps beyond gen.max_new_tokens to pad its last
        # fused call up to a compiled size (engine.py:736); eager decode pads
        # nothing, but the same room keeps the cache size and the turns that
        # compact the JAX session's
        self._decode_slack = engine.steps_per_call
        self.prefills = self.extends = self.decode_steps = 0
        self.compactions = 0

    @property
    def started(self) -> bool:
        return self._state is not None

    @torch.inference_mode()
    def chat(self, new_ids: Sequence[int], images=None, tokenizer=None,
             eos_ids: Sequence[int] = (2,), on_token=None) -> list:
        """Run one turn; returns the kept reply ids (the eos kept, anything
        after it and any stop string removed).  ``on_token(id)`` sees each
        token as it reaches the host (a few past the stop included).  With
        a ``tokenizer``, the stop strings of ``gen.stop`` apply."""
        tok, _, cache, valid, seq, slot = self._start_turn(new_ids, images)
        decode_start = slot
        max_new = min(self.gen.max_new_tokens, self.engine.max_new_tokens)
        eos_arr = np.asarray(eos_ids)
        tokens, slot = self._decode_loop(cache, valid, tok, seq, slot,
                                         max_new, eos_arr, tokenizer,
                                         on_token)
        kept = self._kept_count(tokens, eos_arr, tokenizer)
        pending = tokens[kept - 1] if kept == len(tokens) else None
        # decode wrote the KV of tokens[i] at decode_start + i when it fed
        # it back; a last kept token never fed back (pending) has no slot
        # yet: the next turn writes it
        commit = decode_start + kept - (1 if pending is not None else 0)
        _trim_valid(valid, commit, slot)
        self._state = (cache, valid, seq + kept, commit, pending)
        return tokens[:kept]

    @torch.inference_mode()
    def _start_turn(self, new_ids, images):
        """The turn's prefill (first turn) or extend, compacting the cache
        first where the turn would not fit.  Leaves ``_state`` as it was.
        Returns (first token (1,), its logits, cache, valid, conversation
        length, next free slot)."""
        eng, gen = self.engine, self.gen
        if self._state is None:
            return self._first_turn(new_ids, images)
        if images is not None:
            raise ValueError("media is only supported on the first turn")
        cache, valid, seq, slot, pending = self._state
        # the previous turn's last token was sampled but never fed back:
        # it opens this turn's chunk, at position seq - 1
        chunk = ([pending] if pending is not None else []) + list(new_ids)
        start = seq - (1 if pending is not None else 0)
        c = len(chunk)
        cb = 1 << max(4, (max(c, 2) - 1).bit_length())   # pow2 >= 16
        budget = gen.max_new_tokens + self._decode_slack
        if slot + cb + budget > cache.max_len:
            cache, valid, n_valid = _compact_cache(cache, valid)
            slot = int(n_valid[0])
            self.compactions += 1
        if slot + cb + budget > cache.max_len:
            raise RuntimeError(
                f"session cache exhausted (slot={slot} live tokens, need "
                f"{cb + gen.max_new_tokens}, max={cache.max_len}); start a "
                "new ChatSession")
        ids = torch.zeros((1, cb), dtype=torch.long)
        ids[0, :c] = torch.tensor(chunk)
        dev = eng.device
        tok, logits, cache, valid, _ = eng._extend(
            cache, valid, ids.to(dev), torch.tensor([c], device=dev),
            torch.tensor([start], device=dev), slot, self.generator,
            gen.temperature, gen.top_p, gen.do_sample)
        self.extends += 1
        return tok, logits, cache, valid, start + c, slot + cb

    def _first_turn(self, new_ids, images):
        eng, gen = self.engine, self.gen
        n = len(new_ids)
        bucket = eng.pick_bucket(n)
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.tensor(list(new_ids))
        # later turns need room: each takes a pow-2 chunk and its reply
        extra = self.extra_slots
        if extra is None:
            extra = 4 * (eng.max_new_tokens + 64)
        tok, logits, cache, valid = eng._prefill(
            ids.to(eng.device), eng._prepare_images(images, 1),
            torch.tensor([n], device=eng.device), self.generator,
            gen.temperature, gen.top_p, gen.do_sample,
            bucket + eng.max_new_tokens + extra + self._decode_slack)
        self.prefills += 1
        return tok, logits, cache, valid, n, bucket

    def _decode_loop(self, cache, valid, tok, seq: int, slot: int,
                     max_new: int, eos_arr, tokenizer, on_token):
        """Decode in chunks (the engine's ramp, then ``steps_per_call``)
        until an eos, a stop string or ``max_new`` tokens.  Every token but
        a last one never fed back has its KV at consecutive slots from
        ``slot``.  Returns (tokens, the next free slot)."""
        eng, gen = self.engine, self.gen
        t0 = int(tok[0])
        tokens = [t0]
        if on_token:
            on_token(t0)
        stopped = t0 in eos_arr
        sched = eng._ramp_iter()
        while len(tokens) < max_new and not stopped:
            # eager steps: the last chunk runs exactly the steps left, where
            # JAX pads it up to a compiled size and trims the surplus
            n_steps = min(next(sched), max_new - len(tokens))
            # the pending input tokens[-1] sits at position seq + len - 1
            toks, _ = eng._decode(cache, valid, tok, slot, torch.tensor(
                [seq + len(tokens) - 1], device=eng.device), self.generator,
                gen, n_steps)
            slot += n_steps
            self.decode_steps += n_steps
            tok = toks[-1]
            for t in toks[:, 0].tolist():
                tokens.append(t)
                if on_token:
                    on_token(t)
                if t in eos_arr:
                    stopped = True
                    break
            if not stopped and tokenizer is not None and gen.stop:
                # this chunk plus a straddle window, not the whole reply
                text = tokenizer.decode(tokens[-(n_steps + _STOP_WINDOW):],
                                        skip_special_tokens=True)
                stopped = any(s in text for s in gen.stop)
        return tokens, slot

    def _kept_count(self, tokens, eos_arr, tokenizer) -> int:
        kept = len(tokens)
        for i, t in enumerate(tokens):
            if t in eos_arr:
                kept = i + 1      # the eos stays, as the turn's terminator
                break
        if tokenizer is not None and self.gen.stop:
            i = find_stop_index(tokens[:kept], self.gen.stop, tokenizer)
            if i is not None:
                kept = min(kept, i)
        return kept


class PrefixCache:
    """A shared prompt prefix (system prompt and media) prefilled once, from
    which sessions are spawned (engine.py:577-649): many questions about one
    video pay the vision tower and the prefix's prefill once, and each
    spawned session only extends by its question.

    Only the prefix's ``bucket``-slot fragment is kept; each `spawn` copies
    it into fresh session-size buffers.
    """

    def __init__(self, engine: Engine, prefix_ids: Sequence[int],
                 images=None, gen: Optional[GenerationConfig] = None,
                 extra_slots: Optional[int] = None):
        self.engine = engine
        self.gen = gen or GenerationConfig()
        self.prefix_ids = [int(t) for t in prefix_ids]
        eng = engine
        n = len(self.prefix_ids)
        bucket = eng.pick_bucket(n)
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.tensor(self.prefix_ids)
        self._extra = extra_slots if extra_slots is not None \
            else 4 * (eng.max_new_tokens + 64)
        # prefill only: the sampled token is dropped (each session goes on
        # with its own question)
        _tok, _lg, cache, valid = eng._prefill(
            ids.to(eng.device), eng._prepare_images(images, 1),
            torch.tensor([n], device=eng.device),
            torch.Generator(eng.device).manual_seed(self.gen.seed),
            self.gen.temperature, self.gen.top_p, False,
            bucket + eng.max_new_tokens + self._extra + eng.steps_per_call)
        self._frag = llama.KVCache(*(
            None if x is None else x[:, :, :bucket].clone()
            for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
        self._valid = valid[:, :bucket].clone()
        self._seq = n
        self._slot = bucket

    @torch.inference_mode()
    def spawn(self, gen: Optional[GenerationConfig] = None,
              speculative: bool = False, seed: Optional[int] = None
              ) -> ChatSession:
        """A new session whose cache holds the prefix.  Pass only the new
        tokens (the question, framed with the separators) to its
        ``chat``."""
        if speculative:
            raise NotImplementedError(
                "speculative sessions (SpecChatSession) are not ported yet: "
                "ROADMAP §1 item 5")
        sess = ChatSession(self.engine, gen or self.gen)
        if seed is not None:
            sess.generator.manual_seed(seed)
        total = (self._slot + self.engine.max_new_tokens + self._extra
                 + sess._decode_slack)
        cache, valid = _grow_cache(self._frag, self._valid, total)
        sess._state = (cache, valid, self._seq, self._slot, None)
        return sess
