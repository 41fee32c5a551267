"""Streaming inference engine, the PyTorch counterpart of
``valley_tpu/inference/engine.py``: a batch of ragged prompts prefilled
together and decoded in lockstep (the continuous-batching pool built on it
is ``inference/continuous.py``, speculative decoding
``inference/speculative.py``), and multi-turn conversations that keep
their cache across turns (`ChatSession`, `PrefixCache`).

The cache state is the JAX engine's: the prompt is right-padded to a length
bucket and prefilled at slot 0; decode writes from slot ``bucket`` on,
while the rotary position is the true sequence length, so slots
``[prompt_len, bucket)`` stay invalid throughout decode and attention reads
the (B, Smax) ``valid`` mask, never a length.  The cache holds ``bucket +
max_new_tokens + steps_per_call`` slots, as in the JAX engine.

Tokens are decoded in chunks of ``steps_per_call`` steps (after a
``decode_ramp`` of shorter chunks), with one device-to-host copy per chunk,
as the JAX engine's fused decode calls do.  On the card each chunk of
`Engine.generate_tokens` is one replay of a CUDA graph holding its
``n_steps`` steps (``inference/graphs.py``), one graph per (batch, cache
length, ``n_steps``, ``do_sample``), the keys JAX compiles an executable
for; `Engine.warmup` captures them all.  A final chunk shorter than a
scheduled size is padded up to one (`Engine._tail_steps`) and its surplus
tokens dropped, so requests of any ``max_new_tokens`` replay the same
graphs.  On the CPU, or when a caller asks with ``eager=True``, the same
step runs eagerly, one forward pass per token.  Sessions (`ChatSession`,
`PrefixCache`) decode eagerly: their caches grow and compact, and a graph
is bound to fixed buffers.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.inference.graphs import (DecodeGraphs, DecodeState,
                                               decode_step)
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.ops.attention import KERNELS, Attention
from valley_tpu_torch.parallel.tensor import tensor_parallel

logger = logging.getLogger(__name__)


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
    # torch.multinomial(probs, 1)'s one-sample draw written out (the same
    # numbers from the same generator): argmax of p / q, q ~ Exp(1).  It
    # makes no check of probs that could read the device from the host, so
    # a CUDA graph can capture it.
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    sampled = torch.argmax(probs / noise, dim=-1)
    return torch.where(temperature < 1e-4, greedy, sampled)


class Media(NamedTuple):
    """A prompt batch's frames on the device, and the (B, T) frame mask of
    frame bucketing (None without it)."""
    frames: torch.Tensor
    frame_mask: Optional[torch.Tensor]


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

    ``frame_buckets`` pads the frame axis of a request's media to the
    smallest bucket that holds it and masks the padding out of temporal
    pooling (None: exact frame counts); ``raw_media`` says that requests
    carry uint8 frames, which only `warmup` reads.  ``steps_run`` counts
    the decode steps its chunks ran (padded tails, sessions' and pools'
    steps included; not a capture's warm-up step).  On the card, the graphs
    of `generate_tokens` are kept for each (batch, cache length) with the
    decode state they are bound to (`graph_sets`), in one memory pool.

    ``mesh`` (a (data, fsdp, model) `DeviceMesh`, one process a device)
    cuts ``params`` in place to this rank's share, as JAX's
    ``Engine(mesh=)`` shards them (engine.py:143-151): over ``model``
    Megatron-style (`parallel.sharding.shard_params`; the KV cache then
    holds this rank's kv heads), over ``fsdp`` into slices gathered where
    a layer is read.  Every rank runs every row of a batch (replicated
    over ``data`` and ``fsdp``) and must make the same calls in the same
    order: the collectives pair up by order.  Decode chunks are CUDA
    graphs with the collectives captured inside on NCCL; over gloo (two
    ranks on one card, or the CPU) the engine decodes eagerly
    (`use_graphs`).
    """

    def __init__(self, cfg: ValleyConfig, params: valley.ValleyWeights,
                 buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
                 max_new_tokens: int = 1024,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 steps_per_call: int = 4,
                 decode_ramp: Sequence[int] = (),
                 attention: Attention = KERNELS,
                 frame_buckets: Optional[Sequence[int]] = None,
                 raw_media: bool = False, mesh=None):
        self.cfg = cfg
        self.device = params["llama"]["embed"].device
        self.mesh = mesh
        if mesh is not None:
            from valley_tpu_torch.parallel import sharding

            sharding.shard_params(mesh, params, cfg, serving=True)
        self.params = params
        self.tp = tensor_parallel(params["llama"])
        # the kv heads this rank's cache holds
        self.kv_heads = cfg.text.kv_heads if self.tp is None \
            else self.tp.kv_heads
        self.buckets = tuple(sorted(buckets))
        self.max_new_tokens = max_new_tokens
        self.cache_dtype = cache_dtype
        self.steps_per_call = max(1, steps_per_call)
        self.decode_ramp = tuple(int(s) for s in decode_ramp if int(s) > 0)
        # the chunk sizes decode ever runs: short tails pad up to one
        # (`_tail_steps`), so each is one graph per (batch, cache length)
        self._sched_sizes = tuple(
            sorted(set(self.decode_ramp) | {self.steps_per_call}))
        self.attention = attention
        self.frame_buckets = tuple(sorted(frame_buckets)) \
            if frame_buckets else None
        self.raw_media = raw_media
        self.steps_run = 0
        self.graph_sets: Dict[Tuple[int, int], DecodeGraphs] = {}
        self._graph_pool = None
        self.use_graphs = self.device.type == "cuda" and _graphs_capture(
            mesh)

    def init_cache(self, batch: int, max_len: int) -> llama.KVCache:
        """A zeroed cache of this engine's dtype and this rank's kv
        heads."""
        return llama.init_cache(self.cfg.text, batch, max_len,
                                self.cache_dtype, self.device, self.kv_heads)

    def pick_bucket(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _prepare_images(self, images, batch: int) -> Optional[Media]:
        """Host media (``batch``, T, 3, H, W) -> `Media` on the device, or
        None for text-only prompts.  uint8 frames move as uint8 and are
        normalised on the device; float frames move as bf16.  With
        ``frame_buckets`` the frame axis is padded with zero frames to the
        smallest bucket that holds T (T itself past the largest) and the
        (B, T_bucket) frame mask marks the real ones (JAX engine.py:419-450)."""
        if images is None:
            return None
        t = images if isinstance(images, torch.Tensor) \
            else torch.from_numpy(np.asarray(images))
        if t.dim() != 5 or t.shape[0] != batch:
            raise ValueError(f"want frames ({batch}, T, 3, H, W) for {batch} "
                             f"prompts, got {tuple(t.shape)}")
        if t.dtype != torch.uint8:
            t = t.to(torch.float32).to(torch.bfloat16)
        mask = None
        if self.frame_buckets:
            n = t.shape[1]
            tb = next((fb for fb in self.frame_buckets if n <= fb), n)
            if tb != n:
                t = torch.cat([t, t.new_zeros((batch, tb - n)
                                              + tuple(t.shape[2:]))], dim=1)
            mask = torch.zeros((batch, tb), dtype=torch.bool)
            mask[:, :n] = True
            mask = mask.to(self.device)
        return Media(t.to(self.device), mask)

    def _ramp_iter(self) -> Iterator[int]:
        """Tokens per decode chunk: the ramp once, then steps_per_call."""
        yield from self.decode_ramp
        while True:
            yield self.steps_per_call

    def _tail_steps(self, want: int, room: int) -> int:
        """The size of a final chunk that needs only ``want`` more tokens,
        with ``room`` cache slots left (JAX engine.py:355-374): the smallest
        scheduled size that covers ``want`` and fits, else the exact
        remainder.  The surplus tokens are dropped; greedy tokens do not
        depend on the chunking.  The cache's ``steps_per_call`` spare slots
        leave room for every scheduled size."""
        for s in self._sched_sizes:
            if want <= s <= room:
                return s
        return max(1, min(want, room))

    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, media: Optional[Media],
                 prompt_len: torch.Tensor, generator: torch.Generator,
                 temperature, top_p, do_sample: bool, cache_len: int,
                 cache: Optional[llama.KVCache] = None):
        """Prefill (B, bucket) ids (with their `_prepare_images` media)
        into a fresh cache of ``cache_len`` slots, or into ``cache`` (its
        slots past the bucket are left as they are: ``valid`` masks them),
        as JAX _prefill_impl (engine.py:257-286) does, and sample each
        row's first token; ``temperature``/``top_p`` are scalars or per-row
        (B,) tensors.  Returns (tokens (B,), logits (B, V), cache,
        valid)."""
        cfg = self.cfg
        frames, frame_mask = media or (None, None)
        embeds = valley.build_inputs_embeds(self.params, cfg, ids, frames,
                                            frame_mask)
        if cache is None:
            cache = self.init_cache(ids.shape[0], cache_len)
        elif cache.max_len != cache_len:
            raise ValueError(f"a cache of {cache.max_len} slots, want "
                             f"{cache_len}")
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

    def _step(self, state: DecodeState, generator, do_sample: bool):
        """One decode step of ``state``, in place (`graphs.decode_step`)."""
        return decode_step(self.params["llama"], self.cfg.text,
                           self.attention, state, generator, do_sample)

    @torch.inference_mode()
    def _decode_chunk(self, state: DecodeState, n_steps: int,
                      do_sample: bool, generator,
                      graphs: Optional[DecodeGraphs] = None) -> torch.Tensor:
        """``n_steps`` steps of ``state``: one replay of ``graphs``' graph,
        or (without ``graphs``) the same steps run eagerly.  Returns the
        tokens (n_steps, B)."""
        self.steps_run += n_steps
        if graphs is not None:
            return graphs.run(n_steps, do_sample)
        return torch.stack([self._step(state, generator, do_sample)
                            for _ in range(n_steps)])

    @torch.inference_mode()
    def _decode(self, cache: llama.KVCache, valid: torch.Tensor,
                token: torch.Tensor, slot: int, seq_len: torch.Tensor,
                generator: torch.Generator, gen: GenerationConfig,
                n_steps: int):
        """``n_steps`` eager single-token steps from slot ``slot``;
        ``seq_len`` (B,) is the rotary position of the incoming token.
        Updates the cache and ``valid`` in place.  Returns (tokens
        (n_steps, B), seq_len)."""
        state = DecodeState.start(cache, valid, token, seq_len, slot,
                                  gen.temperature, gen.top_p)
        toks = self._decode_chunk(state, n_steps, gen.do_sample, generator)
        return toks, state.seq

    @torch.inference_mode()
    def graphs_for(self, batch: int, cache_len: int) -> DecodeGraphs:
        """The graphs of decode at (``batch``, ``cache_len``) with the
        static state they are bound to, made at first use (on the card)."""
        key = (batch, cache_len)
        if key not in self.graph_sets:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self.graph_sets[key] = DecodeGraphs(
                DecodeState.empty(self, batch, cache_len),
                self._step, torch.Generator(self.device), self._graph_pool)
        return self.graph_sets[key]

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

    def _pad(self, input_ids: Sequence[Sequence[int]]):
        """Right-pad the prompts to the bucket of the longest: (ids
        (B, bucket), lengths (B,)) on the device, and the bucket."""
        if not input_ids or any(len(x) == 0 for x in input_ids):
            raise ValueError("every prompt must contain at least one token")
        lens = np.array([len(x) for x in input_ids], np.int64)
        bucket = self.pick_bucket(int(lens.max()))
        ids = np.zeros((len(input_ids), bucket), np.int64)
        for i, row in enumerate(input_ids):
            ids[i, :len(row)] = row
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(lens).to(self.device), bucket)

    def prefill(self, input_ids: Sequence[Sequence[int]], images=None,
                gen: Optional[GenerationConfig] = None,
                generator: Optional[torch.Generator] = None) -> Prefilled:
        """Pad the prompts to the bucket of the longest and prefill them
        together (with their (B, T, 3, H, W) frames, if any) into a cache
        of their own: each row's first token, its logits and the cache."""
        gen = gen or GenerationConfig()
        ids, lens, bucket = self._pad(input_ids)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(gen.seed)
        tok, logits, cache, valid = self._prefill(
            ids, self._prepare_images(images, len(input_ids)), lens,
            generator, gen.temperature, gen.top_p, gen.do_sample,
            bucket + self.max_new_tokens + self.steps_per_call)
        return Prefilled(tok, logits, cache, valid, bucket)

    def generate_tokens(self, input_ids: Sequence[Sequence[int]],
                        images=None,
                        gen: Optional[GenerationConfig] = None,
                        eos_ids: Sequence[int] = (2,),
                        eager: bool = False) -> Iterator[np.ndarray]:
        """Yield one (B,) int32 token array per generated step for the B
        ragged prompts, decoded in lockstep until every row has stopped
        (a row's tokens after its eos are the model's and are still
        yielded, as in JAX).

        On the card each decode chunk is a replay of the CUDA graph of
        (B, cache length, chunk size, ``gen.do_sample``), captured at
        first use (`warmup` captures them all), into whose static state the
        prompt is prefilled; ``eager=True`` runs the same steps eagerly on
        a cache of the request's own instead (the reference the graphs are
        held to).  On the CPU, and where `use_graphs` is off, the steps
        always run eagerly."""
        gen = gen or GenerationConfig()
        ids, lens, bucket = self._pad(input_ids)
        b = len(input_ids)
        media = self._prepare_images(images, b)
        # steps_per_call spare slots: the final chunk can always pad up to
        # a scheduled size (JAX engine.py:501-507)
        cache_len = bucket + self.max_new_tokens + self.steps_per_call
        graphs = None
        if self.use_graphs and not eager:
            graphs = self.graphs_for(b, cache_len)
            if graphs.in_use:
                raise RuntimeError(
                    f"another generate_tokens of this engine is decoding "
                    f"{b} prompts at cache length {cache_len}: its graphs "
                    "are bound to one state; finish or close it first")
            graphs.in_use = True
        try:
            yield from self._generate(ids, lens, bucket, media, cache_len,
                                      gen, eos_ids, graphs)
        finally:
            if graphs is not None:
                graphs.in_use = False

    def _generate(self, ids, lens, bucket: int, media, cache_len: int,
                  gen: GenerationConfig, eos_ids,
                  graphs: Optional[DecodeGraphs]) -> Iterator[np.ndarray]:
        b = ids.shape[0]
        # the prompt chunk occupies slots [0, bucket); decode starts there
        if graphs is not None:
            generator = graphs.generator.manual_seed(gen.seed)
            state = graphs.state
            tok, _, _, valid = self._prefill(
                ids, media, lens, generator, gen.temperature, gen.top_p,
                gen.do_sample, cache_len, cache=state.cache)
            state.load(valid, tok, lens, bucket, gen.temperature, gen.top_p)
        else:
            generator = torch.Generator(self.device).manual_seed(gen.seed)
            tok, _, cache, valid = self._prefill(
                ids, media, lens, generator, gen.temperature, gen.top_p,
                gen.do_sample, cache_len)
            state = DecodeState.start(cache, valid, tok, lens, bucket,
                                      gen.temperature, gen.top_p)
        slot = bucket

        max_new = min(gen.max_new_tokens, self.max_new_tokens)
        if max_new <= 0:
            return
        alive = np.ones(b, bool)
        eos_arr = np.asarray(eos_ids)
        tok_np = tok.cpu().numpy().astype(np.int32)
        yield tok_np
        alive &= ~np.isin(tok_np, eos_arr)
        step = 1
        sched = self._ramp_iter()
        while step < max_new and alive.any():
            want = max_new - step
            n_steps = next(sched)
            if n_steps > want:    # the final chunk: pad to a scheduled size
                n_steps = self._tail_steps(want, cache_len - slot)
            toks = self._decode_chunk(state, n_steps, gen.do_sample,
                                      generator, graphs)
            slot += n_steps
            toks_np = toks.cpu().numpy().astype(np.int32)   # (n_steps, B)
            for i in range(min(n_steps, want)):
                if not alive.any():
                    return
                yield toks_np[i]
                alive &= ~np.isin(toks_np[i], eos_arr)
                step += 1

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               frames: Optional[int] = None, with_images: bool = True,
               sampled: bool = True) -> None:
        """Run one request of every (batch size, bucket, frame bucket or
        text, greedy and sampled) through the whole decode schedule (every
        ramp size and ``steps_per_call``), as JAX engine.py:376-417 does to
        compile every executable real traffic hits: on the card that
        captures every graph `generate_tokens` replays.  ``frames`` is the
        frame count to warm without ``frame_buckets`` (default 1)."""
        new = min(1 + sum(self.decode_ramp) + self.steps_per_call,
                  self.max_new_tokens)
        gens = [GenerationConfig(max_new_tokens=new, do_sample=False)]
        if sampled:
            gens.append(GenerationConfig(max_new_tokens=new, do_sample=True,
                                         temperature=0.7))
        frame_counts = self.frame_buckets if (with_images
                                              and self.frame_buckets) \
            else (frames or 1,)
        size = self.cfg.vision.image_size
        media_dt = np.uint8 if self.raw_media else np.float32
        for b in batch_sizes:
            for bucket in self.buckets:
                prompt = [[1] * (bucket // 2) for _ in range(b)]
                media_passes = ([None] if not with_images else
                                [np.zeros((b, t, 3, size, size), media_dt)
                                 for t in frame_counts] + [None])
                for images in media_passes:
                    for gen in gens:
                        for _ in self.generate_tokens(prompt, images, gen,
                                                      eos_ids=[-1]):
                            pass

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


def _graphs_capture(mesh) -> bool:
    """Whether decode on the card runs as CUDA graphs: always on one card;
    on a mesh whose collectives run on NCCL, with them captured in the
    graphs; not over gloo, whose collectives on CUDA tensors go through the
    host and cannot be captured (the engine then decodes eagerly, by this
    rule, never by catching a failed capture)."""
    if mesh is None:
        return True
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend != "nccl":
        logger.info("decode runs eagerly: the process group's backend is "
                    "%s, whose collectives a CUDA graph cannot capture",
                    backend)
        return False
    return True


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


class CacheExhausted(RuntimeError):
    """A session's cache has no room for the next turn: start a new
    session.  Every rank of a tensor-parallel server refuses such a turn
    alike (`parallel.lockstep`)."""
    lockstep_alike = True


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

    # a tensor-parallel server's followers keep their own copy of a session
    # a call makes (`parallel.lockstep`)
    lockstep_object = True

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
            raise CacheExhausted(
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

    lockstep_object = True    # as ChatSession's

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
        ``chat``.  ``speculative`` spawns a `SpecChatSession` whose lookup
        history starts with the prefix (engine.py:630-640)."""
        gen = gen or self.gen
        if speculative:
            from valley_tpu_torch.inference.speculative import \
                SpecChatSession

            sess: ChatSession = SpecChatSession(self.engine, gen)
            sess._hist = list(self.prefix_ids)
        else:
            sess = ChatSession(self.engine, gen)
        if seed is not None:
            sess.generator.manual_seed(seed)
        total = (self._slot + self.engine.max_new_tokens + self._extra
                 + sess._decode_slack)
        cache, valid = _grow_cache(self._frag, self._valid, total)
        sess._state = (cache, valid, self._seq, self._slot, None)
        return sess
