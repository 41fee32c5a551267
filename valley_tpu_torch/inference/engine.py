"""Streaming inference engine, the PyTorch counterpart of
``valley_tpu/inference/engine.py``: a batch of ragged prompts prefilled
together and decoded in lockstep (the continuous-batching pool built on it
is ``inference/continuous.py``).

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
