"""Model worker: serves the port's Valley engine over HTTP, the counterpart
of ``valley_tpu/serve/model_worker.py`` with its wire protocol, flags and
defaults.

Behavioral parity with `valley/serve/model_worker.py`: registration and a
15 s heartbeat with re-registration when forgotten (`:123-160`), the
status payload (`:169-174`), `/worker_generate_stream` accepting
``{prompt, images|videos, temperature, max_new_tokens, stop}`` where the
prompt carries `<image>`/`<video>` placeholders expanded here
(`:176-241,320-341`), streaming ``{"text": ori_prompt + generated,
"error_code": 0}\\0`` chunks every ``stream_interval`` tokens
(`:278-291`), concurrency limiting (`:461-474`) and the error gate mapping
exceptions to error_code 1 (`:428-449`).  Beyond the reference, as in the
JAX worker: dynamic and continuous batching, session-id multi-turn cache
reuse, a prefix cache of media prompts, self-speculative decoding, the
OpenAI routes and a device-memory budget over all of them.

The engine's use is serialized by one lock per worker (``_engine_lock``,
the pool's prefill lock when a pool serves): on the card a stateless
request decodes by replaying the engine's CUDA graphs, bound to one
static decode state per (batch, cache length), so two requests on one key
would overwrite each other's state, and a graph capture forbids any other
thread's CUDA call.  A stateless request holds the lock from its prefill
to its last token, a session turn or a prefix build for its whole run;
the pool's own threads take it around prefills and captures.  Up to
``limit_model_concurrency`` handler threads still stream at once.

``--speculative`` is on by default, as in JAX: stateless requests decode
through `SpecDecoder`.  A pool (``--batch-window-ms`` < 0) speculates only
when ``--speculative`` is given explicitly: on the card a speculative
pool's round costs more than its drafts can repay (ROADMAP §2 item 7).

``--tensor-parallel N`` serves the weights cut over N ranks, one process a
card under ``torchrun --nproc_per_node N``: every rank loads the engine
on its (1, 1, N) mesh; rank 0 serves HTTP and registers with the
controller, and the other ranks follow its calls on the engine-side
objects (`parallel.lockstep`): the worker makes every such object through
`lockstep.make` and holds the engine through a proxy, so each call it
makes reaches every rank in one order.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import queue as queue_mod
import threading
import time
import uuid
from io import BytesIO
from typing import Optional

import numpy as np
import torch

from valley_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                        DEFAULT_IM_START_TOKEN,
                                        DEFAULT_IMAGE_PATCH_TOKEN,
                                        DEFAULT_IMAGE_TOKEN,
                                        DEFAULT_VI_END_TOKEN,
                                        DEFAULT_VI_START_TOKEN,
                                        DEFAULT_VIDEO_FRAME_TOKEN,
                                        DEFAULT_VIDEO_TOKEN,
                                        WORKER_HEART_BEAT_INTERVAL)
from valley_tpu_torch.parallel.lockstep import make
from valley_tpu_torch.serve import hbm
from valley_tpu_torch.serve.httpd import JsonHttpServer, post_json
from valley_tpu_torch.utils.logging import server_error_msg

logger = logging.getLogger("model_worker")

# extra_slots for PrefixCache entries built by the worker: stateless
# prefix requests are single-turn, so the multi-turn default (4 (max_new +
# 64) slots) is replaced by a 512-slot class; a question suffix longer than
# 512 tokens takes the plain path
_PREFIX_SPAWN_EXTRA = 512


class ModelWorker:
    def __init__(self, controller_addr: str, worker_addr: str,
                 model_name: str, engine, tokenizer,
                 limit_model_concurrency: int = 5,
                 stream_interval: int = 2,
                 no_register: bool = False,
                 num_frames: int = 8,
                 batch_window_ms: float = 0.0,
                 max_batch: int = 4,
                 max_sessions: int = 0,
                 speculative: bool = False,
                 frame_mode: str = "fixed",
                 prefix_cache: int = 0,
                 admit_batch: int = 4,
                 hbm_budget_gb: Optional[float] = None,
                 context_len: Optional[int] = None,
                 raw_pixels: bool = True,
                 speculative_pool: Optional[bool] = None):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_name = model_name
        self.engine = engine
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.frame_mode = frame_mode
        # media loaders emit raw uint8 frames, normalised on the device
        # (`valley.encode_images`); --no-raw-pixels normalises on the host
        self.raw_pixels = raw_pixels
        self.stream_interval = stream_interval
        # prompt clamp (reference `model_worker.py:92`: the model's 2048);
        # --context-len overrides it for long-context engines
        self.context_len = context_len or getattr(
            tokenizer, "model_max_length", 2048)
        self._semaphore = threading.Semaphore(limit_model_concurrency)
        self._limit = limit_model_concurrency
        self._active = 0
        self._active_lock = threading.Lock()
        self.batcher = None
        self.continuous = None
        self._engine_lock = threading.RLock()
        if batch_window_ms > 0:
            from valley_tpu_torch.serve.batcher import DynamicBatcher

            self.batcher = DynamicBatcher(engine, max_batch=max_batch,
                                          window_ms=batch_window_ms,
                                          lock=self._engine_lock)
        elif batch_window_ms < 0:
            # a negative window: iteration-level continuous batching
            from valley_tpu_torch.inference.continuous import \
                ContinuousEngine

            self.continuous = make(
                ContinuousEngine, engine, rows=max_batch,
                admit_batch=admit_batch,
                speculative=speculative if speculative_pool is None
                else speculative_pool, proxy=False)
            # the pool's threads take this lock around every prefill and
            # capture; the worker's own engine work takes it too
            self._engine_lock = self.continuous._prefill_lock
        # session-id mode: multi-turn cache reuse behind the unchanged wire
        # protocol (the client sends the whole conversation; the worker
        # matches its tokens and extends the session by the new ones)
        self.max_sessions = max_sessions
        self._sessions: "dict[str, tuple]" = {}
        self._session_lock = threading.Lock()
        # --prefix-cache N: the cache of up to N (media + system prompt)
        # prefixes; repeat requests about one video skip its prefill.  LRU
        self.prefix_cache_size = prefix_cache
        self._prefix_caches: "dict[str, object]" = {}
        self._prefix_lock = threading.Lock()
        # key -> Event: concurrent misses on one key wait for one build
        self._prefix_inflight: "dict[str, threading.Event]" = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self._stats_lock = threading.Lock()
        self.stats_requests = 0
        self.stats_tokens = 0
        # --speculative: stateless requests decode by n-gram
        # self-speculation (greedy: the same tokens; sampled: the same law)
        self._speculative = speculative
        self.spec_decoder = None
        if speculative and self.continuous is None and self.batcher is None:
            from valley_tpu_torch.inference.speculative import SpecDecoder

            self.spec_decoder = make(SpecDecoder, engine)
        # --hbm-budget: one accountant over everything resident on the card
        # (serve/hbm.py).  None = the card's memory less headroom (off
        # without a card); <= 0 = off
        self.hbm = None
        self.session_refusals = 0
        self.prefix_budget_skips = 0
        total = None
        if hbm_budget_gb is None:
            cap = hbm.device_hbm_bytes()
            if cap:
                # headroom for the allocator's transients and fragmentation
                total = cap - max(2 * hbm.GiB, int(0.10 * cap))
        elif hbm_budget_gb > 0:
            total = int(hbm_budget_gb * hbm.GiB)
        if total:
            self.hbm = hbm.HbmBudget(total)
            self.hbm.register_fixed("weights", hbm.tree_bytes(engine.params))
            dequant = hbm.int4_dequant_bytes(engine.params)
            if dequant:
                # the int4 prefill and extend dequantize one packed
                # projection at a time for a matrix product
                self.hbm.register_fixed("int4_prefill_dequant", dequant)
            slot = hbm.kv_slot_bytes(engine.cfg.text, engine.cache_dtype)
            if self.continuous is not None:
                pool = hbm.tree_bytes(self.continuous._state)
                parked = (self.continuous.ready_depth
                          + self.continuous.admit_batch - 1)
                pool += parked * self.continuous.smax * slot
                self.hbm.register_fixed("pool", pool)
            elif self.batcher is not None:
                rows = max_batch * (engine.buckets[-1]
                                    + engine.max_new_tokens
                                    + engine.steps_per_call) * slot
                self.hbm.register_fixed("batcher", rows)
            else:
                # stateless requests decode one at a time, but on the card
                # each bucket's static decode state stays once used: one a
                # bucket, whatever a request's max_new_tokens
                slots = sum(self.spec_decoder.cache_len(b)
                            if self.spec_decoder is not None else
                            b + engine.max_new_tokens + engine.steps_per_call
                            for b in engine.buckets)
                self.hbm.register_fixed("decode_states", slots * slot)
            logger.info("hbm budget: %s", self.hbm.snapshot())
        if not no_register:
            try:
                self.register_to_controller()
            except Exception as e:
                # the controller may not be up yet: the heartbeat loop
                # keeps registering (`model_worker.py:158-160`)
                logger.warning("initial registration failed (%s); will "
                               "retry from the heartbeat loop", e)
            self._hb = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True)
            self._hb.start()

    # -- control plane ---------------------------------------------------

    def register_to_controller(self):
        logger.info("Register to controller")
        post_json(self.controller_addr + "/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        })

    def _heartbeat_loop(self):
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            self.send_heart_beat()

    def send_heart_beat(self):
        try:
            exist = post_json(self.controller_addr + "/receive_heart_beat", {
                "worker_name": self.worker_addr,
                "queue_length": self.get_queue_length(),
            }, timeout=5).get("exist", False)
            if not exist:
                self.register_to_controller()
        except Exception as e:
            logger.error("heart beat error: %s", e)

    def get_queue_length(self) -> int:
        return max(0, self._active)

    def warmup_serving_paths(self) -> dict:
        """Run once what ``engine.warmup()`` (stateless prefill and decode)
        does not: the prefix-cache, pooled prefix admission, session and
        speculative paths, each greedy and sampled (JAX
        ``model_worker.py:262``).  On the card that captures their graphs
        before traffic arrives.  Returns {"graphs": graphs captured,
        "capture_s": their seconds}."""
        eng = self.engine
        before = _captures(self)
        if self.prefix_cache_size <= 0 and self.max_sessions <= 0 \
                and self.spec_decoder is None:
            return _capture_delta(self, before)
        from valley_tpu_torch.inference.engine import (ChatSession,
                                                       GenerationConfig,
                                                       PrefixCache)

        tok = eng.cfg.tokens
        p = eng.cfg.num_patches
        v = eng.cfg.vision
        gens = (GenerationConfig(max_new_tokens=2, do_sample=False),
                GenerationConfig(max_new_tokens=2, do_sample=True,
                                 temperature=0.7))
        if self.prefix_cache_size > 0:
            for t in (eng.frame_buckets or (self.num_frames,)):
                span = ([tok.im_start] + [tok.im_patch] * p
                        + [tok.im_end] + [tok.vi_start]
                        + [tok.vi_frame] * t + [tok.vi_end])
                images = np.zeros((1, t, 3, v.image_size, v.image_size),
                                  np.uint8 if self.raw_pixels
                                  else np.float32)
                with self._engine_lock, torch.inference_mode():
                    pc = make(PrefixCache, eng, [1] + span, images,
                              extra_slots=_PREFIX_SPAWN_EXTRA)
                    for gen in gens:
                        sess = pc.spawn(gen=gen,
                                        speculative=self._speculative)
                        sess.chat([5, 6], tokenizer=self.tokenizer,
                                  eos_ids=[-1])
                logger.info("warmed prefix path (%d frames)", t)
            if self.continuous is not None:
                from valley_tpu_torch.inference.continuous import _drain

                for suffix_len in (2, 17, 33):
                    for temp in (0.0, 0.7):
                        outq = self.continuous.submit(
                            list(pc.prefix_ids)
                            + list(range(5, 5 + suffix_len)), prefix=pc,
                            max_new_tokens=1, eos_id=-1,
                            temperature=temp)
                        for _ in _drain(outq):
                            pass
                logger.info("warmed pooled prefix admission")
        if self.max_sessions > 0:
            with self._engine_lock, torch.inference_mode():
                for gen in gens:
                    sess = make(ChatSession, eng, gen, extra_slots=512)
                    sess.chat([5, 6], tokenizer=self.tokenizer,
                              eos_ids=[-1])
                    sess.chat([7, 8], tokenizer=self.tokenizer,
                              eos_ids=[-1])
            logger.info("warmed session path")
        if self.max_sessions > 0 and self._speculative:
            # a low-acceptance turn finishes on the plain session loop:
            # force the switch (disable_below 10) to run it
            from valley_tpu_torch.inference.speculative import (
                SpecChatSession, SpecConfig)

            sp = SpecConfig(disable_below=10.0)
            with self._engine_lock, torch.inference_mode():
                for g in gens:
                    gen = GenerationConfig(max_new_tokens=48,
                                           do_sample=g.do_sample,
                                           temperature=g.temperature)
                    sess = make(SpecChatSession, eng, gen, extra_slots=512,
                                spec=sp)
                    sess.chat([5, 6], tokenizer=self.tokenizer,
                              eos_ids=[-1])
            logger.info("warmed adaptive session fallback")
        if self.spec_decoder is not None:
            # in every bucket (its cache length is the bucket's, whatever a
            # request's max_new_tokens), the probe and steady rounds
            # (adaptive off, so high acceptance cannot skip the steady ones)
            # and the plain fallback (forced), in both sampling modes
            # (the settings replaced whole, so that a tensor-parallel
            # worker's followers take them too)
            import dataclasses

            sd = self.spec_decoder
            saved = sd.spec
            budget = 4 * (saved.draft_len + 1) + 8
            lows = (0,) + tuple(eng.buckets[:-1])
            try:
                with self._engine_lock:
                    for low in lows:
                        prompt = [5] * (low + 1)
                        for do_sample, temp in ((False, 0.0), (True, 0.7)):
                            g = GenerationConfig(max_new_tokens=budget,
                                                 do_sample=do_sample,
                                                 temperature=temp)
                            for over in (dict(adaptive=False),
                                         dict(adaptive=True,
                                              disable_below=10.0)):
                                sd.spec = dataclasses.replace(saved, **over)
                                for _ in sd.generate_tokens(prompt, gen=g,
                                                            eos_ids=[-1]):
                                    pass
            finally:
                sd.spec = saved
            logger.info("warmed stateless speculative paths")
        return _capture_delta(self, before)

    def register_graph_memory(self) -> Optional[int]:
        """After warm-up: replace the estimate of the decode states by what
        the engine's and the pool's CUDA graphs hold (their static decode
        states and memory pools, measured).  Returns the bytes registered
        (None without a budget)."""
        if self.hbm is None:
            return None
        held = graph_bytes(self.engine, self.continuous)
        self.hbm.drop_fixed("decode_states")
        self.hbm.register_fixed("graphs", held)
        logger.info("hbm budget after warm-up: %s", self.hbm.snapshot())
        return held

    def _hbm_make_room(self, deficit: int) -> int:
        """Evict across caches for the budget: prefix fragments first (a
        later request prefills again), then idle sessions (the client's
        next turn prefills the whole conversation).  Returns bytes
        freed."""
        if self.hbm is None:
            return 0
        freed = 0
        with self._prefix_lock:
            while self._prefix_caches and freed < deficit:
                k = next(iter(self._prefix_caches))
                self._prefix_caches.pop(k)
                freed += self.hbm.release(f"prefix:{k}")
                logger.info("hbm: evicted prefix %s", k)
        if freed >= deficit:
            return freed
        with self._session_lock:
            while self._sessions and freed < deficit:
                sid = next(iter(self._sessions))
                self._sessions.pop(sid)
                freed += self.hbm.release(f"session:{sid}")
                logger.info("hbm: evicted idle session %s", sid)
        return freed

    def _count(self, tokens: int = 0, requests: int = 0) -> None:
        with self._stats_lock:
            self.stats_requests += requests
            self.stats_tokens += tokens

    def get_status(self) -> dict:
        stats = {"requests": self.stats_requests,
                 "tokens_generated": self.stats_tokens,
                 "active_sessions": len(self._sessions)}
        if self.prefix_cache_size > 0:
            stats["prefix_hits"] = self.prefix_hits
            stats["prefix_misses"] = self.prefix_misses
        sd = self.spec_decoder
        if sd is not None and sd.total_rounds:
            stats["spec_rounds"] = sd.total_rounds
            stats["spec_accept_per_round"] = round(
                sd.total_emitted / sd.total_rounds, 3)
            stats["spec_disables"] = sd._shared.get("disabled", 0)
        ce = self.continuous
        if ce is not None and getattr(ce, "spec_rounds", 0):
            stats["spec_rounds"] = ce.spec_rounds
            stats["spec_accept_per_round"] = round(
                ce.spec_emitted / ce.spec_rounds, 3)
            stats["spec_pool_paused"] = not ce._spec_live
            stats["spec_disables"] = ce.spec_disables
        if self.hbm is not None:
            stats["hbm"] = self.hbm.snapshot()
            if self.session_refusals:
                stats["session_refusals"] = self.session_refusals
            if self.prefix_budget_skips:
                stats["prefix_budget_skips"] = self.prefix_budget_skips
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.get_queue_length(), "stats": stats}

    # -- media -----------------------------------------------------------

    def _media_replace_token(self, num_frames: int) -> str:
        return (DEFAULT_IM_START_TOKEN
                + DEFAULT_IMAGE_PATCH_TOKEN * self.engine.cfg.num_patches
                + DEFAULT_IM_END_TOKEN + DEFAULT_VI_START_TOKEN
                + DEFAULT_VIDEO_FRAME_TOKEN * num_frames
                + DEFAULT_VI_END_TOKEN)

    def _prepare_images(self, prompt: str, images_b64: list):
        """b64 JPEG/PNG list -> (expanded prompt, (1, T, 3, H, W) frames).
        Each image becomes one frame (`model_worker.py:186-218`)."""
        from PIL import Image

        from valley_tpu_torch.data.dataset import preprocess_image

        if prompt.count(DEFAULT_IMAGE_TOKEN) != len(images_b64):
            raise ValueError("Number of images does not match number of "
                             "<image> tokens in prompt")
        size = self.engine.cfg.vision.image_size
        frames = [preprocess_image(
            Image.open(BytesIO(base64.b64decode(img))).convert("RGB"),
            crop_size=size, scale_size=size,
            raw_pixels=self.raw_pixels) for img in images_b64]
        arr = np.stack(frames)[None]  # (1, T, 3, H, W)
        prompt = prompt.replace(DEFAULT_IMAGE_TOKEN,
                                self._media_replace_token(len(frames)))
        return prompt, arr

    def _prepare_videos(self, prompt: str, videos: list):
        """Video paths (a file or a frame directory) or b64 mp4 ->
        (expanded prompt, frames)."""
        from valley_tpu_torch.data.video import load_video

        if prompt.count(DEFAULT_VIDEO_TOKEN) != len(videos):
            raise ValueError("Number of video does not match number of "
                             "<video> tokens in prompt")
        if len(videos) != 1:
            raise ValueError("Only one video per request is supported")
        video = videos[0]
        if not isinstance(video, str) or len(video) > 4096:
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".mp4",
                                             delete=False) as f:
                f.write(base64.b64decode(video))
                video = f.name
        size = self.engine.cfg.vision.image_size
        clip = load_video(video, frame_mode=self.frame_mode,
                          fixed_frame_number=self.num_frames,
                          crop_size=size,
                          scale_size=max(size * 256 // 224, size),
                          raw_pixels=self.raw_pixels)
        frames = np.transpose(clip, (1, 0, 2, 3))[None]  # (1, T, 3, H, W)
        prompt = prompt.replace(
            DEFAULT_VIDEO_TOKEN, self._media_replace_token(frames.shape[1]))
        return prompt, frames

    # -- generation ------------------------------------------------------

    def prepare(self, params: dict):
        """A request's (input ids, frames or None, GenerationConfig,
        expanded prompt): what `generate_stream` decodes, for a caller that
        drives the engine directly."""
        from valley_tpu_torch.inference.engine import GenerationConfig

        prompt = params["prompt"]
        images = None
        if params.get("videos"):
            prompt, images = self._prepare_videos(prompt, params["videos"])
        elif params.get("images"):
            prompt, images = self._prepare_images(prompt, params["images"])
        temperature = float(params.get("temperature", 1.0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)
        input_ids = self.tokenizer.encode(prompt)
        # clamp to the context (reference `model_worker.py:241`) and to the
        # engine's largest bucket
        max_src_len = min(self.context_len - max_new_tokens - 8,
                          self.engine.buckets[-1])
        input_ids = input_ids[-max_src_len:]
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            do_sample=temperature >= 1e-4,
            stop=(stop_str,) if stop_str else (),
            stream_interval=self.stream_interval,
            seed=int(params.get("seed", np.random.randint(1 << 31))))
        return input_ids, images, gen, prompt

    def generate_stream(self, params: dict):
        with torch.inference_mode():
            yield from self._generate_stream(params)

    def _generate_stream(self, params: dict):
        self._count(requests=1)
        ori_prompt = params["prompt"]
        input_ids, images, gen, prompt = self.prepare(params)
        temperature = gen.temperature
        max_new_tokens = gen.max_new_tokens
        stop_str = params.get("stop", None)
        eos_id = getattr(self.tokenizer, "eos_token_id", 2) or 2
        session_id = params.get("session_id")
        if session_id and self.max_sessions > 0:
            yield from self._session_stream(
                session_id, input_ids, images, gen, stop_str, ori_prompt,
                eos_id)
            return
        if (self.prefix_cache_size > 0 and images is not None
                and self.continuous is None and self.batcher is None):
            stream = self._prefix_stream(params, prompt, images, input_ids,
                                         gen, stop_str, ori_prompt, eos_id)
            if stream is not None:
                yield from stream
                return
        lock = None
        if self.continuous is not None:
            # --prefix-cache composes with the pool: repeat same-media
            # requests admit from the cached prefix (only the question's
            # suffix prefills)
            pc = None
            if self.prefix_cache_size > 0 and images is not None:
                found = self._prefix_lookup(params, prompt, images,
                                            input_ids)
                if found is not None:
                    pc = found[0]
            outq = self.continuous.submit(
                input_ids, None if pc is not None else images,
                temperature, gen.top_p, max_new_tokens, eos_id, prefix=pc)
            from valley_tpu_torch.inference.continuous import _drain

            token_iter = ((t,) for t in _drain(outq))
        elif self.batcher is not None:
            outq = self.batcher.submit(input_ids, images, temperature,
                                       gen.top_p, max_new_tokens, eos_id)
            token_iter = ((t,) for t in self.batcher.drain(outq))
        else:
            # the engine's graphs hold one decode state per key: hold the
            # lock from the prefill to the last token
            lock = self._engine_lock
            lock.acquire()
            if self.spec_decoder is not None:
                token_iter = ((t,) for t in self.spec_decoder.generate_tokens(
                    input_ids, images, gen, eos_ids=[eos_id]))
            else:
                token_iter = self.engine.generate_tokens(
                    [input_ids], images, gen, eos_ids=[eos_id])
        try:
            yield from self._stream_tokens(token_iter, stop_str, ori_prompt,
                                           eos_id, max_new_tokens)
        finally:
            if lock is not None:
                close = getattr(token_iter, "close", None)
                if close is not None:
                    close()
                lock.release()

    def _stream_tokens(self, token_iter, stop_str, ori_prompt: str,
                       eos_id: int, max_new_tokens: int):
        pred_ids: list[int] = []
        stopped = False
        emitted = 0
        for i, tok in enumerate(token_iter):
            pred_ids.append(int(tok[0]))
            stopped = pred_ids[-1] == eos_id
            if i % self.stream_interval == 0 or stopped or \
                    i == max_new_tokens - 1:
                cur_out = self.tokenizer.decode(pred_ids,
                                                skip_special_tokens=True)
                if stop_str:
                    pos = cur_out.rfind(stop_str)
                    if pos != -1:
                        cur_out = cur_out[:pos]
                        stopped = True
                emitted += 1
                yield json.dumps({"text": ori_prompt + cur_out,
                                  "error_code": 0}).encode() + b"\0"
            if stopped:
                break
        self._count(tokens=len(pred_ids))
        if not emitted:
            yield json.dumps({"text": ori_prompt,
                              "error_code": 0}).encode() + b"\0"

    def _session_stream(self, session_id: str, input_ids, images, gen,
                        stop_str, ori_prompt: str, eos_id: int):
        """A multi-turn request with cache reuse.  The client sends the
        whole conversation (reference protocol); where its tokens extend
        the session's known ones, only the new ones are prefilled.  With
        --speculative, sessions decode through `SpecChatSession`."""
        if self._speculative:
            from valley_tpu_torch.inference.speculative import \
                SpecChatSession as ChatSession
        else:
            from valley_tpu_torch.inference.engine import ChatSession
        from valley_tpu_torch.inference.engine import CacheExhausted

        with self._session_lock:
            entry = self._sessions.pop(session_id, None)
            if entry is None and len(self._sessions) >= self.max_sessions:
                oldest = next(iter(self._sessions))   # LRU eviction
                self._sessions.pop(oldest)
                if self.hbm is not None:
                    self.hbm.release(f"session:{oldest}")
                logger.info("evicted session %s", oldest)

        # extra_slots rounded up to a multiple of 512, so that sessions of
        # different max_new_tokens share cache sizes
        extra = -(-(2 * gen.max_new_tokens + 256) // 512) * 512

        def new_session():
            sess = make(ChatSession, self.engine, gen, extra_slots=extra)
            if self.hbm is not None and not self.hbm.reserve(
                    f"session:{session_id}", "sessions",
                    hbm.session_cache_bytes(self.engine, extra,
                                            sess._decode_slack),
                    self._hbm_make_room):
                with self._stats_lock:
                    self.session_refusals += 1
                raise RuntimeError(
                    "HBM budget exhausted: cannot admit a new session "
                    "(retry later, or raise --hbm-budget / lower "
                    "--max-sessions)")
            return sess

        session, known = entry if entry else (None, [])
        delta = None
        if session is not None and session.started and \
                list(input_ids[:len(known)]) == known and \
                len(input_ids) > len(known):
            delta = list(input_ids[len(known):])
            session.gen = gen  # per-request sampling settings
        if delta is None:
            session = new_session()
            delta = list(input_ids)
            first_images = images
        else:
            first_images = None

        stream_q: "queue_mod.Queue" = queue_mod.Queue()

        def run_chat():
            nonlocal session, delta
            try:
                with self._engine_lock, torch.inference_mode():
                    try:
                        reply = session.chat(delta, images=first_images,
                                             tokenizer=self.tokenizer,
                                             eos_ids=[eos_id],
                                             on_token=stream_q.put)
                    except CacheExhausted as e:   # a fresh session
                        logger.info("session %s reset: %s", session_id, e)
                        fresh = new_session()
                        reply = fresh.chat(list(input_ids), images=images,
                                           tokenizer=self.tokenizer,
                                           eos_ids=[eos_id],
                                           on_token=stream_q.put)
                        session = fresh
                        delta = list(input_ids)
                stream_q.put(("done", reply))
            except Exception as e:  # delivered to the handler thread
                stream_q.put(("error", e))

        threading.Thread(target=run_chat, daemon=True).start()

        streamed: list = []
        reply = None
        while True:
            item = stream_q.get()
            if isinstance(item, tuple):
                kind, payload = item
                if kind == "error":
                    if self.hbm is not None:
                        self.hbm.release(f"session:{session_id}")
                    raise payload
                reply = payload
                break
            streamed.append(int(item))
            if len(streamed) % self.stream_interval == 0:
                cur = self.tokenizer.decode(streamed,
                                            skip_special_tokens=True)
                if stop_str:
                    pos = cur.rfind(stop_str)
                    if pos != -1:
                        cur = cur[:pos]
                yield json.dumps({"text": ori_prompt + cur,
                                  "error_code": 0}).encode() + b"\0"

        self._count(tokens=len(reply))
        cur_out = self.tokenizer.decode(reply, skip_special_tokens=True)
        if stop_str:
            pos = cur_out.rfind(stop_str)
            if pos != -1:
                cur_out = cur_out[:pos]
        with self._session_lock:
            self._sessions[session_id] = (session,
                                          list(input_ids) + list(reply))
        if self.hbm is not None and session._state is not None:
            # the worst-case estimate corrected to the bytes held
            self.hbm.update(f"session:{session_id}",
                            hbm.tree_bytes(session._state[0]))
        yield json.dumps({"text": ori_prompt + cur_out,
                          "error_code": 0}).encode() + b"\0"

    def _prefix_split(self, prompt: str, input_ids):
        """(prefix_ids, suffix_ids) split after the last media span: the
        part shared by requests about the same media.  The prefix must
        tokenize to a prefix of the whole ids (the boundary is a special
        token); None where it does not, or where the context clamp cut into
        it, and the caller takes the plain path."""
        idx = -1
        for end_tok in (DEFAULT_VI_END_TOKEN, DEFAULT_IM_END_TOKEN):
            pos = prompt.rfind(end_tok)
            if pos >= 0:
                idx = max(idx, pos + len(end_tok))
        if idx < 0:
            return None
        prefix_ids = self.tokenizer.encode(prompt[:idx])
        n = len(prefix_ids)
        if n == 0 or n >= len(input_ids) or \
                list(input_ids[:n]) != list(prefix_ids):
            return None
        return list(prefix_ids), list(input_ids[n:])

    def _prefix_stream(self, params: dict, prompt: str, images, input_ids,
                       gen, stop_str, ori_prompt: str, eos_id: int):
        """A stateless media request through the prefix cache: the media
        and system prompt prefill once per distinct media; each request
        extends by its question and decodes.  Its tokens are the plain
        path's."""
        found = self._prefix_lookup(params, prompt, images, input_ids)
        if found is None:
            return None
        pc, suffix_ids = found
        with self._engine_lock:
            session = pc.spawn(gen=gen, speculative=self._speculative,
                               seed=gen.seed)
        return self._chat_stream(session, suffix_ids, stop_str,
                                 ori_prompt, eos_id)

    def _prefix_lookup(self, params: dict, prompt: str, images, input_ids):
        """(PrefixCache, suffix_ids) for a stateless media request, or None
        where the prompt cannot be split exactly.  md5-keyed over (media,
        prefix tokens, frame settings); LRU."""
        import hashlib

        split = self._prefix_split(prompt, input_ids)
        if split is None:
            return None
        prefix_ids, suffix_ids = split
        if len(suffix_ids) > _PREFIX_SPAWN_EXTRA:
            return None
        h = hashlib.md5()
        for m in (params.get("videos") or params.get("images") or []):
            h.update(m if isinstance(m, bytes) else str(m).encode())
        h.update(np.asarray(prefix_ids, np.int32).tobytes())
        h.update(f"{self.num_frames}/{self.frame_mode}".encode())
        key = h.hexdigest()

        from valley_tpu_torch.inference.engine import PrefixCache

        while True:
            with self._prefix_lock:
                pc = self._prefix_caches.pop(key, None)
                if pc is not None:
                    self.prefix_hits += 1
                    self._prefix_caches[key] = pc   # most recent
                    return pc, suffix_ids
                building = self._prefix_inflight.get(key)
                if building is None:
                    self.prefix_misses += 1
                    self._prefix_inflight[key] = threading.Event()
                    break
            # another request is prefilling this key: wait for it
            building.wait(timeout=120.0)
        try:
            if self.hbm is not None and not self.hbm.reserve(
                    f"prefix:{key}", "prefix",
                    hbm.prefix_fragment_bytes(self.engine, len(prefix_ids)),
                    self._hbm_make_room):
                with self._stats_lock:
                    self.prefix_budget_skips += 1
                logger.info("hbm: budget short, skipping prefix cache")
                return None
            with self._engine_lock, torch.inference_mode():
                pc = make(PrefixCache, self.engine, prefix_ids, images,
                          extra_slots=_PREFIX_SPAWN_EXTRA)
            with self._prefix_lock:
                if len(self._prefix_caches) >= self.prefix_cache_size:
                    evicted = next(iter(self._prefix_caches))
                    self._prefix_caches.pop(evicted)
                    if self.hbm is not None:
                        self.hbm.release(f"prefix:{evicted}")
                    logger.info("evicted prefix %s", evicted)
                self._prefix_caches[key] = pc
        finally:
            with self._prefix_lock:
                ev = self._prefix_inflight.pop(key, None)
            if ev is not None:
                ev.set()
        return pc, suffix_ids

    def _chat_stream(self, session, delta_ids, stop_str, ori_prompt: str,
                     eos_id: int):
        """Stream one `ChatSession` turn as reference wire chunks."""
        stream_q: "queue_mod.Queue" = queue_mod.Queue()

        def run_chat():
            try:
                with self._engine_lock, torch.inference_mode():
                    reply = session.chat(delta_ids, tokenizer=self.tokenizer,
                                         eos_ids=[eos_id],
                                         on_token=stream_q.put)
                stream_q.put(("done", reply))
            except Exception as e:  # delivered to the handler thread
                stream_q.put(("error", e))

        threading.Thread(target=run_chat, daemon=True).start()

        def _cut(text: str) -> str:
            if stop_str:
                pos = text.rfind(stop_str)
                if pos != -1:
                    return text[:pos]
            return text

        streamed: list = []
        while True:
            item = stream_q.get()
            if isinstance(item, tuple):
                kind, payload = item
                if kind == "error":
                    raise payload
                self._count(tokens=len(payload))
                cur = _cut(self.tokenizer.decode(
                    payload, skip_special_tokens=True))
                yield json.dumps({"text": ori_prompt + cur,
                                  "error_code": 0}).encode() + b"\0"
                return
            streamed.append(int(item))
            if len(streamed) % self.stream_interval == 0:
                cur = _cut(self.tokenizer.decode(
                    streamed, skip_special_tokens=True))
                yield json.dumps({"text": ori_prompt + cur,
                                  "error_code": 0}).encode() + b"\0"

    def generate_stream_gate(self, params: dict):
        with self._active_lock:
            self._active += 1
        try:
            with self._semaphore:
                yield from self.generate_stream(params)
        except ValueError as e:
            yield json.dumps({"text": f"{server_error_msg} ({e})",
                              "error_code": 1}).encode() + b"\0"
        except Exception as e:  # parity: the gate maps crashes to code 1
            logger.exception("generate failed")
            yield json.dumps({"text": f"{server_error_msg} ({e})",
                              "error_code": 1}).encode() + b"\0"
        finally:
            with self._active_lock:
                self._active -= 1


def _captures(worker) -> tuple:
    """(graphs captured, their seconds) so far by the worker's engine and
    pool."""
    sets = list(worker.engine.graph_sets.values())
    if worker.continuous is not None:
        sets += [g for g in (worker.continuous._graphs,
                             worker.continuous._spec_graphs) if g is not None]
    return (sum(len(g.keys()) for g in sets),
            sum(g.capture_s for g in sets))


def _capture_delta(worker, before: tuple) -> dict:
    n, s = _captures(worker)
    return {"graphs": n - before[0], "capture_s": s - before[1]}


def graph_bytes(engine, pool=None) -> int:
    """Bytes the CUDA graphs of ``engine`` (and of ``pool``) hold: their
    static decode states, and the segments of their memory pools where the
    allocator's snapshot names them."""
    sets = list(engine.graph_sets.values())
    if pool is not None:
        sets += [g for g in (pool._graphs, pool._spec_graphs)
                 if g is not None]
    total = hbm.tree_bytes([g.state for g in sets])
    handles = {tuple(h) for h in (
        [engine._graph_pool] + [g.pool for g in sets]) if h is not None}
    if handles and torch.cuda.is_available():
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) in handles:
                total += seg["total_size"]
    return total


def build_app(worker: ModelWorker) -> JsonHttpServer:
    app = JsonHttpServer()

    @app.post("/worker_generate_stream")
    def worker_generate_stream(data):
        return worker.generate_stream_gate(data)

    @app.post("/worker_get_status")
    def worker_get_status(_data):
        return worker.get_status()

    # OpenAI-compatible /v1/chat/completions and /v1/models
    from valley_tpu_torch.serve.openai_api import register_openai_routes

    register_openai_routes(app, worker)
    return app


def load_engine(args):
    """Build (engine, tokenizer) from a checkpoint directory or a random
    configuration (``random:tiny``, ``random:7b``, ``random:13b``) with the
    worker's flags (`run_valley.load_model`; ``--lora-path`` merges an
    adapter into a checkpoint's bf16 weights before fusing and quantizing,
    with no quantize-on-load; ``--quantize-vision int8|int8a8`` quantizes
    the tower after the decoder; ``--tensor-parallel N`` cuts the weights
    over the (1, 1, N) mesh of a torchrun world of N, this rank's share on
    its own device: `mesh.serving_mesh`)."""
    from valley_tpu_torch.inference.run_valley import load_model
    from valley_tpu_torch.parallel import distributed
    from valley_tpu_torch.parallel.mesh import serving_mesh

    device = getattr(args, "device", None)
    mesh = serving_mesh(getattr(args, "tensor_parallel", 1), device,
                        "valley_tpu_torch.serve.model_worker")
    if mesh is not None:
        device = distributed.device_for(device or "cuda")
    fb = (getattr(args, "frame_buckets", "") or "").strip()
    fbt = tuple(int(b) for b in fb.split(",")) \
        if fb and fb.lower() != "off" else None
    if fbt and getattr(args, "num_frames", 8) > max(fbt):
        # the configured frame count gets a bucket, so warm-up covers it
        fbt = fbt + (int(args.num_frames),)
    ramp = (getattr(args, "decode_ramp", "") or "").strip()
    ramp = () if not ramp or ramp.lower() == "off" else \
        tuple(int(s) for s in ramp.split(","))
    return load_model(
        args.model_path, device,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_new_tokens=args.max_new_tokens,
        quantize=getattr(args, "quantize", None),
        fused=bool(getattr(args, "fused", False)),
        kv_cache=getattr(args, "kv_cache", "bf16"),
        steps_per_call=int(getattr(args, "steps_per_call", 32) or 32),
        decode_ramp=ramp, frame_buckets=fbt,
        raw_media=bool(getattr(args, "raw_pixels", True)),
        vision_tower=getattr(args, "vision_tower", None),
        lora_path=getattr(args, "lora_path", None),
        quantize_vision=getattr(args, "quantize_vision", None), mesh=mesh)


def build_parser() -> argparse.ArgumentParser:
    """The JAX worker's flags and defaults (``model_worker.py:1030``), and
    ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:21002")
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--model-path", type=str, default="random:tiny",
                        help="a Hugging Face Valley checkpoint directory, "
                             "or random:tiny / random:7b / random:13b")
    parser.add_argument("--model-name", type=str, default="valley")
    parser.add_argument("--vision-tower", type=str, default=None)
    parser.add_argument("--lora-path", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--buckets", type=str, default="256,512,1024,2048")
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--stream-interval", type=int, default=2)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--frame-mode", type=str, default="fixed",
                        choices=["fixed", "adaptive"])
    parser.add_argument("--frame-buckets", type=str, default="1,4,8",
                        help="comma list: pad the media frame axis to the "
                             "smallest bucket (mask-aware pooling); 'off' "
                             "for exact frame counts")
    parser.add_argument("--no-raw-pixels", dest="raw_pixels",
                        action="store_false", default=True,
                        help="normalise frames on the host instead of "
                             "sending raw uint8 frames to the card")
    parser.add_argument("--warmup", action="store_true",
                        help="capture every bucket's graphs and run every "
                             "serving path once before registering")
    parser.add_argument("--steps-per-call", type=int, default=32,
                        help="decode steps per chunk (one CUDA graph "
                             "replay); also the pool's admission "
                             "granularity")
    parser.add_argument("--decode-ramp", type=str, default="2,6",
                        help="comma list of chunk sizes for the first "
                             "chunks of each reply; 'off' disables")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8", "int8a8", "int4", "int4g",
                                 "int4gp", "int4ga8", "int4gpa8"],
                        help="decoder weight quantization: int8, or "
                             "int8a8 (W8A8 prefill); int4 per channel, "
                             "int4g/int4gp with group-128 scales, "
                             "int4ga8/int4gpa8 also with grouped W4A8 "
                             "prefill (int4 is nibble-packed in every "
                             "mode); with a checkpoint directory it runs on "
                             "load, one layer at a time")
    parser.add_argument("--quantize-vision", type=str, default=None,
                        choices=["int8", "int8a8"],
                        help="int8 CLIP tower: weight-only, or W8A8 on "
                             "every tower product")
    parser.add_argument("--kv-cache", type=str, default="bf16",
                        choices=["bf16", "int8"])
    parser.add_argument("--batch-window-ms", type=float, default=0.0,
                        help="dynamic batching: >0 groups requests "
                             "arriving within this window; <0 continuous "
                             "batching over --max-batch rows; 0 off")
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--admit-batch", type=int, default=4)
    parser.add_argument("--prefix-cache", type=int, default=0)
    parser.add_argument("--max-sessions", type=int, default=0)
    parser.add_argument("--tensor-parallel", type=int, default=1)
    parser.add_argument("--speculative", action="store_const", const=True,
                        default=None,
                        help="n-gram self-speculation, on by default for "
                             "stateless requests; given explicitly it also "
                             "makes a pool speculative")
    parser.add_argument("--no-speculative", dest="speculative",
                        action="store_const", const=False)
    parser.add_argument("--fused", action="store_true",
                        help="fused wqkv/w_gateup layout (4 GEMVs a layer "
                             "instead of 7)")
    parser.add_argument("--context-len", type=int, default=None)
    parser.add_argument("--hbm-budget", type=float, default=None,
                        help="device-memory budget in GiB over weights, "
                             "pool, graphs, sessions and prefix caches; "
                             "default the card's memory less headroom; "
                             "<= 0 disables")
    return parser


def make_worker(args, engine, tokenizer) -> ModelWorker:
    """The worker of ``args`` over ``engine``: ``--speculative`` is on
    unless ``--no-speculative``; a pool speculates only when it is given
    explicitly."""
    return ModelWorker(args.controller_address, args.worker_address,
                       args.model_name, engine, tokenizer,
                       args.limit_model_concurrency,
                       args.stream_interval, args.no_register,
                       args.num_frames,
                       batch_window_ms=args.batch_window_ms,
                       max_batch=args.max_batch,
                       max_sessions=args.max_sessions,
                       speculative=args.speculative is not False,
                       frame_mode=args.frame_mode,
                       prefix_cache=args.prefix_cache,
                       admit_batch=args.admit_batch,
                       hbm_budget_gb=args.hbm_budget,
                       context_len=args.context_len,
                       raw_pixels=args.raw_pixels,
                       speculative_pool=args.speculative is True)


def lockstep_engine(engine, tokenizer):
    """The engine as the worker drives it: itself on one device; on a mesh
    (`load_engine` under torchrun), the lead's proxy of it
    (`parallel.lockstep`), every rank having registered the engine and the
    tokenizer in that order.  A follower rank follows the lead's calls
    here until the lead stops, then returns None."""
    if engine.mesh is None:
        return engine
    from valley_tpu_torch.parallel import lockstep

    ls = lockstep.Lockstep()
    ref = ls.register(engine)
    ls.register(tokenizer)
    if ls.lead:
        return lockstep.Proxy(ls, engine, ref)
    ls.follow()
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    engine, tokenizer = load_engine(args)
    engine = lockstep_engine(engine, tokenizer)
    if engine is None:
        # a follower rank: the lead stopped it
        from valley_tpu_torch.parallel import distributed

        distributed.shutdown()
        return
    # stateless requests decode by SpecDecoder unless --no-speculative or a
    # batcher or pool takes them: engine.warmup's plain decode graphs would
    # then hold their states and never replay (warmup_serving_paths warms
    # the decoder's own, and the fallback's at its cache lengths)
    spec_stateless = args.speculative is not False and \
        args.batch_window_ms == 0
    if args.warmup and not spec_stateless:
        logger.info("warming up %s buckets...", engine.buckets)
        t0 = time.perf_counter()
        engine.warmup(frames=args.num_frames)
        logger.info("warmup done in %.1f s", time.perf_counter() - t0)
    worker = make_worker(args, engine, tokenizer)
    if args.warmup and worker.continuous is not None:
        worker.continuous.warmup(
            frames=engine.frame_buckets or args.num_frames)
        logger.info("continuous-batching warmup done")
    if args.warmup:
        done = worker.warmup_serving_paths()
        logger.info("serving-path warmup: %d graphs in %.1f s",
                    done["graphs"], done["capture_s"])
        worker.register_graph_memory()
    app = build_app(worker)
    app.host, app._port = args.host, args.port
    app.serve_forever()


if __name__ == "__main__":
    main()
