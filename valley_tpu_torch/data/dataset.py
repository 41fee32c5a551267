"""Supervised multimodal dataset + collator.

The PyTorch port's own copy of
``valley_tpu/data/dataset.py`` (numpy only, no jax), so that the port imports
nothing of the JAX package.

Parity with `valley/data/dataset.py`: `HybridDataset` merges an image JSON,
a video JSON and an optional "fashion" JSON, shuffles once
(`dataset.py:20-51`), and per item handles multi-image lists / single image
/ video / text-only with per-source video subfolders (`:56-153`); failures
yield ``('fail', sources)`` tuples which the DataLoader SUBSTITUTES with a
good sample from the same fetch (constant batch size — a shrunken batch
would recompile single-host and diverge multi-host ranks; the collator's
tuple filter remains for direct callers).

TPU-first differences:
* pure numpy (no torch): the collator right-pads ids/labels and, instead
  of the reference's ragged image *lists* (`:185-190`), pads the frame
  axis to a common T and emits a ``frame_mask`` — static shapes for jit;
* optional ``pad_to_multiple`` sequence padding so XLA sees a small set of
  shapes instead of one per batch;
* image preprocessing is the library's own CLIP pipeline (resize shortest
  side + center crop + normalize) — no HF processor dependency on the hot
  path.
"""

from __future__ import annotations

import copy
import json
import logging
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from valley_tpu_torch.constants import IGNORE_INDEX
from valley_tpu_torch.data import transforms as T
from valley_tpu_torch.data.preprocess import (preprocess,
                                        preprocess_multimodal_multiimage)
from valley_tpu_torch.data.video import load_video

logger = logging.getLogger(__name__)


def preprocess_image(image, crop_size: int = 224,
                     scale_size: int = 224,
                     raw_pixels: bool = False) -> np.ndarray:
    """PIL image / HxWx3 array -> (3, H, W) CLIP-normalized fp32 (the
    equivalent of `CLIPImageProcessor.preprocess` on the hot path).
    ``raw_pixels=True`` skips normalization and returns uint8 for
    device-side CLIP normalization (`valley.encode_images`)."""
    frame = np.asarray(image.convert("RGB") if hasattr(image, "convert")
                       else image)
    if raw_pixels:
        out = T.Compose([T.Resize(scale_size),
                         T.CenterCrop(crop_size)])([frame])
        return np.transpose(np.asarray(out[0], np.uint8), (2, 0, 1))
    clip = T.Compose([
        T.Resize(scale_size),
        T.CenterCrop(crop_size),
        T.ClipToTensor(channel_nb=3),
        T.Normalize(),
    ])([frame])
    return clip[:, 0]  # (3, H, W)


class HybridDataset:
    """Map-style dataset over merged conversation JSONs."""

    def __init__(self, data_path: Optional[str], video_path: Optional[str],
                 tokenizer, multimodal_cfg: dict,
                 fashion_data_path: Optional[str] = None,
                 seed: int = 42):
        logger.warning("Loading data...")
        limit = 10 if multimodal_cfg.get("fast_epoch") else None

        def _load(path, lim):
            if path is None:
                return []
            with open(path) as f:
                data = json.load(f)
            return data[:lim] if lim else data

        list_data = _load(data_path, limit)
        list_video = _load(video_path, limit)
        list_fashion = _load(fashion_data_path,
                             100 if limit else None) \
            if multimodal_cfg.get("use_fashion") else []
        self.list_data_dict: List[dict] = list_video + list_data + \
            list_fashion
        random.Random(seed).shuffle(self.list_data_dict)
        self.tokenizer = tokenizer
        self.multimodal_cfg = multimodal_cfg
        self.header_mode = multimodal_cfg.get("conv_mode", "v1")
        self.only_mask_system = multimodal_cfg.get("only_mask_system", False)

    def __len__(self) -> int:
        return len(self.list_data_dict)

    def __getitem__(self, i: int):
        entry = self.list_data_dict[i]
        try:
            return self._get(entry)
        except Exception as e:  # parity: failures become drop-markers
            logger.warning("sample %s failed: %s", entry.get("id", i), e)
            return ("fail", entry)

    # -- per-modality paths ---------------------------------------------

    def _get(self, entry: dict) -> Dict[str, Any]:
        cfg = self.multimodal_cfg
        sources = [entry]
        image = None

        if "image" in entry:
            from PIL import Image

            patch = cfg.get("patch_size", 14)
            crop = cfg.get("crop_size", 224)
            if isinstance(entry["image"], list):
                pil = [Image.open(f) for f in entry["image"]]
                image = np.stack([preprocess_image(p, crop_size=crop,
                                                   scale_size=crop)
                                  for p in pil])
                cur_token_len = (image.shape[2] // patch) * \
                    (image.shape[3] // patch)
                num_image = image.shape[0]
            else:
                image_file = entry["image"]
                folder = cfg.get("image_folder") or "."
                if "train2014" in folder:
                    image_file = "COCO_train2014_" + image_file
                pil = Image.open(f"{folder}/{image_file}")
                if cfg.get("image_aspect_ratio") == "keep":
                    max_hw, min_hw = max(pil.size), min(pil.size)
                    aspect = max_hw / min_hw
                    shortest = int(min(448 / aspect, 224))
                    arr = preprocess_image(pil, crop_size=shortest,
                                           scale_size=shortest)
                else:
                    arr = preprocess_image(pil, crop_size=crop,
                                           scale_size=crop)
                image = arr[None]  # (1, 3, H, W)
                cur_token_len = (image.shape[2] // patch) * \
                    (image.shape[3] // patch)
                num_image = 1
            sources = preprocess_multimodal_multiimage(
                copy.deepcopy([e["conversations"] for e in sources]),
                cfg, cur_token_len, num_image)
        elif "video" in entry:
            video_file = entry["video"] if ".mp4" in entry["video"] \
                else entry["video"] + ".mp4"
            source_dir = entry.get("source", "webvid")
            folder = cfg.get("video_folder") or "."
            video = load_video(f"{folder}/{source_dir}/{video_file}",
                               frame_mode=cfg.get("frame_mode", "fixed"),
                               fixed_frame_number=cfg.get("num_frames", 8),
                               fps_number=cfg.get("fps_number", 0.5),
                               crop_size=cfg.get("crop_size", 224),
                               scale_size=cfg.get("scale_size", 256))
            image = np.transpose(video, (1, 0, 2, 3))  # (T, 3, H, W)
            patch = cfg.get("patch_size", 14)
            cur_token_len = (image.shape[2] // patch) * \
                (image.shape[3] // patch)
            sources = preprocess_multimodal_multiimage(
                copy.deepcopy([e["conversations"] for e in sources]),
                cfg, cur_token_len, image.shape[0])
        else:
            sources = copy.deepcopy([e["conversations"] for e in sources])

        data_dict = preprocess(sources, self.tokenizer, self.header_mode,
                               self.only_mask_system)
        out = dict(input_ids=data_dict["input_ids"][0],
                   labels=data_dict["labels"][0])
        if image is not None:
            out["image"] = image.astype(np.float32)
        elif cfg.get("is_multimodal"):
            size = cfg.get("crop_size", 224)
            out["image"] = np.zeros((1, 3, size, size), np.float32)
        return out


@dataclass
class DataCollatorForSupervisedDataset:
    """Right-pad ids/labels, build the attention mask, frame-pad images.

    ``pad_to_length`` / ``pad_frames_to`` force FIXED output shapes
    (sequence exactly ``pad_to_length``, frame axis at least
    ``pad_frames_to``) instead of the local-batch max.  Required for
    multi-host training — `jax.make_array_from_process_local_data` needs
    every process's shard to agree on shape, and no process sees the
    other ranks' samples — and generally TPU-friendly (one executable
    instead of one per padded-length bucket)."""

    pad_token_id: int = 0
    pad_to_multiple: int = 64
    max_length: Optional[int] = 2048
    pad_to_length: Optional[int] = None
    pad_frames_to: Optional[int] = None
    image_size: int = 224    # all-text fallback media geometry

    def __call__(self, instances: Sequence[Any]) -> Dict[str, np.ndarray]:
        instances = [x for x in instances if not isinstance(x, tuple)]
        if not instances:
            raise ValueError("all samples in the batch failed to load")

        if self.pad_to_length:
            seq = self.pad_to_length
        else:
            seq = max(len(x["input_ids"]) for x in instances)
            if self.pad_to_multiple:
                m = self.pad_to_multiple
                seq = (seq + m - 1) // m * m
            if self.max_length:
                seq = min(seq, self.max_length)

        b = len(instances)
        input_ids = np.full((b, seq), self.pad_token_id, np.int32)
        labels = np.full((b, seq), IGNORE_INDEX, np.int32)
        attention_mask = np.zeros((b, seq), np.int32)
        for i, inst in enumerate(instances):
            ids = np.asarray(inst["input_ids"])[:seq]
            lb = np.asarray(inst["labels"])[:seq]
            input_ids[i, :len(ids)] = ids
            labels[i, :len(lb)] = lb
            attention_mask[i, :len(ids)] = 1

        batch = dict(input_ids=input_ids, labels=labels,
                     attention_mask=attention_mask)

        # with pad_frames_to (fixed-shape / multi-host mode) the media
        # keys must ALWAYS exist: ranks whose local rows happen to be
        # text-only must still produce the same batch pytree structure
        # as media-carrying ranks, or the SPMD step traces differently
        # per process
        has_media = any("image" in inst for inst in instances)
        if has_media or self.pad_frames_to:
            if has_media:
                tmax = max(inst["image"].shape[0] for inst in instances
                           if "image" in inst)
                shape = next(inst["image"].shape[1:]
                             for inst in instances if "image" in inst)
            else:
                tmax = 1
                shape = (3, self.image_size, self.image_size)
            if self.pad_frames_to:
                # fixed-shape mode: the frame axis is EXACTLY
                # pad_frames_to on every rank (a per-rank local max —
                # e.g. one rank drawing a longer fps-mode video — would
                # diverge the global shape and hang the multi-host
                # assembly); samples with more frames truncate
                tmax = self.pad_frames_to
            images = np.zeros((b, tmax) + tuple(shape), np.float32)
            frame_mask = np.zeros((b, tmax), bool)
            for i, inst in enumerate(instances):
                img = inst.get("image")
                if img is None:
                    continue
                t = min(img.shape[0], tmax)
                images[i, :t] = img[:t]
                frame_mask[i, :t] = True
            batch["images"] = images
            batch["frame_mask"] = frame_mask
        return batch


def make_video_supervised_data_module(tokenizer, data_args) -> Dict:
    """Build dataset + collator (`dataset.py:195-220`).  ``data_args`` is
    any object with the reference's DataArguments attributes."""
    g = lambda k, d=None: getattr(data_args, k, d)
    train_dataset = HybridDataset(
        g("data_path"), g("video_data_path"), tokenizer,
        dict(
            conv_mode=g("conv_mode", "v1"),
            only_mask_system=g("only_mask_system", False),
            fast_epoch=g("fast_epoch", False),
            use_fashion=g("use_fashion", False),
            multi_image=g("multi_image", True),
            num_image=g("num_image", 4),
            is_multimodal=g("is_multimodal", False),
            image_token_len=g("image_token_len", 0),
            image_folder=g("image_folder"),
            video_folder=g("video_folder"),
            image_aspect_ratio=g("image_aspect_ratio", "square"),
            use_im_start_end=g("mm_use_im_start_end", False),
            num_frames=g("num_frames", 8),
            frame_mode=g("frame_mode", "fixed"),
            fps_number=g("fps_number", 0.5),
            crop_size=g("crop_size", 224),
            scale_size=g("scale_size", 256),
            patch_size=g("patch_size", 14),
        ),
        fashion_data_path=g("fashion_data_path"))
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    collator = DataCollatorForSupervisedDataset(
        pad_token_id=pad_id,
        max_length=getattr(tokenizer, "model_max_length", 2048))
    return dict(train_dataset=train_dataset, eval_dataset=None,
                data_collator=collator)


class PrefetchLoader:
    """Background-thread prefetch wrapper: video decode + collation (and
    optionally device transfer) for batch N+1..N+depth overlap the train
    step on batch N — the reference gets this from torch DataLoader worker
    processes; here one thread suffices because the heavy decode work is
    in native code that releases the GIL."""

    def __init__(self, loader, depth: int = 2, transform=None):
        self.loader = loader
        self.depth = depth
        self.transform = transform

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch_idx: int = 0):
        import queue as queue_mod
        import threading

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.depth)
        sentinel = object()

        def producer():
            try:
                for batch in self.loader.epoch(epoch_idx):
                    if self.transform is not None:
                        batch = self.transform(batch)
                    q.put(batch)
                q.put(sentinel)
            except BaseException as e:  # surface crashes to the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class DataLoader:
    """Shuffling batch iterator (host-side, numpy).

    ``num_workers`` > 0 fetches the samples of a batch concurrently with a
    thread pool — the heavy per-sample work (native/cv2 video decode,
    JPEG decode, resize) releases the GIL, so threads scale like the
    reference's DataLoader worker *processes* without the IPC cost.

    **Multi-host training** (``process_count`` > 1): ``batch_size`` stays
    the GLOBAL batch size; every process derives the same shuffled order
    from the shared seed and loads only its contiguous
    ``batch_size / process_count`` rows of each global batch — the JAX
    equivalent of torchrun's per-rank DistributedSampler
    (`valley/train/train.sh:1` gives the reference this via 8 ranks each
    running its own DataLoader).  Feed the local rows through
    `parallel.shard_batch`, which assembles them into one logical global
    array via `jax.make_array_from_process_local_data` — no host ever
    materializes the full global batch.
    """

    def __init__(self, dataset, batch_size: int, collator, shuffle=True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 4,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self._last_good = None   # substitution source for all-fail batches
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(
                    f"global batch_size {batch_size} must divide by "
                    f"process_count {process_count}")
            if not drop_last:
                raise ValueError(
                    "drop_last=False is unsupported multi-process: a "
                    "partial final batch cannot split evenly across "
                    "processes (make_array_from_process_local_data "
                    "requires equal per-process shards)")

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _fetch(self, idx):
        if self.num_workers > 1 and len(idx) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                items = list(pool.map(self.dataset.__getitem__,
                                      [int(i) for i in idx]))
        else:
            items = [self.dataset[int(i)] for i in idx]
        # Substitute failed samples (('fail', …) markers) with a good
        # one from the same fetch: the LOCAL batch size must be
        # constant — multi-host ranks must agree on the global shape
        # fed to make_array_from_process_local_data (a shrunken shard
        # on one rank hangs the collective), and a shrunken batch
        # compiles a fresh executable even single-host.
        good = next((x for x in items if not isinstance(x, tuple)), None)
        if good is None:
            # An all-fail batch must not raise mid-epoch: in multi-host
            # fixed-shape mode that kills one rank while its peers block
            # in the collective (hang) — exactly what substitution is
            # for.  Reuse a sample from the last successful fetch; only
            # an all-fail FIRST batch (nothing to substitute from, i.e.
            # systematically broken data paths) is fatal.
            if self._last_good is None:
                raise RuntimeError(
                    f"all {len(items)} samples in the first fetched batch "
                    "failed to load — check data paths / media files")
            logger.warning("all %d samples in a fetched batch failed; "
                           "substituting from the previous batch",
                           len(items))
            good = self._last_good
        self._last_good = good
        return [good if isinstance(x, tuple) else x for x in items]

    def epoch(self, epoch_idx: int = 0):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # identical order on every process: the rank slice below is
            # what partitions the work, not the shuffle
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        per = self.batch_size // self.process_count
        lo, hi = self.process_index * per, (self.process_index + 1) * per
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield self.collator(self._fetch(idx[lo:hi]))
