"""Video decoding and frame sampling.

The PyTorch port's copy of ``valley_tpu/data/video.py``.  Replaces the
reference's decord-based `load_video` (`valley/util/data_util.py:249-303`)
with OpenCV's FFMPEG-backed `VideoCapture`; the JAX package's native C++
decoder is not ported.  Sampling semantics are identical: ``fixed`` mode takes
``np.linspace(0, N-1, k)`` frame indices (`data_util.py:263-266`), ``fps``
mode strides by round(avg_fps)/fps_number (`:267-271`); a directory of
frame images is also supported (`:283-302`).  Beyond the reference, an
``adaptive`` mode decodes a 4x candidate pool and keeps the k most
visually distinct frames (`select_diverse` — content-aware sampling for
long/repetitive videos).  Output: (C, T, H, W) fp32, resize-256 /
centercrop-224 / CLIP-normalized.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

import numpy as np

from valley_tpu_torch.data import transforms as T


def _decode_indices_cv2(path: str, indices: np.ndarray) -> List[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = {}
    want = sorted(set(int(i) for i in indices))
    pos = 0
    wi = 0
    # Sequential decode grabbing wanted frames — avoids unreliable seeks.
    while wi < len(want):
        ok = cap.grab()
        if not ok:
            break
        if pos == want[wi]:
            ok, frame = cap.retrieve()
            if not ok:
                break
            frames[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            wi += 1
        pos += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last = frames[max(frames)]
    return [frames.get(int(i), last) for i in indices]


def _video_meta_cv2(path: str) -> tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    if n <= 0:
        # Some containers misreport; count by decoding.
        cap = cv2.VideoCapture(path)
        n = 0
        while cap.grab():
            n += 1
        cap.release()
    return n, fps


def sample_indices(video_len: int, frame_mode: str = "fixed",
                   fixed_frame_number: int = 8, fps: float = 30.0,
                   fps_number: float = 0.5) -> np.ndarray:
    if frame_mode == "fixed":
        return np.linspace(0, video_len - 1,
                           fixed_frame_number).astype(np.int64)
    if frame_mode == "fps":
        offset = int(round(fps) / fps_number)
        return np.arange(0, video_len, max(offset, 1), dtype=np.int64)
    if frame_mode == "adaptive":
        # candidate pool for content-aware selection (select_diverse)
        return np.linspace(0, video_len - 1,
                           min(video_len, 4 * fixed_frame_number)
                           ).astype(np.int64)
    raise ValueError('frame_mode must be "fixed", "fps" or "adaptive"')


def select_diverse(frames: List[np.ndarray], k: int) -> List[int]:
    """Pick the ``k`` most visually distinct frames, in temporal order.

    Training-free greedy farthest-point selection over 16x16 grayscale
    thumbnails (zero-mean, L2-normalized): long or repetitive videos
    keep their distinct shots instead of uniform samples landing on
    near-duplicates.  The reference only offers uniform/fps sampling
    (`data_util.py:263-271`); content-aware selection follows the
    frame-selection directions surveyed in PAPERS.md, with no learned
    components (pure numpy, ~microseconds per candidate)."""
    if len(frames) <= k:
        return list(range(len(frames)))

    def thumb(f):
        h, w = f.shape[:2]
        ys = np.linspace(0, h - 1, 16).astype(int)
        xs = np.linspace(0, w - 1, 16).astype(int)
        g = f[ys][:, xs].astype(np.float32)
        if g.ndim == 3:
            g = g.mean(-1)
        g = g - g.mean()
        n = np.linalg.norm(g)
        return (g / n if n else g).ravel()

    t = np.stack([thumb(f) for f in frames])          # (N, 256)
    chosen = [0]
    d = np.linalg.norm(t - t[0], axis=1)
    while len(chosen) < k:
        i = int(np.argmax(d))
        if d[i] <= 0:   # all remaining are duplicates: fill uniformly
            rest = [j for j in range(len(frames)) if j not in chosen]
            chosen.extend(rest[:k - len(chosen)])
            break
        chosen.append(i)
        d = np.minimum(d, np.linalg.norm(t - t[i], axis=1))
    return sorted(chosen[:k])


def hot_path_transform(crop_size: int = 224, scale_size: int = 256):
    """The load_video preprocessing pipeline (`data_util.py:274-281`)."""
    return T.Compose([
        T.Resize(scale_size),
        T.CenterCrop(crop_size),
        T.ClipToTensor(channel_nb=3),
        T.Normalize(mean=T.CLIP_MEAN, std=T.CLIP_STD),
    ])


def _raw_clip(frames, crop_size: int, scale_size: int) -> np.ndarray:
    """Resize+crop only -> (C, T, H, W) uint8 (device-side normalization
    path: `valley.encode_images` CLIP-normalizes uint8 frames on device,
    halving the host->device transfer vs bf16-normalized pixels)."""
    pipe = T.Compose([T.Resize(scale_size), T.CenterCrop(crop_size)])
    out = np.stack([np.asarray(f, np.uint8) for f in pipe(frames)])
    return np.transpose(out, (3, 0, 1, 2))          # (C, T, H, W)


def load_video(path: str,
               image_processor=None,
               frame_mode: str = "fixed",
               fixed_frame_number: int = 8,
               fps_number: float = 0.5,
               frame_process_method: str = "centercrop",
               crop_size: int = 224,
               scale_size: int = 256,
               raw_pixels: bool = False) -> np.ndarray:
    """Decode + sample + preprocess a video file or frame directory.

    Returns (C, T, H, W) fp32 — same layout as the reference (callers
    permute to (T, C, H, W) for the model, `dataset.py:122`).
    ``raw_pixels=True`` skips CLIP normalization and returns uint8
    (serving path: normalization runs on device, `valley.encode_images`;
    1 byte/pixel over the host->device link instead of 2).
    """
    if os.path.isfile(path):
        frames = _load_file(path, frame_mode, fixed_frame_number, fps_number)
        if raw_pixels:
            return _raw_clip(frames, crop_size, scale_size)
        return hot_path_transform(crop_size, scale_size)(frames)

    # Directory of frame images (`data_util.py:283-302`).
    frame_paths = sorted(Path(path).rglob("*"))
    frame_paths = [p for p in frame_paths if p.is_file()]
    if not frame_paths:
        raise IOError(f"no frames found under {path}")
    if frame_mode in ("fixed", "adaptive"):
        idx = sample_indices(len(frame_paths), frame_mode,
                             fixed_frame_number)
        frame_paths = [frame_paths[int(i)] for i in idx]
    elif frame_mode == "fps":
        raise ValueError("A frame folder does not support fps mode")
    else:
        raise ValueError('frame_mode must be "fixed" or "adaptive"')

    from PIL import Image

    frames = [np.asarray(Image.open(str(p)).convert("RGB"))
              for p in frame_paths]
    if frame_mode == "adaptive":
        frames = [frames[i] for i in
                  select_diverse(frames, fixed_frame_number)]
    if frame_process_method == "resize":
        min_len = min(frames[0].shape[:2])
        frames = [T._resize_frame(f, (min_len, min_len)) for f in frames]
    if image_processor is not None:
        import torch  # HF processors return torch tensors

        pixel = image_processor.preprocess(
            [Image.fromarray(f) for f in frames],
            return_tensors="pt")["pixel_values"]
        return np.transpose(np.asarray(pixel), (1, 0, 2, 3))
    if raw_pixels:
        return _raw_clip(frames, crop_size, scale_size)
    return hot_path_transform(crop_size, scale_size)(frames)


def _load_file(path: str, frame_mode: str, fixed_frame_number: int,
               fps_number: float) -> List[np.ndarray]:
    n, fps = _video_meta_cv2(path)
    idx = sample_indices(n, frame_mode, fixed_frame_number, fps, fps_number)
    frames = _decode_indices_cv2(path, idx)
    if frame_mode == "adaptive":
        frames = [frames[i] for i in
                  select_diverse(frames, fixed_frame_number)]
    return frames


def load_video_tchw(path: str, **kw) -> np.ndarray:
    """(T, C, H, W) convenience layout used by the model
    (`dataset.py:122` permute)."""
    return np.transpose(load_video(path, **kw), (1, 0, 2, 3))
