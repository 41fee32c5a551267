"""Clip (video) transform library — numpy/cv2 host-side preprocessing.

The PyTorch port's own copy of
``valley_tpu/data/transforms.py`` (numpy only, no jax), so that the port
imports nothing of the JAX package.

Functional parity with the reference's `valley/data/video_transform.py`
(751 LoC of clip transforms); the hot path used by `load_video`
(`valley/util/data_util.py:272-281`) is Resize(256) -> CenterCrop(224) ->
ClipToTensor -> Normalize(CLIP stats).  All transforms operate on a list of
HxWx3 uint8/float numpy frames (or the (C, T, H, W) float tensor after
`ClipToTensor`), so the whole pipeline stays on host CPU feeding the TPU
input queue; augmentations accept an optional seeded `numpy.random.Generator`
for reproducibility (the torch originals used global RNG).
"""

from __future__ import annotations

import numbers
from typing import Iterable, List, Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_frame(frame: np.ndarray, size, interpolation="bilinear"):
    """Resize one HxWx3 frame.  ``size`` is (w, h) or an int meaning
    'shorter side -> size' preserving aspect ratio."""
    h, w = frame.shape[:2]
    if isinstance(size, numbers.Number):
        if (w <= h and w == size) or (h <= w and h == size):
            return frame
        if w < h:
            ow, oh = int(size), int(size * h / w)
        else:
            ow, oh = int(size * w / h), int(size)
    else:
        ow, oh = size
    if cv2 is not None:
        interp = cv2.INTER_LINEAR if interpolation == "bilinear" \
            else cv2.INTER_NEAREST
        return cv2.resize(frame, (ow, oh), interpolation=interp)
    from PIL import Image

    mode = Image.BILINEAR if interpolation == "bilinear" else Image.NEAREST
    return np.asarray(Image.fromarray(frame.astype(np.uint8)).resize(
        (ow, oh), mode))


class Compose:
    def __init__(self, transforms: Iterable):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip


class TensorToNumpy:
    """(C, T, H, W) tensor/array -> list of HxWx3 uint8-ish frames
    (inverse of ClipToTensor, reference `video_transform.py:744`)."""

    def __call__(self, clip):
        arr = np.asarray(clip)
        return [np.moveaxis(arr[:, t], 0, -1) for t in range(arr.shape[1])]


class ToTensor:
    """Array pass-through (reference `video_transform.py:167` wraps a
    numpy array in torch.from_numpy; here arrays ARE the tensor type,
    so this normalizes any array-like to np.ndarray)."""

    def __call__(self, array):
        return np.asarray(array)


class ClipToTensor:
    """List of T HxWxC frames -> (C, T, H, W) float array in [0, 1]
    (reference `video_transform.py:113`)."""

    def __init__(self, channel_nb=3, div_255=True, numpy=True):
        self.channel_nb = channel_nb
        self.div_255 = div_255

    def __call__(self, clip: Sequence[np.ndarray]) -> np.ndarray:
        frames = [np.asarray(f, np.float32) for f in clip]
        out = np.stack(frames, axis=0)            # (T, H, W, C)
        if out.shape[-1] != self.channel_nb:
            raise ValueError(
                f"expected {self.channel_nb} channels, got {out.shape[-1]}")
        out = np.transpose(out, (3, 0, 1, 2))     # (C, T, H, W)
        if self.div_255:
            out = out / 255.0
        return out


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, clip):
        return [_resize_frame(f, self.size, self.interpolation)
                for f in clip]


class CenterCrop:
    def __init__(self, size):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size

    def __call__(self, clip):
        ch, cw = self.size
        h, w = clip[0].shape[:2]
        if ch > h or cw > w:
            raise ValueError(f"crop {self.size} larger than frame {(h, w)}")
        y = int(round((h - ch) / 2.0))
        x = int(round((w - cw) / 2.0))
        return [f[y:y + ch, x:x + cw] for f in clip]


class Normalize:
    """Channel-wise (x - mean) / std on a (C, T, H, W) clip tensor
    (reference `video_transform.py:715`)."""

    def __init__(self, mean=CLIP_MEAN, std=CLIP_STD):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1, 1)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return (np.asarray(clip, np.float32) - self.mean) / self.std


# ---------------------------------------------------------------------------
# Augmentations (training-time options; reference `video_transform.py`
# 203-713).  Seeded RNG instead of global state.
# ---------------------------------------------------------------------------

class RandomHorizontalFlip:
    def __init__(self, p=0.5, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        if self.rng.random() < self.p:
            return [np.ascontiguousarray(f[:, ::-1]) for f in clip]
        return clip


class RandomResize:
    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation="bilinear",
                 rng: Optional[np.random.Generator] = None):
        self.ratio = ratio
        self.interpolation = interpolation
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        scale = self.rng.uniform(self.ratio[0], self.ratio[1])
        h, w = clip[0].shape[:2]
        return [_resize_frame(f, (int(scale * w), int(scale * h)),
                              self.interpolation) for f in clip]


class RandomCrop:
    def __init__(self, size, rng: Optional[np.random.Generator] = None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        ch, cw = self.size
        h, w = clip[0].shape[:2]
        if ch > h or cw > w:
            raise ValueError(f"crop {self.size} larger than frame {(h, w)}")
        y = int(self.rng.integers(0, h - ch + 1))
        x = int(self.rng.integers(0, w - cw + 1))
        return [f[y:y + ch, x:x + cw] for f in clip]


class CornerCrop:
    """Crop one of 5 positions (4 corners + center); random when no
    position given (reference `video_transform.py:323`)."""

    POSITIONS = ("c", "tl", "tr", "bl", "br")

    def __init__(self, size, crop_position=None,
                 rng: Optional[np.random.Generator] = None):
        self.size = int(size) if isinstance(size, numbers.Number) else size
        self.crop_position = crop_position
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        s = self.size
        h, w = clip[0].shape[:2]
        pos = self.crop_position or self.POSITIONS[
            int(self.rng.integers(0, 5))]
        if pos == "c":
            y, x = (h - s) // 2, (w - s) // 2
        elif pos == "tl":
            y, x = 0, 0
        elif pos == "tr":
            y, x = 0, w - s
        elif pos == "bl":
            y, x = h - s, 0
        else:
            y, x = h - s, w - s
        return [f[y:y + s, x:x + s] for f in clip]


def _rotate(frame, angle):
    if cv2 is not None:
        h, w = frame.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        return cv2.warpAffine(frame, m, (w, h))
    from PIL import Image

    return np.asarray(Image.fromarray(frame.astype(np.uint8)).rotate(angle))


class RandomRotation:
    """One random angle for the whole clip (reference
    `video_transform.py:375`)."""

    def __init__(self, degrees=10, rng: Optional[np.random.Generator] = None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        angle = self.rng.uniform(self.degrees[0], self.degrees[1])
        return [_rotate(f, angle) for f in clip]


class STA_RandomRotation:
    """Spatio-temporal: angle interpolated across frames (reference
    `video_transform.py:417`)."""

    def __init__(self, degrees=10, rng: Optional[np.random.Generator] = None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        t = len(clip)
        bsz = self.rng.uniform(self.degrees[0], self.degrees[1]) / t
        angles = [(i + 1) * bsz for i in range(t)]
        return [_rotate(f, a) for f, a in zip(clip, angles)]


class Each_RandomRotation:
    """Independent random angle per frame (reference
    `video_transform.py:461`)."""

    def __init__(self, degrees=10, rng: Optional[np.random.Generator] = None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        return [_rotate(f, self.rng.uniform(self.degrees[0],
                                            self.degrees[1])) for f in clip]


def _shift_hue(f, shift):
    """Rotate the HSV hue channel by ``shift`` (fraction of a full turn,
    torchvision `adjust_hue` semantics). ``f``: float32 HWC RGB, 0..255."""
    rgb = f / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    safe = np.where(diff > 0, diff, 1.0)
    h = np.select(
        [mx == r, mx == g],
        [((g - b) / safe) % 6.0, (b - r) / safe + 2.0],
        default=(r - g) / safe + 4.0)
    h = np.where(diff > 0, h / 6.0, 0.0)
    s = np.where(mx > 0, diff / np.where(mx > 0, mx, 1.0), 0.0)

    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    frac = h * 6.0 - i
    p = mx * (1.0 - s)
    q = mx * (1.0 - s * frac)
    t = mx * (1.0 - s * (1.0 - frac))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [mx, q, p, p, t, mx])
    g2 = np.choose(i, [t, mx, mx, q, p, p])
    b2 = np.choose(i, [p, p, t, mx, mx, q])
    return np.stack([r2, g2, b2], axis=-1) * 255.0


def _adjust_frame(frame, brightness, contrast, saturation, hue=0.0):
    f = frame.astype(np.float32)
    f = f * brightness
    if contrast != 1.0:
        mean = f.mean()
        f = (f - mean) * contrast + mean
    if saturation != 1.0:
        gray = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
        f = (f - gray[..., None]) * saturation + gray[..., None]
    if hue != 0.0:
        f = _shift_hue(np.clip(f, 0, 255), hue)
    return np.clip(f, 0, 255).astype(frame.dtype)


class ColorJitter:
    """One jitter factor set for the whole clip (reference
    `video_transform.py:549`)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng: Optional[np.random.Generator] = None):
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue
        self.rng = rng or np.random.default_rng()

    def _factors(self):
        r = self.rng
        b = r.uniform(max(0, 1 - self.brightness), 1 + self.brightness) \
            if self.brightness else 1.0
        c = r.uniform(max(0, 1 - self.contrast), 1 + self.contrast) \
            if self.contrast else 1.0
        s = r.uniform(max(0, 1 - self.saturation), 1 + self.saturation) \
            if self.saturation else 1.0
        h = r.uniform(-self.hue, self.hue) if self.hue else 0.0
        return b, c, s, h

    def __call__(self, clip):
        b, c, s, h = self._factors()
        return [_adjust_frame(f, b, c, s, h) for f in clip]


class EachColorJitter(ColorJitter):
    """Independent jitter per frame (reference `video_transform.py:632`)."""

    def __call__(self, clip):
        return [_adjust_frame(f, *self._factors()) for f in clip]


def ColorDistortion(s=1.0, rng: Optional[np.random.Generator] = None):
    """Strength-s color distortion pipeline (reference
    `video_transform.py:175`): jitter (p=0.8-ish, simplified to always)."""
    return Compose([ColorJitter(0.8 * s, 0.8 * s, 0.8 * s, 0.2 * s, rng=rng)])
