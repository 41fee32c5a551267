"""Synthetic inputs of the port's measurements (``chip_smoke.py``, the
K1 numerics tool): the special-token ids of the repo's benchmark request and
the training slice's rows, made with numpy from a seed."""

from __future__ import annotations

import numpy as np

# the special-token ids of bench.py's request
BENCH_TOKENS = dict(im_patch=31996, im_start=31997, im_end=31998,
                    vi_frame=31999, vi_start=31994, vi_end=31995)


class TrainRows:
    """The training slice's synthetic rows, made with numpy from a seed:
    ``n`` rows of 300-512 tokens (the first exactly 512), a masked prompt
    holding the media span, the first half videos of ``frames`` frames and
    the second half single images (the collator pads their frame axis)."""

    def __init__(self, cfg, n: int = 16, seq: int = 512, frames: int = 8):
        rng = np.random.default_rng(0)
        tok = cfg.tokens
        span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
            [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * frames + \
            [tok.vi_end]
        size = cfg.vision.image_size
        lengths = rng.integers(300, seq + 1, n)
        lengths[0] = seq
        self.items = []
        for i, length in enumerate(lengths):
            ids = rng.integers(5, 30000, size=int(length))
            ids[0] = 1
            ids[1:1 + len(span)] = span
            labels = ids.copy()
            labels[:1 + len(span) + int(rng.integers(4, 24))] = -100
            t = frames if i < n // 2 else 1
            self.items.append(dict(
                input_ids=ids, labels=labels,
                image=rng.standard_normal((t, 3, size, size)).astype(
                    np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]
