"""Checkpoints of the PyTorch port, in HF-Trainer-style ``checkpoint-N``
directories.

Same layout and rules as ``valley_tpu/utils/checkpoint.py``: auto-resume
from the newest ``checkpoint-N``, ``save_total_limit`` rotation (``keep``),
and a write to ``checkpoint-N.tmp`` renamed into place, so a reader never
sees a partial checkpoint.  The format is the port's own: one
``torch.save`` file per directory (tensors, numbers, strings and dicts of
them, loaded back with ``weights_only=True``), not orbax, so the two
packages do not read each other's checkpoints.  Saves block.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

_FILE = "state.pt"


def checkpoint_dirs(output_dir: str):
    """[(step, path)] of the ``checkpoint-N`` directories, oldest first."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts of tensors and plain values) into the
    directory ``path``, replacing what was there."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_pytree(path: str, map_location=None) -> Any:
    """The tree `save_pytree` wrote into ``path``."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location=map_location, weights_only=True)


def save_checkpoint(output_dir: str, state: Any, step: int,
                    keep: Optional[int] = 1) -> str:
    """Write ``checkpoint-<step>``, then delete all but the newest ``keep``
    checkpoints (None or 0 keeps every one).  Returns its path."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    save_pytree(path, state)
    if keep:
        for _step, old in checkpoint_dirs(output_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def restore_latest(output_dir: str, map_location=None
                   ) -> Optional[Tuple[Any, int]]:
    """(state, step) of the newest checkpoint-N, or None."""
    existing = checkpoint_dirs(output_dir)
    if not existing:
        return None
    step, path = existing[-1]
    return restore_pytree(path, map_location), step
