"""Checkpoints of the PyTorch port, in HF-Trainer-style ``checkpoint-N``
directories.

Same layout and rules as ``valley_tpu/utils/checkpoint.py``: auto-resume
from the newest ``checkpoint-N``, ``save_total_limit`` rotation (``keep``),
and a write to ``checkpoint-N.tmp`` renamed into place, so a reader never
sees a partial checkpoint.  The format is the port's own: one
``torch.save`` file per directory (tensors, numbers, strings and dicts of
them, loaded back with ``weights_only=True``), not orbax, so the two
packages do not read each other's checkpoints.

A save with ``block=False`` (the trainer's ``async_checkpointing``)
copies the state to the host before it returns, so what is saved is the
state of that moment however training goes on, and writes the file on a
thread of its own.  As JAX defers orbax's commit, the directory is
renamed into place (and older ones rotated out) only by
`finalize_pending`, which the next save, `restore_latest` and the end of
training call after the write is done.  An exception of the write is
raised there, never dropped.

On a mesh the trainer gathers the full tree and rank 0 writes it, in this
same format, so a ``checkpoint-N`` written at one world resumes at any
other (each rank maps the file and takes its slices): the port's
counterpart of orbax restoring onto another mesh.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

_FILE = "state.pt"

# asynchronous saves not yet committed: (thread, [its exception], tmp,
# final path, output_dir, keep)
_pending: list = []


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


def _write(tmp: str, tree: Any) -> None:
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _FILE))


def _replace(tmp: str, path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts of tensors and plain values) into the
    directory ``path``, replacing what was there."""
    path = os.path.abspath(path)
    _write(path + ".tmp", tree)
    _replace(path + ".tmp", path)


def restore_pytree(path: str, map_location=None, mmap: bool = False) -> Any:
    """The tree `save_pytree` wrote into ``path``; ``mmap`` maps the file
    instead of reading it (each rank of a mesh then reads only the slices
    it takes)."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location=map_location, weights_only=True, mmap=mmap)


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are host copies of its tensors
    (copies also of host tensors, so that later in-place updates of the
    originals do not reach it)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _commit(tmp: str, path: str, output_dir: str,
            keep: Optional[int]) -> str:
    _replace(tmp, path)
    if keep:
        for _step, old in checkpoint_dirs(output_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def finalize_pending() -> None:
    """Wait for every asynchronous save and commit it, oldest first; the
    exception of a write that failed is raised (its directory stays
    ``.tmp``)."""
    while _pending:
        thread, error, tmp, path, output_dir, keep = _pending.pop(0)
        thread.join()
        if error:
            raise RuntimeError(
                f"the asynchronous save of {path} failed") from error[0]
        _commit(tmp, path, output_dir, keep)


def save_checkpoint(output_dir: str, state: Any, step: int,
                    keep: Optional[int] = 1, block: bool = True) -> str:
    """Write ``checkpoint-<step>``, then delete all but the newest ``keep``
    checkpoints (None or 0 keeps every one).  Returns its path.  With
    ``block=False`` the state is copied to the host here and written on a
    thread; the path exists once `finalize_pending` has committed it."""
    finalize_pending()
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    tmp = path + ".tmp"
    if block:
        _write(tmp, state)
        return _commit(tmp, path, output_dir, keep)
    snapshot = to_host(state)
    error: list = []

    def write():
        try:
            _write(tmp, snapshot)
        except Exception as e:   # raised again by finalize_pending
            error.append(e)

    thread = threading.Thread(target=write, name=f"save-{step}")
    thread.start()
    _pending.append((thread, error, tmp, path, output_dir, keep))
    return path


def restore_latest(output_dir: str, map_location=None, mmap: bool = False
                   ) -> Optional[Tuple[Any, int]]:
    """(state, step) of the newest checkpoint-N, or None; saves still in
    flight are committed first."""
    finalize_pending()
    existing = checkpoint_dirs(output_dir)
    if not existing:
        return None
    step, path = existing[-1]
    return restore_pytree(path, map_location, mmap), step
