"""Serving-wide device-memory budget: one accountant for everything a worker
keeps resident on the card; the port's counterpart of
``valley_tpu/serve/hbm.py`` (which imports jax), sized by ``torch.cuda``.

- FIXED allocations (the weights, the continuous-batching pool with its
  parked-ready worst case, the decode graphs' static states and memory
  pools, the int4 prefill's dequantization buffer) are registered at
  startup and an over-budget configuration raises there, not mid-traffic;
- DYNAMIC allocations (session caches, prefix-cache fragments) reserve
  before allocating; when the budget is short the worker evicts across
  caches (prefix fragments first, then idle sessions) and, failing that,
  degrades: the prefix cache is skipped and new sessions are refused.

Byte accounting follows the shapes the allocators use (`llama.init_cache`:
K and V planes, and for an int8 cache two bf16 scale planes).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

GiB = 1 << 30

# bytes a packed int4 weight's (F, K) dequantization holds at its peak in
# `ops.quant.dequantize`: the values in fp32, their scaled product in
# fp32 and its cast to bf16
INT4_DEQUANT_BYTES = 4 + 4 + 2


class BudgetExceeded(RuntimeError):
    """A FIXED registration does not fit the budget: raised at startup so
    the configuration is rejected before serving traffic."""


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (tensors, modules, mappings,
    sequences and dataclasses of them), each storage view counted once."""
    seen = set()

    def walk(x) -> int:
        if x is None:
            return 0
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel(), x.dtype)
            if key in seen:
                return 0
            seen.add(key)
            return x.numel() * x.element_size()
        if isinstance(x, nn.Module):
            return sum(walk(t) for t in x.parameters()) + \
                sum(walk(t) for t in x.buffers())
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return sum(walk(getattr(x, f.name))
                       for f in dataclasses.fields(x))
        return 0

    return walk(tree)


def kv_slot_bytes(text_cfg, cache_dtype) -> int:
    """Bytes one (row, slot) occupies in a KV cache: K and V over all
    layers, plus the two bf16 scale planes of an int8 cache."""
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    per = 2 * text_cfg.kv_heads * text_cfg.head_dim * itemsize
    if cache_dtype == torch.int8:
        per += 2 * text_cfg.kv_heads * 2
    return per * text_cfg.num_hidden_layers


def session_cache_bytes(engine, extra_slots: Optional[int],
                        decode_slack: int, bucket: Optional[int] = None
                        ) -> int:
    """Worst-case bytes of one `ChatSession`'s cache: bucket + max_new +
    extra + slack slots, the largest bucket where the first chunk is not
    known."""
    eng = engine
    extra = extra_slots if extra_slots is not None \
        else 4 * (eng.max_new_tokens + 64)
    b = bucket if bucket is not None else eng.buckets[-1]
    cache_len = b + eng.max_new_tokens + extra + decode_slack
    return cache_len * kv_slot_bytes(eng.cfg.text, eng.cache_dtype)


def prefix_fragment_bytes(engine, prefix_len: int) -> int:
    """Bytes of one `PrefixCache` entry (its bucket-slot fragment)."""
    bucket = engine.pick_bucket(prefix_len)
    return bucket * kv_slot_bytes(engine.cfg.text, engine.cache_dtype)


def int4_dequant_bytes(params) -> int:
    """Bytes of the largest transient of the int4 prefill: it dequantizes
    one packed (F, K/2) projection (or ``lm_head``) at a time for a matrix
    product (`llama._linear`); 0 for a tree with no packed weights."""
    sizes = [2 * t.numel() // max(t.shape[0], 1) if t.dim() == 3
             else 2 * t.numel()
             for t in params.parameters() if t.dtype == torch.uint8]
    return max(sizes, default=0) * INT4_DEQUANT_BYTES


def device_hbm_bytes() -> Optional[int]:
    """The card's memory, or None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info()[1]


class HbmBudget:
    """Thread-safe byte ledger.  ``register_fixed`` is for startup-time
    allocations and raises when over budget; ``reserve``/``release`` are
    for dynamic entries and never raise: a failed reserve returns False and
    the caller degrades."""

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self._lock = threading.Lock()
        self._fixed: Dict[str, int] = {}
        self._dyn: Dict[str, Tuple[str, int]] = {}   # key -> (kind, bytes)

    def used(self) -> int:
        with self._lock:
            return self._used_locked()

    def free(self) -> int:
        with self._lock:
            return self.total - self._used_locked()

    def _used_locked(self) -> int:
        return (sum(self._fixed.values())
                + sum(b for _, b in self._dyn.values()))

    def snapshot(self) -> dict:
        """Status payload: budget, used, free and bytes per kind."""
        with self._lock:
            by: Dict[str, int] = dict(self._fixed)
            for kind, b in self._dyn.values():
                by[kind] = by.get(kind, 0) + b
            used = self._used_locked()
        return {"budget_bytes": self.total, "used_bytes": used,
                "free_bytes": self.total - used,
                "by": {k: v for k, v in sorted(by.items())}}

    def register_fixed(self, name: str, nbytes: int) -> None:
        """Register (or replace) a fixed allocation; raises
        `BudgetExceeded` when the fixed and dynamic entries pass the
        budget."""
        with self._lock:
            self._fixed[name] = int(nbytes)
            used = self._used_locked()
            if used > self.total:
                detail = ", ".join(f"{k}={v / GiB:.2f}GiB"
                                   for k, v in self._fixed.items())
                raise BudgetExceeded(
                    f"fixed device allocations ({detail}) total "
                    f"{used / GiB:.2f} GiB > budget "
                    f"{self.total / GiB:.2f} GiB: reduce --max-batch / "
                    f"--max-new-tokens, or raise --hbm-budget")

    def drop_fixed(self, name: str) -> int:
        """Remove a fixed entry (an estimate replaced by a measurement);
        returns its bytes."""
        with self._lock:
            return self._fixed.pop(name, 0)

    def reserve(self, key: str, kind: str, nbytes: int,
                make_room: Optional[Callable[[int], int]] = None) -> bool:
        """Reserve ``nbytes`` under ``key``.  When short, ``make_room``
        (called without the ledger lock: it may evict caches that release
        entries here) is asked for the deficit; one retry after each
        productive eviction round."""
        nbytes = int(nbytes)
        for _ in range(64):   # each round must free something
            with self._lock:
                free = self.total - self._used_locked()
                if key in self._dyn:
                    free += self._dyn[key][1]   # re-reserve replaces
                if nbytes <= free:
                    self._dyn[key] = (kind, nbytes)
                    return True
                deficit = nbytes - free
            if make_room is None or make_room(deficit) <= 0:
                return False
        return False

    def update(self, key: str, nbytes: int) -> None:
        """Correct an estimate to the bytes allocated (a no-op for a key
        released meanwhile)."""
        with self._lock:
            if key in self._dyn:
                self._dyn[key] = (self._dyn[key][0], int(nbytes))

    def release(self, key: str) -> int:
        with self._lock:
            _, b = self._dyn.pop(key, (None, 0))
            return b
