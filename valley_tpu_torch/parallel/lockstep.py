"""The ranks of a tensor-parallel server in lockstep.

Under torchrun every rank holds its share of the weights and must run the
same device work in the same order, since the collectives of the ``model``
axis pair up by order.  Rank 0 (the lead) serves HTTP, registers with the
controller and decides; the other ranks follow.  Before the lead makes a
call on an engine-side object (the engine, a pool, a `SpecDecoder`, a
session, a prefix cache, a token iterator), it broadcasts the call (the
object's id, the method and the arguments) over a gloo group of its own,
then makes it; each follower makes the same call on its own copy of the
object, in the order the lead sent them.  Calls are sent and made under one
lock (`Lockstep.lock`), which the lead takes innermost, after any lock of
the caller's, so the callers' locks keep their order.

Objects made by such a call (`Lockstep.new`, a method that returns an
iterator or an object whose class sets ``lockstep_object``, as a session
does) get the next id on every rank.  The lead's callers hold them through
a `Proxy`, whose method calls (and attribute sets) go through
`Lockstep.call`; its other attributes read the lead's object.  Arguments
that are callables (streaming callbacks) reach the followers as None: they
run on the lead only.  Objects every rank makes for itself (the tokenizer)
are named to `Lockstep.register` on every rank in the same order.

A call may fail alike on every rank (`alike`): an iterator's end, a
`ValueError` (the engine's checks of a call's arguments, which every rank
holds alike, before any device work) or an exception whose class sets
``lockstep_alike`` (a session's exhausted cache).  Each message carries the
outcome of the lead's previous call (returned, or the exception's type),
and a follower whose own outcome differs stops the world with its
traceback.  Any other failure may have come between two collectives, where
the other ranks now wait for this one, so the rank that meets it stops the
world at once, with its traceback: a follower raises out of `follow`; the
lead, whose calls run on its server's threads, writes the traceback and
ends its process.  torchrun then ends the other ranks (where a rank is
left waiting in a collective, its peer's end fails that collective).  A
rank is never skipped, and a call that failed alike leaves the world
running; a check that refuses alike must therefore come before the call's
first collective.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import traceback
import types
from typing import Any, Dict, List, NamedTuple, Optional

import torch.distributed as dist

logger = logging.getLogger(__name__)

_CURRENT: Optional["Lockstep"] = None


class Ref(NamedTuple):
    """An object by its lockstep id, as a message carries it."""
    id: int


def alike(err: BaseException) -> bool:
    """Whether every rank meets ``err`` alike (module docstring): the rest
    of the world may go on, rather than stop."""
    return isinstance(err, (StopIteration, ValueError)) or \
        getattr(type(err), "lockstep_alike", False)


def _outcome(err: Optional[BaseException]) -> str:
    if err is None:
        return "ok"
    return type(err).__name__


class Lockstep:
    """The lead's broadcast of calls and the followers' loop that makes
    them (module docstring).  Every rank makes one, in the same order
    relative to its other groups (`dist.new_group` is a collective)."""

    def __init__(self):
        global _CURRENT
        self.rank = dist.get_rank()
        self.lead = self.rank == 0
        self.group = dist.new_group(backend="gloo")
        self.lock = threading.RLock()
        self.objects: Dict[int, Any] = {}
        self._ids: Dict[int, int] = {}
        self._next = 0
        self._released: List[int] = []
        self._last = "ok"
        self._last_tb = ""
        self.calls = 0
        _CURRENT = self

    # -- ids --------------------------------------------------------------

    def register(self, obj) -> Ref:
        """Give ``obj`` the next id (every rank calls this in the same
        order for its own copy)."""
        ref = Ref(self._next)
        self._next += 1
        self.objects[ref.id] = obj
        self._ids[id(obj)] = ref.id
        return ref

    def ref(self, obj) -> Ref:
        obj = obj._target if isinstance(obj, Proxy) else obj
        return Ref(self._ids[id(obj)])

    def release(self, ref: Ref) -> None:
        """Drop an object on every rank (sent with the next message; a
        token iterator is closed)."""
        self._released.append(ref.id)

    def _drop(self, ids) -> None:
        for i in ids:
            obj = self.objects.pop(i, None)
            self._ids.pop(id(obj), None)
            if isinstance(obj, types.GeneratorType):
                obj.close()

    # -- messages ---------------------------------------------------------

    def _encode(self, v):
        if isinstance(v, Proxy):
            return self.ref(v)
        if isinstance(v, (list, tuple)):
            return type(v)(self._encode(x) for x in v)
        if isinstance(v, dict):
            return {k: self._encode(x) for k, x in v.items()}
        if id(v) in self._ids and self.objects.get(self._ids[id(v)]) is v:
            return Ref(self._ids[id(v)])
        if callable(v) and not isinstance(v, type):
            return None        # a callback: the lead's alone
        return v

    def _decode(self, v):
        if isinstance(v, Ref):
            return self.objects[v.id]
        if isinstance(v, (list, tuple)):
            return type(v)(self._decode(x) for x in v)
        if isinstance(v, dict):
            return {k: self._decode(x) for k, x in v.items()}
        return v

    def _send(self, msg) -> None:
        released, self._released = self._released, []
        box = [(self._last, released, msg)]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self._drop(released)

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _run(self, fn, *args, **kwargs):
        """Make a call and record its outcome; the result, wrapped where
        it is a new object (`_wrap`)."""
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:
            self._last = _outcome(e)
            self._last_tb = traceback.format_exc()
            raise
        self._last = "ok"
        self.calls += 1
        return result

    def _wrap(self, result, proxy: bool = True):
        if isinstance(result, types.GeneratorType) or (
                proxy and getattr(type(result), "lockstep_object", False)):
            ref = self.register(result)
            return Proxy(self, result, ref) if self.lead else result
        return result

    # -- the lead ---------------------------------------------------------

    def call(self, target, method: str, *args, **kwargs):
        """Make ``target.method(*args, **kwargs)`` on every rank (the
        lead's side)."""
        target = target._target if isinstance(target, Proxy) else target
        with self.lock:
            try:
                self._send(("call", self.ref(target), method,
                            self._encode(args), self._encode(kwargs)))
                result = self._run(getattr(target, method), *_unwrap(args),
                                   **_unwrap(kwargs))
            except BaseException as e:
                if not alike(e):
                    self._stop_world(f"{type(target).__name__}.{method}", e)
                raise
            return self._wrap(result)

    def new(self, cls, *args, proxy: bool = True, **kwargs):
        """``cls(*args, **kwargs)`` on every rank, registered there; the
        lead gets a `Proxy` of its own (the object itself with
        ``proxy=False``: one that sends its own calls, as a pool does)."""
        with self.lock:
            try:
                self._send(("new", cls, None, self._encode(args),
                            self._encode(kwargs)))
                obj = self._run(cls, *_unwrap(args), **_unwrap(kwargs))
            except BaseException as e:
                if not alike(e):
                    self._stop_world(cls.__name__, e)
                raise
            ref = self.register(obj)
            return Proxy(self, obj, ref) if proxy else obj

    def _stop_world(self, what: str, err: BaseException) -> None:
        """The lead's end where a call failed other than alike (module
        docstring): the traceback on stderr, then the process's exit."""
        sys.stderr.write(
            f"rank {self.rank} (the lead): {what} failed at call "
            f"{self.calls}, so the world stops\n"
            + "".join(traceback.format_exception(err)))
        sys.stderr.flush()
        os._exit(1)

    def stop(self) -> None:
        """Let the followers leave `follow`."""
        with self.lock:
            self._send(("stop", None, None, (), {}))

    # -- the followers ----------------------------------------------------

    def follow(self) -> None:
        """Make the lead's calls until it stops; raise, with this rank's
        traceback, where a call's outcome differs from the lead's."""
        while True:
            lead_last, released, (kind, target, method, args, kwargs) = \
                self._recv()
            if lead_last != self._last:
                raise RuntimeError(
                    f"rank {self.rank} diverged from the lead at call "
                    f"{self.calls}: the lead's outcome {lead_last}, this "
                    f"rank's {self._last}\n{self._last_tb}")
            self._drop(released)
            if kind == "stop":
                return
            args, kwargs = self._decode(args), self._decode(kwargs)
            what = getattr(target, "__name__", None) if kind == "new" \
                else f"{type(self.objects[target.id]).__name__}.{method}"
            try:
                if kind == "new":
                    self.register(self._run(target, *args, **kwargs))
                else:
                    self._wrap(self._run(getattr(self.objects[target.id],
                                                 method), *args, **kwargs))
            except BaseException as e:   # noqa: BLE001 -- alike: compared
                if not alike(e):         # at the next message
                    raise RuntimeError(
                        f"rank {self.rank}: {what} failed at call "
                        f"{self.calls}, so the world stops") from e
                if self._last != "StopIteration":
                    logger.info("rank %d: %s refused alike:\n%s", self.rank,
                                what, self._last_tb)


def _unwrap(v):
    if isinstance(v, Proxy):
        return v._target
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    return v


class Proxy:
    """The lead's handle on an object every rank holds: a method call goes
    through `Lockstep.call`; any other attribute is the lead's own."""

    def __init__(self, lockstep: Lockstep, target, ref: Ref):
        object.__setattr__(self, "_lockstep", lockstep)
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_ref", ref)

    def __getattr__(self, name: str):
        value = getattr(self._target, name)
        if isinstance(value, types.MethodType):
            return lambda *a, **k: self._lockstep.call(self._target, name,
                                                       *a, **k)
        return value

    def __setattr__(self, name: str, value) -> None:
        # the followers' copies take the same value
        self._lockstep.call(self._target, "__setattr__", name, value)

    def __iter__(self):
        return self

    def __next__(self):
        return self._lockstep.call(self._target, "__next__")

    def close(self) -> None:
        self._lockstep.call(self._target, "close")

    def __del__(self):
        try:
            self._lockstep.release(self._ref)
        except Exception:   # noqa: BLE001 -- interpreter teardown
            pass


def current() -> Optional[Lockstep]:
    """The process's `Lockstep`, where one was made."""
    return _CURRENT


def make(cls, *args, proxy: bool = True, **kwargs):
    """``cls(*args, **kwargs)``: on every rank through the lockstep where
    there is one (`Lockstep.new`), else here alone."""
    if _CURRENT is None:
        return cls(*_unwrap(args), **_unwrap(kwargs))
    return _CURRENT.new(cls, *args, proxy=proxy, **kwargs)
