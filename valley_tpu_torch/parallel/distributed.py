"""Process-group bring-up of the PyTorch port, the counterpart of
``valley_tpu/parallel/distributed.py``.

The reference launches one process per GPU with torchrun and an NCCL
rendezvous (`valley/train/train.sh:1`); so does the port:

    torchrun --nproc_per_node N -m valley_tpu_torch.train.train --conf X.yaml

Each process drives ``cuda:LOCAL_RANK``.  `initialize` reads torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) when it is given no arguments, and brings up the default
process group: NCCL for CUDA devices, gloo for the CPU.  It never falls back
from one backend to the other.  Without torchrun's environment and without
arguments there is no process group, and the port runs as one process, as it
always did: `process_index` is 0 and `process_count` 1.

JAX's ``multislice_mesh`` (slices of TPU pods joined over the data-center
network) has no counterpart on GPUs: a torchrun world is one flat set of
ranks, and `mesh.create_mesh` lays the ``data`` axis outermost over it.

A CUDA graph that captured an NCCL collective holds NCCL's communicator:
``destroy_process_group`` waits on it for as long as the graph lives (a
world of two cards that kept one captured all-reduce hung there, one that
freed its graph first left in half a second:
``valley_tpu_torch/tools/teardown_probe.py``).  So every graph captured
while a process group is up is registered here (`hold_graph`), and
`shutdown` releases the live ones before it takes the group down.
"""

from __future__ import annotations

import logging
import os
import weakref
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; 0
    without it)."""
    return _env_int("LOCAL_RANK") or 0


def device_for(device="cuda") -> torch.device:
    """The device this process drives: ``cuda:LOCAL_RANK`` for a bare
    ``"cuda"``, the device as given otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None) -> bool:
    """Bring up the default process group (idempotent); returns whether
    one is up.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a
    ``file://`` path (a file store, for processes of one host); with no
    arguments torchrun's environment gives the rendezvous, the world and
    the rank, and without that environment no group is made.  ``device``
    is the device the process trains on (``cuda`` means
    ``cuda:LOCAL_RANK``, which becomes the current device); the backend is
    NCCL for CUDA and gloo for the CPU unless ``backend`` names one."""
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs the world size and this "
                         "process's rank (torchrun's WORLD_SIZE and RANK)")
    device = device_for(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {process_id}: no CUDA device; pass "
                               "--device cpu to train on the CPU")
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif coordinator_address.startswith(("file://", "tcp://")):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    logger.info("process group up: rank %d of %d, backend %s, device %s",
                process_id, num_processes, backend, device)
    return True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


# the CUDA graphs captured while a process group was up (`hold_graph`)
_GRAPHS: "weakref.WeakSet" = weakref.WeakSet()


def hold_graph(graph) -> None:
    """Register a CUDA graph captured while a process group is up: it may
    hold the group's communicator, which `shutdown` must have it let go
    of first."""
    if dist.is_initialized():
        _GRAPHS.add(graph)


def shutdown() -> None:
    """Take the default process group down, if there is one: after the
    device's queue drains, every live graph of `hold_graph` is released
    (``reset``: it cannot be replayed after), then the group is
    destroyed."""
    if not dist.is_initialized():
        return
    graphs = list(_GRAPHS)
    if graphs:
        torch.cuda.synchronize()
        for graph in graphs:
            graph.reset()
        _GRAPHS.clear()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
