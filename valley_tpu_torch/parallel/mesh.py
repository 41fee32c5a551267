"""The device mesh of the PyTorch port, the counterpart of
``valley_tpu/parallel/mesh.py``.

The reference distributes with torchrun DDP and DeepSpeed ZeRO
(`valley/train/train.sh:1`, `valley/configs/deepspeed/*`); the JAX package
writes the whole topology as one mesh with three axes, and so does the
port, as a `torch.distributed.device_mesh.DeviceMesh` over the process
group's ranks (one rank a device):

* ``data``  — pure data parallelism (laid out outermost);
* ``fsdp``  — parameter, gradient and optimizer-state sharding (ZeRO-3:
  `sharding.py` gathers a layer's slices where the model reads it and
  reduce-scatters its gradient);
* ``model`` — tensor parallelism (`tensor.py`): the serving engine and
  the trainer cut the decoder's weights Megatron-style over it
  (`sharding.shard_params`), the trainer each rank's share again over
  ``fsdp``; the ranks of one ``model`` group read the same rows of each
  batch.

`mesh_sizes` is the size arithmetic alone (``-1`` infers an axis from the
device count, with the JAX package's errors), so it runs without a process
group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "model")


def mesh_sizes(data: int = -1, fsdp: int = 1, model: int = 1,
               devices: int = 1) -> tuple:
    """The (data, fsdp, model) sizes ``create_mesh`` of the JAX package
    gives over ``devices`` devices: at most one axis -1, inferred from the
    count; explicit sizes may use fewer devices than there are, never
    more."""
    sizes = [data, fsdp, model]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if devices % known:
            raise ValueError(f"{devices} devices not divisible by {known}")
        sizes[sizes.index(-1)] = devices // known
    want = math.prod(sizes)
    if want > devices:
        raise ValueError(f"mesh {sizes} needs {want} devices, have "
                         f"{devices}")
    return tuple(sizes)


def create_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
                device_type: str = "cuda"):
    """A (data, fsdp, model) `DeviceMesh` over every rank of the default
    process group (`distributed.initialize` first), rank r at position
    ``divmod`` of r, ``data`` outermost, ``model`` innermost.  Refused: a
    mesh that leaves ranks out (each process is one device and must hold
    a slice)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize() "
                           "first (or launch under torchrun)")
    world = dist.get_world_size()
    sizes = mesh_sizes(data, fsdp, model, world)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {list(sizes)} uses {math.prod(sizes)} of "
                         f"the {world} processes; every process must be "
                         "on the mesh")
    return DeviceMesh(device_type, torch.arange(world).reshape(sizes),
                      mesh_dim_names=AXES)


def serving_mesh(tensor_parallel: int, device, entry: str):
    """The (1, 1, N) mesh of ``--tensor-parallel N`` (JAX's worker and
    batch_infer build the same, model_worker.py:1000-1009), over the
    process group torchrun's environment describes (`distributed.
    initialize`: NCCL on the card, gloo on the CPU); None for N = 1.  An N
    that is not the torchrun world is refused, with the command line that
    runs it."""
    from valley_tpu_torch.parallel import distributed

    n = int(tensor_parallel or 1)
    if n <= 1:
        return None
    device = torch.device(device or "cuda")
    distributed.initialize(device=device)
    world = distributed.process_count()
    if world != n:
        raise ValueError(
            f"--tensor-parallel {n} runs one process a rank, and this "
            f"process is one of {world}: launch it as `torchrun "
            f"--nproc_per_node {n} -m {entry} --tensor-parallel {n} ...`")
    return create_mesh(1, 1, n, device_type=device.type)


def local_mesh(fsdp: Optional[int] = None, model: int = 1,
               device_type: str = "cuda"):
    """Every rank on ``fsdp`` (ZeRO-3) beside ``model``, as the JAX
    ``local_mesh``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if fsdp is None:
        fsdp = world // model
    return create_mesh(data=world // (fsdp * model), fsdp=fsdp, model=model,
                       device_type=device_type)
