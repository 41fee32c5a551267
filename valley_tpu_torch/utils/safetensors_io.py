"""Read and write Hugging Face checkpoint files without the ``safetensors``
package: the port's own reader of the safetensors format and of
``pytorch_model*.bin`` shards, and a writer of (sharded) safetensors.

The format: an 8-byte little-endian header length N, then N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` and an
optional ``"__metadata__"``), then the raw little-endian data, each
tensor's offsets relative to the end of the header.  The reader maps each
file copy-on-write (`mmap.ACCESS_COPY`) and hands out CPU tensors over the
mapping (`torch.frombuffer`), so a 14 GB checkpoint is paged in tensor by
tensor as the loader moves it to the card, never read whole into RAM.

A sharded directory names its files in ``model.safetensors.index.json``
(``{"metadata": {"total_size"}, "weight_map": {name: file}}``); without an
index every ``*.safetensors`` file of the directory is read, and without
those the ``pytorch_model*.bin`` shards (``torch.load(weights_only=True)``,
as the JAX package's ``hf_bridge.read_state_dict`` does).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

# safetensors dtype names <-> torch dtypes
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
INDEX = "model.safetensors.index.json"


def read_header(path: str) -> Tuple[dict, int]:
    """(the JSON header, the byte offset where the data starts)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a
    copy-on-write mapping of the file (written to, they change no byte on
    disk)."""
    header, start = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    entries = {k: v for k, v in header.items() if k != "__metadata__"}
    if not entries:
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, e in entries.items():
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {e['dtype']}, not "
                             f"one of {sorted(DTYPES)}")
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, "
                             f"{shape} {e['dtype']} needs {numel * itemsize}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                             offset=start + begin)
        out[name] = t.view(dtype).reshape(shape)
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """All weights of a Hugging Face checkpoint directory (the counterpart
    of ``hf_bridge.py:270``): the files its safetensors index names, else
    every ``*.safetensors`` file, else the ``pytorch_model*.bin`` shards."""
    index = os.path.join(path, INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        st_files = [os.path.join(path, name) for name in files]
    else:
        st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        sd: Dict[str, torch.Tensor] = {}
        for f in st_files:
            sd.update(load_file(f))
        return sd
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no weights found under {path}")
    sd = {}
    for f in bin_files:
        sd.update(torch.load(f, map_location="cpu", weights_only=True,
                             mmap=True))
    return sd


def _header(entries: Iterable[Tuple[str, tuple, torch.dtype]],
            metadata: Optional[Mapping[str, str]]) -> Tuple[bytes, list]:
    """The header bytes (padded with spaces to a multiple of 8) and each
    tensor's byte count, for (name, shape, dtype) entries in write order."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    sizes, offset = [], 0
    for name, shape, dtype in entries:
        numel = 1
        for s in shape:
            numel *= s
        n = numel * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        sizes.append(n)
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return raw, sizes


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> int:
    """Write ``tensors`` (on any device) as one safetensors file, each cast
    to ``dtype`` where given (floating tensors only) and moved to the host
    one at a time.  Returns the bytes written."""
    def cast(t: torch.Tensor) -> torch.dtype:
        return dtype if dtype is not None and t.is_floating_point() \
            else t.dtype

    names = list(tensors)
    raw, sizes = _header(((k, tuple(tensors[k].shape), cast(tensors[k]))
                          for k in names), metadata)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, n in zip(names, sizes):
            t = tensors[name]
            t = t.detach().to(dtype=cast(t)).contiguous().cpu()
            if n:
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + sum(sizes)


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir: str,
                 max_shard_bytes: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> int:
    """Write ``tensors`` into ``out_dir``: one ``model.safetensors``, or,
    when they hold more than ``max_shard_bytes``, shards
    ``model-0000i-of-0000n.safetensors`` of at most that many bytes each
    (a larger tensor takes a shard alone) and ``model.safetensors.index.
    json``.  Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)

    def nbytes(t):
        size = t.element_size() if dtype is None or not t.is_floating_point() \
            else torch.empty((), dtype=dtype).element_size()
        return t.numel() * size

    shards: list = [[]]
    filled = 0
    for name, t in tensors.items():
        n = nbytes(t)
        if max_shard_bytes and shards[-1] and filled + n > max_shard_bytes:
            shards.append([])
            filled = 0
        shards[-1].append(name)
        filled += n
    if len(shards) == 1:
        return save_file(tensors, os.path.join(out_dir, "model.safetensors"),
                         {"format": "pt"}, dtype)
    written = 0
    weight_map = {}
    total = 0
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        n = save_file({k: tensors[k] for k in names},
                      os.path.join(out_dir, fname), {"format": "pt"}, dtype)
        written += n
        total += sum(nbytes(tensors[k]) for k in names)
        weight_map.update({k: fname for k in names})
    with open(os.path.join(out_dir, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return written
