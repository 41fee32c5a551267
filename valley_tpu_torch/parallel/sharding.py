"""Sharding rules and the ZeRO-3 collectives of the PyTorch port, the
counterpart of ``valley_tpu/parallel/sharding.py``, for the ``data``,
``fsdp`` and ``model`` axes.

The JAX package writes ZeRO-3 as rules: one PartitionSpec per weight kind,
the stacked layer weights sharded over ``fsdp``, and XLA inserts the
collectives.  The port keeps the rules (`fsdp_axis`: for every weight kind,
the axis of the port's layout that is split over ``fsdp``, or None for a
replicated leaf) and writes the collectives out:

* `shard_params` cuts a full `ValleyWeights` in place: every parameter
  whose rule names an axis keeps this rank's contiguous slice of it as its
  data, so the gradients, and AdamW's moments, which the optimizer makes
  from the parameters at its first step, are born sharded (JAX's optimizer
  init had to be told where its state goes, or it landed whole on one
  device: ``opt_state_shardings``; here there is nothing to tell).
* The model reads a parameter through `Weights.__getitem__`, which on a
  sharded tree calls the read this module installs: `gather`, an autograd
  function whose forward all-gathers the slices over ``fsdp`` and whose
  backward reduce-scatters the gradient over ``fsdp`` and all-reduces it
  over ``data``.  A stacked layer weight is read one layer at a time
  (`LayerReads`), so a whole layer is live only while it runs; under remat
  the recompute reads, and gathers, it again.
* Replicated trainable leaves (norms, biases) take their gradient's
  all-reduce over the whole batch after the backward
  (`all_reduce_replicated`), and the global norm counts each of them once
  (`sum_squares`).
* On a ``model`` axis above 1 (tensor parallelism, `tensor.py`) the tree
  is first cut Megatron-style (`model_axis`), then each rank's share is
  cut again over ``fsdp``.  The batch world is then data x fsdp, the
  ranks of one ``model`` group reading the same rows (`batch_group`).  A
  leaf cut over ``model`` takes its whole gradient on its rank; a leaf
  whole on every ``model`` rank takes the same gradient on each (the
  norms, the vision side: their input gradient came through
  `TensorParallel.enter`), except the LoRA factors that stay whole
  (`partial_over_model`), whose ranks' gradients are parts of a sum.
* `gather_params` and `gather_state` carry the slices of both axes back to
  a full tree (checkpoints, ``final/``, the steps eval); `load_full_state`
  takes a full state onto the slices of any world.

Every rank of one mesh must read the same parameters in the same order
(the collectives pair up by order), which the shared model code does: the
per-rank batches have one shape (`DataLoader` with ``process_count`` and
the collator's fixed geometry).  Collectives run on the process group's
backend; no library of finished sharding stands in for the rules (the
stacked (L, out, in) layout does not map onto FSDP's module units).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from valley_tpu_torch.models.llama import QUANTIZED
from valley_tpu_torch.parallel.tensor import TensorParallel
from valley_tpu_torch.parallel.tensor import plan as tensor_plan

# The fsdp axis of each decoder layer weight (L, out, in): the in axis of
# q/k/v/gate/up (fused or not), the out axis of o and down, which contract
# over the tensor-parallel axis (sharding.py:18-40)
_LLAMA_LAYER = {"wqkv": 2, "w_gateup": 2, "wq": 2, "wk": 2, "wv": 2,
                "w_gate": 2, "w_up": 2, "wo": 1, "w_down": 1}
# ... and of each tower layer weight (L, in, out) (sharding.py:72-83)
_VISION_LAYER = {"wq": 1, "wk": 1, "wv": 1, "fc1": 1, "wo": 2, "fc2": 2}
_SCALES = ("_scale_a8", "_scale")


# The model axis of each decoder layer weight (L, out, in)
# (sharding.py:18-38): the out axis of the column-parallel q/k/v/gate/up
# (fused or not), the in axis of the row-parallel o and down
_LLAMA_MODEL = {"wqkv": 1, "w_gateup": 1, "wq": 1, "wk": 1, "wv": 1,
                "w_gate": 1, "w_up": 1, "wo": 2, "w_down": 2}
_ROW_PARALLEL = ("wo", "w_down")


def _lora_base(leaf: str) -> Optional[str]:
    """The projection a LoRA factor's name adapts, else None."""
    for suffix in ("_lora_a", "_lora_b"):
        if leaf.endswith(suffix):
            return leaf[:-len(suffix)]
    return None


def model_axis(name: str, tensor: Optional[torch.Tensor]) -> Optional[int]:
    """The axis of parameter ``name`` that the ``model`` axis splits, in
    the port's layout; None for a leaf every rank holds whole.  JAX's
    rules (sharding.py:18-75), translated, with three differences, each
    where the port's arithmetic on a rank differs from XLA's resharding:

    * a row-parallel projection's scales: each rank rescales its partial
      sum before the sum over the group, so a per-channel scale (L, out)
      stays whole and a grouped one (L, out, in/gs) splits with the in
      axis (axis 2), where JAX puts both on their out axis and XLA
      reshards;
    * a row-parallel projection's adapter (``wo``, ``w_down``): each rank
      adds its share of the delta, (x_r @ A_r) @ B, to its partial sum
      before the sum over the group, so A (L, in, r) splits on its in axis
      with the weight's and B (L, r, out) stays whole, where JAX keeps A
      whole and splits B's out axis; a column-parallel adapter's B splits
      on its out axis and A stays whole, as in JAX;
    * the tower, the projector and the temporal module stay whole on
      every rank (ROADMAP.md §3), where JAX splits them too.

    The quantized ``lm_head`` is stored (out, in) here, (in, out) in JAX:
    its vocabulary axis is 0."""
    top, *mid, leaf = name.split(".")
    if top != "llama":
        return None
    if not mid:
        if leaf == "embed":
            return 0              # (V, H)
        if leaf == "lm_head":
            return 0 if tensor.dtype in QUANTIZED else 1
        return 1 if leaf == "lm_head_scale" else None    # (1, V)
    base = _lora_base(leaf)
    if base is not None:
        row = base in _ROW_PARALLEL
        if leaf.endswith("_lora_a"):
            return 1 if row else None      # (L, in, r)
        return None if row else 2          # (L, r, out)
    for suffix in _SCALES:
        base = leaf[:-len(suffix)]
        if leaf.endswith(suffix) and base in _LLAMA_MODEL:
            if base not in _ROW_PARALLEL:
                return 1
            return 2 if tensor.dim() == 3 else None
    return _LLAMA_MODEL.get(leaf)


def partial_over_model(name: str) -> bool:
    """Whether the gradient of parameter ``name``, whole on every rank of
    a ``model`` group, is a part of a sum over the group: a LoRA factor
    that `model_axis` keeps whole (a column-parallel adapter's A, whose
    rank reads only its outputs' part of the delta; a row-parallel one's
    B, whose rank's delta is its inputs' part).  Every other whole leaf
    takes the same gradient on every rank of the group."""
    leaf = name.rsplit(".", 1)[-1]
    return _lora_base(leaf) is not None and model_axis(name, None) is None


def fsdp_axis(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The axis of parameter ``name`` (dotted, as ``named_parameters``
    gives it) that the ``fsdp`` axis splits, in the port's layout; None for
    a replicated leaf.  The JAX package's rules, translated: its one
    layout that differs is the quantized ``lm_head``, which the port stores
    (out, in) where JAX keeps (in, out)."""
    top, *mid, leaf = name.split(".")
    layers = bool(mid)
    if top == "llama":
        if layers:
            if leaf.endswith("_lora_a"):
                return 1          # (L, in, r): the big axis
            return _LLAMA_LAYER.get(leaf)   # norms, scales, lora_b: None
        if leaf == "embed":
            return 1              # (V, H)
        if leaf == "lm_head":
            return 1 if tensor.dtype in QUANTIZED else 0
        return None               # final_norm, lm_head_scale
    if top == "vision":
        if not layers:
            return 1 if leaf in ("patch_embedding",
                                 "position_embedding") else None
        for suffix in _SCALES:
            base = leaf[:-len(suffix)]
            if leaf.endswith(suffix) and base in _VISION_LAYER:
                # (L, 1, out) scales follow their weight's out axis
                return 2 if _VISION_LAYER[base] == 2 else None
        return _VISION_LAYER.get(leaf)
    if top == "projector":
        return 0 if leaf == "w" else None
    if top == "temporal":
        return 0 if leaf == "pooling_w" else None
    return None


@dataclass(frozen=True)
class Sharding:
    """What `shard_params` did to a tree: the mesh, the fsdp axis of every
    sharded parameter by dotted name, and on a ``model`` axis above 1 the
    model axis of every parameter cut over it, the decoder's
    `TextConfig` and this rank's `TensorParallel`."""
    mesh: object
    axes: Mapping[str, int]
    model_axes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    cfg: object = None
    tp: Optional[TensorParallel] = None


def sharding_of(params) -> Optional[Sharding]:
    """The `Sharding` of a tree `shard_params` cut, else None."""
    return getattr(params, "sharding", None)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def fsdp_size(mesh) -> int:
    return _size(mesh, "fsdp")


def data_size(mesh) -> int:
    return _size(mesh, "data")


def batch_rank(mesh) -> int:
    """This rank's block of each global batch: its (data, fsdp) position,
    data outermost; the ranks of one ``model`` group share it."""
    return (mesh.get_local_rank("data") * fsdp_size(mesh)
            + mesh.get_local_rank("fsdp"))


# {id(mesh): (mesh, this rank's batch group)}, made by `batch_group`
_BATCH_GROUPS: Dict[int, tuple] = {}


def batch_group(mesh):
    """The process group of this rank's batch world: the data x fsdp ranks
    at its ``model`` position, which hold the blocks of one global batch.
    None (the default group, every rank) where the model axis is 1.  Made
    at the first call on a mesh, a collective of every rank
    (`shard_params` makes it)."""
    if mesh is None or model_size(mesh) == 1:
        return None
    got = _BATCH_GROUPS.get(id(mesh))
    if got is None or got[0] is not mesh:
        ranks = mesh.mesh.reshape(-1, model_size(mesh))
        group, _ = dist.new_subgroups_by_enumeration(
            [ranks[:, m].tolist() for m in range(model_size(mesh))])
        got = _BATCH_GROUPS[id(mesh)] = (mesh, group)
    return got[1]


def all_gather(shard: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """The full tensor of the fsdp ranks' slices along ``axis`` (no
    autograd), contiguous: the slices gathered as a stack, then joined
    along ``axis`` by one copy of whole runs of the slices' rows (none for
    the leading axis, or for one rank)."""
    x = shard.contiguous()
    n = fsdp_size(mesh)
    # the slices joined along the leading axis are their stack in memory
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.get_group("fsdp"))
    full = list(x.shape)
    full[axis] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, axis).reshape(full)


def reduce_scatter(full: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """This rank's slice along ``axis`` of the sum of ``full`` over the
    fsdp ranks (no autograd), contiguous: ``full`` split along ``axis``
    into a stack of the ranks' slices by one copy (none for the leading
    axis, or for one rank), then reduce-scattered."""
    n = fsdp_size(mesh)
    shape = tuple(full.shape)
    x = full.reshape(shape[:axis] + (n, shape[axis] // n) + shape[axis + 1:])
    x = x.movedim(axis, 0).contiguous()
    out = x.new_empty(tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.view((-1,) + tuple(x.shape[2:])),
                               group=mesh.get_group("fsdp"))
    return out


class _Gather(torch.autograd.Function):
    """Forward: all-gather one parameter's (or one layer's) slices over
    fsdp.  Backward: the full gradient reduce-scattered over fsdp (each
    rank's loss is its share of the global mean, so the sum is the
    gradient of the global loss), then all-reduced over data."""

    @staticmethod
    def forward(ctx, shard, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return all_gather(shard, axis, mesh)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        g = reduce_scatter(grad, ctx.axis, ctx.mesh)
        if data_size(ctx.mesh) > 1:
            dist.all_reduce(g, group=ctx.mesh.get_group("data"))
        return g, None, None


def gather(shard: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """The full tensor of a sharded parameter (or layer), with the
    gradient's reduce-scatter in the backward."""
    return _Gather.apply(shard, axis, mesh)


class LayerReads:
    """A sharded (L, ...) stack (or the L views of its one ``unbind``) read
    one layer at a time: ``[li]`` gathers layer li."""

    def __init__(self, stack, axis: int, mesh):
        self.stack, self.axis, self.mesh = stack, axis, mesh

    def __getitem__(self, li: int) -> torch.Tensor:
        return gather(self.stack[li], self.axis, self.mesh)

    def __len__(self) -> int:
        return len(self.stack)


_STACKS = ("llama.layers", "vision.layers")


def model_size(mesh) -> int:
    return _size(mesh, "model")


def _model_spans(leaf: str, tp: TensorParallel, cfg) -> tuple:
    """(the length of ``leaf``'s model axis in inputs or outputs, this
    rank's [start, stop) spans of it, in order): its own heads, the kv
    heads they read, MLP columns or vocabulary rows.  A fused stack takes its q, k and v heads (its gate and up
    columns) re-fused, not a contiguous slice of the fused axis."""
    d = cfg.head_dim
    q0, q1 = tp.head_start * d, (tp.head_start + tp.heads) * d
    hq, hkv = cfg.num_attention_heads * d, cfg.kv_heads * d
    k0 = tp.kv_start * d
    k1 = k0 + tp.kv_heads * d
    f, f0 = cfg.intermediate_size, tp.rank * tp.ffn
    v0 = tp.vocab_start
    return {
        "wq": (hq, ((q0, q1),)), "wo": (hq, ((q0, q1),)),
        "wk": (hkv, ((k0, k1),)), "wv": (hkv, ((k0, k1),)),
        "wqkv": (hq + 2 * hkv, ((q0, q1), (hq + k0, hq + k1),
                                (hq + hkv + k0, hq + hkv + k1))),
        "w_gate": (f, ((f0, f0 + tp.ffn),)), "w_up": (f, ((f0, f0 + tp.ffn),)),
        "w_down": (f, ((f0, f0 + tp.ffn),)),
        "w_gateup": (2 * f, ((f0, f0 + tp.ffn), (f + f0, f + f0 + tp.ffn))),
        "vocab": (cfg.vocab_size, ((v0, v0 + tp.vocab),)),
    }[leaf]


def _model_base(name: str) -> str:
    """The key of `_model_spans` that parameter ``name`` is cut by: its
    projection's (a scale's or adapter's weight's), or the vocabulary's."""
    top, *mid, leaf = name.split(".")
    if not mid:
        return "vocab"
    for suffix in _SCALES:
        if leaf.endswith(suffix) and leaf[:-len(suffix)] in _LLAMA_MODEL:
            return leaf[:-len(suffix)]
    return _lora_base(leaf) or leaf


def _model_units(name: str, entries: int, axis: int, tp: TensorParallel,
                 cfg) -> list:
    """This rank's [(start, count)] of the ``entries`` entries of
    ``name``'s model ``axis``: the spans of `_model_spans` in units of an
    entry (a packed int4 axis holds two inputs an entry, a grouped scale's
    one group), each of which must start and end on such a unit: a shard
    that would split a byte of nibbles or a scale group is refused, with
    the reason."""
    base = _model_base(name)
    length, spans = _model_spans(base, tp, cfg)
    unit = length // entries
    if unit * entries != length:
        raise ValueError(f"{name}: axis {axis} of {entries} entries is not "
                         f"{length} long in units of whole entries")
    out = []
    for a, b in spans:
        if a % unit or b % unit:
            what = "a byte of nibbles" if base == name.rsplit(".", 1)[-1] \
                else "a scale group"
            raise ValueError(
                f"{name}: tensor parallelism over {tp.size} ranks would cut "
                f"{what} (this rank's inputs [{a}, {b}) of {length}, "
                f"{unit} to an entry); serve with a --tensor-parallel that "
                "splits on whole groups")
        out.append((a // unit, (b - a) // unit))
    return out


def _model_cut(name: str, t: torch.Tensor, axis: int, tp: TensorParallel,
               cfg) -> torch.Tensor:
    """This rank's part of ``t`` along its model ``axis`` (`_model_units`;
    several spans, as a fused stack's q, k and v heads, re-joined)."""
    parts = [t.narrow(axis, a, n)
             for a, n in _model_units(name, t.shape[axis], axis, tp, cfg)]
    return torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]


def _model_join(name: str, parts: List[torch.Tensor], axis: int, cfg
                ) -> torch.Tensor:
    """The full tensor of the ``model`` ranks' parts of ``name`` (rank
    order): each rank's spans put back where `_model_cut` took them."""
    out = None
    for r, part in enumerate(parts):
        tp = tensor_plan(cfg, len(parts), r, None)
        length, spans = _model_spans(_model_base(name), tp, cfg)
        unit = sum(b - a for a, b in spans) // part.shape[axis]
        if out is None:
            shape = list(part.shape)
            shape[axis] = length // unit
            out = part.new_empty(shape)
        at = 0
        for a, n in _model_units(name, length // unit, axis, tp, cfg):
            out.narrow(axis, a, n).copy_(part.narrow(axis, at, n))
            at += n
    return out


def _cut_model_axis(mesh, params, cfg, serving: bool) -> tuple:
    """Cut every decoder leaf with a `model_axis` in place to this rank's
    part; returns (this rank's `TensorParallel`, {name: model axis}).
    LoRA leaves are refused for ``serving`` (merge them first)."""
    tp = tensor_plan(cfg, model_size(mesh), mesh.get_local_rank("model"),
                     mesh.get_group("model"), training=not serving)
    axes = {}
    for prefix, module in params.named_modules():
        if not prefix.startswith("llama"):
            continue
        for name, p in module.named_parameters(recurse=False):
            dotted = f"{prefix}.{name}"
            if serving and (name.endswith(("_lora_a", "_lora_b"))
                            or name == "lora_scale"):
                raise NotImplementedError(
                    f"{dotted}: LoRA adapters are not served tensor-parallel;"
                    " merge them first (--lora-path merges before the cut)")
            axis = model_axis(dotted, p)
            if axis is not None:
                p.data = _model_cut(dotted, p.data, axis, tp, cfg).clone(
                    memory_format=torch.contiguous_format)
                axes[dotted] = axis
    params.llama.tp = tp
    return tp, axes


def shard_params(mesh, params, cfg=None, serving: bool = False):
    """Cut the full tree ``params`` in place to this rank's slices: over
    the mesh's model axis (`model_axis`, a `TextConfig` ``cfg`` needed;
    the decoder then carries its `TensorParallel` as ``params.llama.tp``),
    then over its fsdp axis (`fsdp_axis`), and make its reads gather the
    fsdp slices.  Every parameter keeps its `nn.Parameter` (and so its
    ``requires_grad``); the slices are contiguous.  Returns ``params``.
    An axis that the fsdp size does not divide is refused.  ``serving``:
    no gradient will flow, so a mesh without fsdp slices installs no reads
    (they would copy every weight at every read), and LoRA adapters are
    refused."""
    if sharding_of(params) is not None:
        raise ValueError("these weights are sharded already")
    tp, model_axes = None, {}
    if model_size(mesh) > 1:
        if cfg is None:
            raise ValueError("a model axis above 1 needs the TextConfig")
        tp, model_axes = _cut_model_axis(mesh, params, cfg, serving)
        if not serving:
            batch_group(mesh)
    n, r = fsdp_size(mesh), mesh.get_local_rank("fsdp")
    axes: Dict[str, int] = {}
    for prefix, module in params.named_modules():
        if not hasattr(module, "reads") or (serving and n == 1):
            continue
        reads = {}
        for name, p in module.named_parameters(recurse=False):
            dotted = f"{prefix}.{name}" if prefix else name
            axis = fsdp_axis(dotted, p)
            if axis is None:
                continue
            size = p.shape[axis]
            if size % n:
                raise ValueError(f"{dotted} {tuple(p.shape)}: axis {axis} "
                                 f"of {size} does not divide by fsdp {n}")
            if n > 1:
                p.data = p.data.narrow(axis, r * size // n, size // n).clone(
                    memory_format=torch.contiguous_format)
            axes[dotted] = axis
            reads[name] = (functools.partial(LayerReads, axis=axis - 1,
                                             mesh=mesh)
                           if prefix in _STACKS else
                           functools.partial(gather, axis=axis, mesh=mesh))
        module.reads = reads
    params.sharding = Sharding(mesh, axes, model_axes, cfg, tp)
    return params


def local_slice(full: torch.Tensor, axis: Optional[int], mesh
                ) -> torch.Tensor:
    """This rank's fsdp slice of ``full`` along ``axis`` (all of it for
    None)."""
    if axis is None:
        return full
    n = fsdp_size(mesh)
    size = full.shape[axis] // n
    return full.narrow(axis, mesh.get_local_rank("fsdp") * size, size)


def full_tensor(t: torch.Tensor, axis: Optional[int], mesh,
                device=None) -> torch.Tensor:
    """The tensor of the fsdp ranks' slices ``t`` (a collective; a
    replicated ``t`` as it is): the slice is taken to ``device`` for the
    collective where it lies elsewhere (an offloaded moment)."""
    if axis is None:
        return t
    if device is not None:
        t = t.to(device)
    return all_gather(t.detach(), axis, mesh)


def full_leaf(name: str, t: torch.Tensor, sh: Sharding,
              device=None) -> torch.Tensor:
    """The full tensor of parameter ``name`` (or of its gradient, or of a
    moment) from this rank's part ``t`` (a collective over both axes):
    the fsdp slices gathered, then the ``model`` ranks' parts joined."""
    t = full_tensor(t, sh.axes.get(name), sh.mesh, device)
    axis = sh.model_axes.get(name)
    if axis is None:
        return t
    if device is not None:
        t = t.to(device)
    x = t.detach().contiguous()
    n = model_size(sh.mesh)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=sh.mesh.get_group("model"))
    return _model_join(name, list(out.view((n,) + tuple(x.shape))), axis,
                       sh.cfg)


def local_leaf(name: str, full: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's part of the full tensor of parameter ``name``: its
    ``model`` part, then its fsdp slice of that."""
    axis = sh.model_axes.get(name)
    if axis is not None:
        full = _model_cut(name, full, axis, sh.tp, sh.cfg)
    return local_slice(full, sh.axes.get(name), sh.mesh)


def gather_state(params, to_host: bool = False
                 ) -> Dict[str, Optional[torch.Tensor]]:
    """The full ``state_dict`` of a sharded tree, one parameter at a time
    (a collective: every rank calls it).  ``to_host``: what a checkpoint
    that rank 0 writes needs: each full tensor goes to the host on rank 0
    as soon as it is gathered, and the other ranks keep none of them
    (their values are None)."""
    sh = sharding_of(params)
    keep = not to_host or sh.mesh.get_rank() == 0
    out = {}
    for name, p in params.named_parameters():
        t = full_leaf(name, p.detach(), sh)
        out[name] = None if not keep else \
            t.to("cpu", copy=True) if to_host else t
    return out


def gather_params(params):
    """A full `ValleyWeights` of a sharded tree (a collective), on the
    slices' device; replicated parameters are shared with ``params``."""
    from valley_tpu_torch.weights import from_state_dict

    return from_state_dict(gather_state(params))


def load_full_state(params, state: Mapping[str, torch.Tensor]) -> None:
    """Copy a full ``state_dict`` (of any world) into a sharded tree's
    parts, as ``load_state_dict`` would into a full tree."""
    sh = sharding_of(params)
    names = dict(params.named_parameters())
    if set(names) != set(state):
        raise KeyError(f"state and weights differ: "
                       f"{sorted(set(names) ^ set(state))}")
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(local_leaf(name, state[name], sh))


def process_batch_slice(mesh, global_batch: int) -> slice:
    """The rows of each global batch this rank loads (sharding.py:230-256):
    the batch is split over (data, fsdp), so rank r of the batch order
    (`batch_rank`) holds the r-th contiguous block, which is
    ``DataLoader(process_index=r, process_count=data x fsdp)``'s slice;
    the ranks of one ``model`` group load the same rows."""
    if mesh is None:
        return slice(0, global_batch)
    dp = data_size(mesh) * fsdp_size(mesh)
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{dp} data-parallel ranks")
    per = global_batch // dp
    r = batch_rank(mesh)
    return slice(r * per, (r + 1) * per)


def batch_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over every rank of the batch world (in place):
    ``group``, a `batch_group`, or the whole process group for None."""
    dist.all_reduce(t, group=group)
    return t


def all_reduce_replicated(grads: List[torch.Tensor], sharded: List[bool],
                          mesh=None, partial: Optional[List[bool]] = None
                          ) -> None:
    """Sum, in place over the batch world, the gradients of the
    replicated parameters (the sharded ones were reduced in their
    gather's backward); then over the ``model`` group the gradients that
    are parts of a sum there (``partial``, `partial_over_model`)."""
    group = batch_group(mesh)
    for i, (g, s) in enumerate(zip(grads, sharded)):
        if not s:
            dist.all_reduce(g, group=group)
        if partial is not None and partial[i]:
            dist.all_reduce(g, group=mesh.get_group("model"))


def sum_squares(squares: List[torch.Tensor], sharded: List[bool], mesh,
                model_cut: Optional[List[bool]] = None
                ) -> List[torch.Tensor]:
    """Each gradient's global sum of squares from this rank's: a sharded
    gradient's slices summed over fsdp (its data replicas hold the same
    slice), a replicated one counted once (from fsdp rank 0 only); on a
    ``model`` axis above 1, then a gradient cut over it (``model_cut``)
    summed over the group, a whole one counted once (from model rank 0).
    One collective an axis; the result keeps the list's order, so that the
    norm adds them in the order of one device."""
    v = torch.stack(squares)
    if mesh.get_local_rank("fsdp") != 0:
        keep = torch.tensor(sharded, device=v.device)
        v = torch.where(keep, v, torch.zeros_like(v))
    dist.all_reduce(v, group=mesh.get_group("fsdp"))
    if model_size(mesh) > 1:
        if mesh.get_local_rank("model") != 0:
            keep = torch.tensor(model_cut, device=v.device)
            v = torch.where(keep, v, torch.zeros_like(v))
        dist.all_reduce(v, group=mesh.get_group("model"))
    return list(v.unbind(0))
