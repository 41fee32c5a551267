"""Tensor parallelism (the mesh's ``model`` axis) of the PyTorch port: the
collectives on the ``model`` group, for serving and for training.

The JAX package writes tensor parallelism as rules (``sharding.py:18-124``:
q/k/v/gate/up split on their out axis, o/down on their in axis, the
vocabulary of ``embed`` and ``lm_head`` on ``model``, the tower alike and
the projector by its outputs) and XLA inserts the
collectives, and differentiates through them.  The port cuts the weights by
the same rules (`sharding.shard_params`) and writes the collectives
Megatron-style:

* a row-parallel product (``wo``, ``w_down``) gives each rank a partial sum
  over its slice of the inputs; `TensorParallel.sum` adds them up over the
  group (Megatron's g: an all-reduce forward, the identity backward, since
  every rank's output gradient is the same);
* a column-parallel product (q/k/v/gate/up, fused or not, and ``lm_head``)
  reads the whole input on every rank and gives its share of the outputs;
  its input first passes `TensorParallel.enter` (Megatron's f: the
  identity forward, and backward the all-reduce of the input's gradient,
  each rank's being the part its own outputs give);
* the vocabulary-parallel embedding looks each id up in this rank's rows
  of the table (zero where another rank holds it) and sums over the group
  (`TensorParallel.embed`): exactly one rank adds a nonzero row, so the sum
  is the one-device lookup bit for bit; backward, each rank's gradient
  lands in its own rows only;
* the vocabulary-parallel ``lm_head`` gives each rank its columns of the
  logits; for serving `Group.gather_columns` joins them in rank order, so
  every rank holds the same logits (samples the same token from the same
  generator seed); the training loss never joins them: the cross entropy
  over the vocabulary shares (`TensorParallel.cross_entropy`) takes each
  row's max, sum of exps and target logit over the group, as XLA
  partitions JAX's log-softmax over the shards of ``lm_head``;
* the CLIP tower is cut the same way (``sharding.py:78-106``: q/k/v/fc1
  column-parallel, o/fc2 row-parallel, each rank its heads and MLP
  columns, `TowerParallel`) and the projector by its outputs (``:123``):
  each rank projects the whole features onto its columns and
  `Group.gather_columns` joins them; backward, each rank takes its own
  columns of the features' gradient, which every rank holds alike (the
  spliced features enter the replicated residual stream).

Without a gradient to carry (serving, under ``inference_mode``) each of
these is the plain collective on the tensor itself: no autograd node, no
copy.

Attention runs on each rank's heads, and each rank computes and caches
only the kv heads its query heads read: its share of them where ``model``
divides them; else, where a rank's query heads lie in one group of heads
that share a kv head, that one kv head (the ranks of the group each hold
it; JAX's ``kv_cache_sharding`` drops the axis and every device holds all
of them).  Either way attention is the one-device grouped-query attention
on the rank's heads.  Query heads of a rank that straddle two groups are
refused; so is training where ``model`` does not divide the kv heads (a
kv head held by several ranks would take a partial gradient on each).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def _grad_flows(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the input's gradient
    summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Sum(torch.autograd.Function):
    """Megatron's g: the sum over the group forward (into a new tensor: a
    remat policy may keep the partial sum it was given); the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' column blocks joined forward in rank order; backward,
    this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp._join_columns(x)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad.narrow(-1, ctx.tp.rank * w, w).contiguous(), None


class _VocabCrossEntropy(torch.autograd.Function):
    """Each row's cross entropy over the vocabulary from this rank's
    columns of the logits (T, V/N) and the targets (T,): the row max
    (all-reduced with MAX, not differentiated), the sum of exps
    (all-reduced), the target's logit from the rank that holds it (a sum
    over the group, every other rank adding 0); the nll is log(sum) minus
    the target's shifted logit, `torch.log_softmax`'s formula.  Backward:
    the rank's softmax columns minus its one-hot columns, times the rows'
    gradient (computed in the saved softmax's memory: one backward)."""

    @staticmethod
    def forward(ctx, logits, targets, tp):
        m = tp.all_reduce_max(logits.detach().amax(dim=-1))
        e = torch.exp(logits - m[:, None])
        total = tp.all_reduce(e.sum(dim=-1))
        local = targets - tp.vocab_start
        mine = (local >= 0) & (local < tp.vocab)
        local = torch.where(mine, local, 0)
        picked = logits.gather(-1, local[:, None])[:, 0] - m
        picked = tp.all_reduce(torch.where(mine, picked, 0.0))
        e.div_(total[:, None])
        ctx.save_for_backward(e, local, mine)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, grad):
        soft, local, mine = ctx.saved_tensors
        soft.scatter_add_(-1, local[:, None], -mine.to(soft.dtype)[:, None])
        return soft.mul_(grad[:, None]), None, None


@dataclass(frozen=True)
class Group:
    """One rank's place on the ``model`` axis (``size`` ranks of
    ``group``) and the collectives over it."""
    group: object
    size: int
    rank: int

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of a row-parallel product's partial sums
        (in place, no autograd)."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the group (in place)."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """g: the sum over the group of a row-parallel product's partial
        sums, with the identity backward where a gradient flows through
        ``x``; else `all_reduce` in place."""
        if _grad_flows(x):
            return _Sum.apply(x, self.group)
        return self.all_reduce(x)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f: the input of column-parallel products, whose gradient is
        summed over the group in the backward (``x`` itself where no
        gradient flows)."""
        return _Enter.apply(x, self.group) if _grad_flows(x) else x

    def _join_columns(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        # the ranks' blocks joined along the leading axis, as their stack
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        out = out.view((self.size,) + tuple(x.shape))
        return out.movedim(0, -2).reshape(tuple(x.shape[:-1])
                                          + (self.size * x.shape[-1],))

    def gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        """(..., W/N) column blocks of every rank joined along the last
        axis in rank order: (..., W), the same on every rank (the
        vocabulary of the logits, the projector's outputs); backward, this
        rank's columns of the gradient, which every rank holds alike."""
        if _grad_flows(x):
            return _GatherColumns.apply(x, self)
        return self._join_columns(x)


@dataclass(frozen=True)
class TensorParallel(Group):
    """One rank's share of the decoder: ``heads`` query heads from
    ``head_start``, the ``kv_heads`` kv heads from ``kv_start`` that they
    read (module docstring), ``ffn`` MLP columns, ``vocab`` rows of the
    vocabulary from ``vocab_start``."""
    heads: int
    head_start: int
    kv_heads: int
    kv_start: int
    ffn: int
    vocab: int
    vocab_start: int

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel lookup of ``ids`` in this rank's rows
        ``table`` (vocab/N, H) of the embedding: a masked local lookup,
        then the sum over the group (whose backward leaves each rank's
        gradient in its own rows)."""
        local = ids - self.vocab_start
        mine = (local >= 0) & (local < self.vocab)
        out = table[torch.where(mine, local, 0)]
        out = torch.where(mine[..., None], out, 0).to(table.dtype)
        return self.sum(out.contiguous())

    def cross_entropy(self, logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """(T,) fp32 negative log-likelihoods of the targets (T,) (ids in
        [0, vocab), an ignored row any id: the caller masks it) from this
        rank's (T, vocab/N) fp32 logits: the cross entropy over the
        vocabulary shares, no rank holding a row's whole logits."""
        return _VocabCrossEntropy.apply(logits, targets, self)

    def in_span(self, width: int) -> tuple:
        """(start, full width) of this rank's ``width`` inputs of a
        row-parallel product within the one-device inputs: its heads of
        ``wo``, its MLP columns of ``w_down``, each an equal block in rank
        order."""
        return self.rank * width, self.size * width


@dataclass(frozen=True)
class TowerParallel(Group):
    """One rank's share of the CLIP tower and the projector: ``heads``
    attention heads and ``ffn`` MLP columns of every tower layer (equal
    blocks in rank order: q/k/v/fc1 cut on their outputs, o/fc2 on their
    inputs), and ``hidden`` output columns of the projector."""
    heads: int
    ffn: int
    hidden: int


def tensor_parallel(params):
    """The share of a tree cut over a ``model`` axis above 1, else None: a
    decoder's (`LlamaWeights`) `TensorParallel`, a tower's or projector's
    `TowerParallel`."""
    return getattr(params, "tp", None)


def plan(cfg, size: int, rank: int, group,
         training: bool = False) -> TensorParallel:
    """This rank's share of a `TextConfig` on a ``model`` axis of
    ``size``; refused, with the reason, where the query heads, the MLP
    width or the vocabulary does not divide by ``size`` (JAX's
    ``device_put`` refuses an uneven vocabulary the same way), where a
    rank's query heads would read parts of two kv heads' groups, or, for
    ``training``, where the kv heads do not divide by ``size``."""
    heads, kv = cfg.num_attention_heads, cfg.kv_heads
    for what, n in (("attention heads", heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % size:
            raise ValueError(f"tensor parallelism over {size} ranks: "
                             f"{what} {n} does not divide by {size}")
    hl = heads // size
    start = rank * hl
    n_rep = heads // kv       # query heads per kv head
    if kv % size == 0:
        kv_local = kv // size
    elif training:
        raise ValueError(
            f"training over a model axis of {size}: {kv} kv heads do not "
            f"divide by {size}, and a kv head that several ranks hold "
            "would take a partial gradient on each; train with a "
            "mesh_model that divides the kv heads")
    elif n_rep % hl == 0:
        kv_local = 1          # the rank's heads lie in one group
    else:
        raise ValueError(
            f"tensor parallelism over {size} ranks: {kv} kv heads do not "
            f"divide by {size}, and a rank's {hl} query heads would read "
            f"parts of two groups of {n_rep}; serve with a "
            "--tensor-parallel that divides the kv heads")
    vl = cfg.vocab_size // size
    return TensorParallel(group, size, rank, hl, start, kv_local,
                          start // n_rep, cfg.intermediate_size // size, vl,
                          rank * vl)


def plan_tower(vision, text_hidden: int, size: int, rank: int,
               group) -> TowerParallel:
    """This rank's share of a `VisionConfig` tower and of the projector
    into ``text_hidden`` on a ``model`` axis of ``size``; refused, with
    the reason, where the tower's heads, its MLP width or the projector's
    outputs do not divide by ``size``."""
    for what, n in (("vision attention heads", vision.num_attention_heads),
                    ("vision intermediate_size", vision.intermediate_size),
                    ("the projector's outputs (hidden_size)", text_hidden)):
        if n % size:
            raise ValueError(f"tensor parallelism over {size} ranks: "
                             f"{what} {n} does not divide by {size}")
    return TowerParallel(group, size, rank,
                         vision.num_attention_heads // size,
                         vision.intermediate_size // size,
                         text_hidden // size)
