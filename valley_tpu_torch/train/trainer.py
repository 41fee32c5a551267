"""Training loop of the PyTorch port, the counterpart of
``valley_tpu/train/trainer.py``, on one device or on a (data, fsdp, model)
mesh.

* Parameter groups: the same labels as the JAX `label_params` ('frozen' |
  'base' | 'lora'), applied as ``requires_grad`` flags, so the backward
  computes gradients of the trainable parameters only (stage 1: projector
  and input embeddings; LoRA: the adapters and the projector) while still
  flowing through every frozen layer.
* The optimizer is optax's chain per label group, written for torch:
  ``clip_by_global_norm`` on each group's own norm (g / norm * max_norm
  when norm >= max_norm, in place), then AdamW (`torch.optim.AdamW`, one
  tensor at a time, moments in the parameters' dtype as optax keeps them
  by default), the learning rate of update n being the group's
  ``schedule(n)`` ('lora' from ``lora_lr`` when it is set).  Frozen
  parameters are not in the optimizer: no update, no weight decay.
* Gradient accumulation as ``optax.MultiSteps``: the running mean of k
  micro-batch gradients, one update every k-th micro-batch; ``step``
  counts updates.  The logged loss and ``grad_norm`` (over every trainable
  gradient, before clipping) are the last micro-batch's.
* LoRA's adapter dropout: micro-batch n's key folds n into ``seed``
  (trainer.py:340-343, where the train state's step counts micro-batches),
  and the forward folds in the layer and the projection
  (`llama.dropout_mask`).  The masks come from torch's generators, not
  JAX's ``dropout_rng_impl``: the name is checked and the bits differ.
  On a mesh whose batch world (data x fsdp) holds more than one block the
  key also folds in the rank's block of the batch, so that ranks draw
  different masks (JAX draws one mask over the global batch; the port's
  ranks cannot share one).  The ranks of one ``model`` group share their
  block's key, so a (1, 1, N) mesh draws one device's masks bit for bit.
* On a mesh (``mesh``: `parallel.mesh.create_mesh`, one process per
  device under torchrun) the parameters are this rank's slices
  (`parallel.sharding.shard_params`: its ``model`` share, Megatron-style,
  cut again over fsdp; ZeRO-3: the gradients and AdamW's moments,
  offloaded or not, are slices too), the batch is this rank's rows of the
  global batch (the ranks of one ``model`` group read the same rows), and
  the loss divides by the global count of supervised tokens.  Each layer
  is gathered where the model reads it and its gradient reduce-scattered
  in the backward; the replicated leaves' gradients are all-reduced over
  the batch world after it, and the LoRA factors whole on every ``model``
  rank over the ``model`` group (`sharding.partial_over_model`); the norms
  that clip and the logged loss and ``grad_norm`` are global.  AdamW is
  elementwise, so each rank's update of its slices is exact.  Only rank 0 writes
  ``trainer.log``, ``metrics.jsonl``, the trace and the checkpoints,
  which hold the full tree (gathered on save), so that a run resumes at
  any world; the steps eval runs on rank 0 over the gathered tree while
  the other ranks wait.
* Optimizer offload (``offload_optimizer``, DeepSpeed's ZeRO-offload in
  the reference, JAX's pinned-host optimizer state): the AdamW moments live
  in pinned host memory, and each update streams them to the device a
  chunk of rows at a time on a side stream (the next chunk's arrive while
  the current one updates, and each goes back as soon as it is updated),
  with the arithmetic of the on-device update, on the device
  (`Trainer._offloaded_step`).  On the CPU the moments are ordinary host
  tensors.
* ``trainer.log`` / ``metrics.jsonl`` lines, with the `StepTimer` summary of
  the micro-batches' wall times (JAX's four keys; each micro-batch ends in
  a synchronise, as JAX's ``block_until_ready``), ``profile_steps``
  ("a:b": a `profiling.trace` of updates a to b into
  ``<output_dir>/trace``), ``checkpoint-N`` saves (blocking, or with
  ``async_checkpointing`` written on a thread and committed by the next
  save; with ``lora_save_strategy: steps``, also adapter-only
  ``adapter-N``), auto-resume through `valley_tpu_torch.utils.checkpoint`,
  and the ``eval_fn`` of ``evaluation_strategy: steps`` every
  ``eval_steps``.

Refused with NotImplementedError (see `check_ported`): wandb.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.optim.adamw import adamw

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.data.dataset import PrefetchLoader
from valley_tpu_torch.models import valley
from valley_tpu_torch.models.llama import fold_in
from valley_tpu_torch.ops.attention import KERNELS, Attention
from valley_tpu_torch.parallel import sharding
from valley_tpu_torch.parallel.distributed import barrier, process_index
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.utils import profiling
from valley_tpu_torch.weights import from_state_dict, set_trainable

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    """The fields of the JAX ``TrainConfig``, with the same defaults."""
    output_dir: str = "./checkpoints"
    learning_rate: float = 2e-5
    lora_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"   # "cosine" | "linear" | "constant"
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    # True/"full": recompute whole layers in the backward; "dots": keep the
    # products' outputs, recompute the rest (`llama._dots_policy`); False:
    # off
    gradient_checkpointing: Any = True
    logging_steps: int = 1
    save_steps: int = 2400
    save_total_limit: int = 1
    # write checkpoints on a thread (the state copied to the host first);
    # the final save blocks
    async_checkpointing: bool = False
    seed: int = 42
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    lora: bool = False
    lora_r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.05
    dropout_rng_impl: str = "rbg"
    lora_save_strategy: str = "no"
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_model: int = 1
    # the AdamW moments in pinned host memory, streamed around each update
    offload_optimizer: bool = False
    report_to: Optional[str] = None
    run_name: str = "valley"
    # "a:b": trace updates a to b into <output_dir>/trace
    profile_steps: Optional[str] = None
    predict_with_generate: bool = False
    prediction_file_name: Optional[str] = None
    generation_max_length: int = 1536
    eval_num: int = 400
    evaluation_strategy: str = "no"
    eval_steps: int = 3000
    export_hf: bool = False


# the JAX package's names for its dropout bit generators (jax.random's
# PRNG implementations); the port draws every mask from torch's
DROPOUT_RNG_IMPLS = ("rbg", "unsafe_rbg", "threefry2x32")


def check_ported(tc: TrainConfig) -> None:
    """Refuse the options this port does not run."""
    if tc.dropout_rng_impl not in DROPOUT_RNG_IMPLS:
        raise ValueError(f"unknown dropout_rng_impl {tc.dropout_rng_impl!r}"
                         f" (one of {', '.join(DROPOUT_RNG_IMPLS)})")
    if tc.report_to == "wandb":
        raise NotImplementedError("report_to: wandb is not ported; the "
                                  "trainer writes trainer.log and "
                                  "metrics.jsonl")
    profile_range(tc.profile_steps)


def profile_range(spec: Optional[str]):
    """(a, b) of ``profile_steps`` "a:b" (trainer.py:443-446), or None."""
    if not spec:
        return None
    try:
        lo, hi = (int(x) for x in spec.split(":"))
    except ValueError:
        raise ValueError(f"profile_steps {spec!r}: want \"start:stop\", "
                         "two update counts") from None
    return lo, hi


# ---------------------------------------------------------------------------
# Parameter groups
# ---------------------------------------------------------------------------

def _label(name: str, tc: TrainConfig) -> str:
    """trainer.py:148-173 on a dotted parameter name."""
    keys = name.split(".")
    top, leaf = keys[0], keys[-1]
    if top == "vision":
        return "frozen"
    if leaf.endswith("_lora_a") or leaf.endswith("_lora_b"):
        return "lora"
    if leaf == "lora_scale":
        return "frozen"
    if top == "projector":
        if tc.freeze_mm_mlp_adapter:
            return "frozen"
        if tc.tune_mm_mlp_adapter or not tc.freeze_backbone:
            return "base"
        return "frozen"
    if top == "temporal":
        return "frozen" if (tc.freeze_backbone or tc.lora) else "base"
    if tc.lora:
        return "frozen"
    if tc.freeze_backbone:
        if leaf == "embed" and tc.tune_mm_mlp_adapter:
            return "base"   # input embeddings train (train.py:168)
        return "frozen"
    return "base"


def label_params(params: valley.ValleyWeights,
                 tc: TrainConfig) -> Dict[str, str]:
    """{dotted parameter name: 'frozen' | 'base' | 'lora'}, the labels of
    the JAX `label_params`: the vision tower always frozen;
    ``freeze_backbone`` freezes the decoder; ``tune_mm_mlp_adapter``
    trains the projector and the input embeddings but not ``lm_head``;
    ``freeze_mm_mlp_adapter`` freezes the projector."""
    return {name: _label(name, tc) for name, _ in params.named_parameters()}


def make_schedule(tc: TrainConfig, total_steps: int
                  ) -> Callable[[int], float]:
    """The learning rate of update n (counting from 0), as optax's
    schedules of trainer.py:178-190 give it: linear warmup over
    ``int(total * warmup_ratio)`` updates, then cosine to 0 (or linear to
    0, or constant)."""
    lr = float(tc.learning_rate)
    warmup = max(int(total_steps * tc.warmup_ratio), 0)

    def linear(init: float, end: float, steps: int, n: int) -> float:
        if steps <= 0:
            return init
        c = min(max(n, 0), steps)
        return (init - end) * (1 - c / steps) + end

    if tc.lr_scheduler_type == "constant":
        return lambda n: lr
    if tc.lr_scheduler_type == "linear":
        return lambda n: (linear(0.0, lr, max(warmup, 1), n) if n < warmup
                          else linear(lr, 0.0, max(total_steps - warmup, 1),
                                      n - warmup))
    decay = max(total_steps, 1) - warmup
    if decay <= 0:
        raise ValueError(f"warmup of {warmup} updates leaves no cosine decay "
                         f"in {total_steps}")

    def cosine(n: int) -> float:
        if n < warmup:
            return linear(0.0, lr, warmup, n)
        c = min(n - warmup, decay)
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay))

    return cosine


def group_schedules(tc: TrainConfig, total_steps: int) -> dict:
    """{group label: its schedule}: the 'lora' group's from ``lora_lr``
    when it is set, else the base one (trainer.py:197-199)."""
    base = make_schedule(tc, total_steps)
    return {"base": base, "lora": base if tc.lora_lr is None
            else make_schedule(dataclasses.replace(
                tc, learning_rate=float(tc.lora_lr)), total_steps)}


def make_optimizer(params: valley.ValleyWeights, tc: TrainConfig,
                   total_steps: int):
    """Label the parameters, let the trainable ones take gradients, and
    build AdamW over them, one parameter group per label.  Returns
    (optimizer, the base group's schedule, labels); `group_schedules`
    gives each group's."""
    check_ported(tc)
    sched = make_schedule(tc, total_steps)
    labels = label_params(params, tc)
    set_trainable(params, [n for n, lab in labels.items()
                           if lab != "frozen"])
    groups = []
    for lab in ("base", "lora"):
        named = [(n, p) for n, p in params.named_parameters()
                 if labels[n] == lab]
        if named:
            groups.append({"label": lab, "names": [n for n, _ in named],
                           "params": [p for _, p in named]})
    if not groups:
        raise ValueError("no trainable parameters under these flags")
    # one tensor at a time: the weights are a few stacks, so the foreach
    # form saves few launches, and its temporaries are the size of the whole
    # group (13.5 GB more for a full stage 2 at 7B)
    opt = torch.optim.AdamW(groups, lr=0.0,
                            betas=(tc.adam_beta1, tc.adam_beta2),
                            eps=tc.adam_eps, weight_decay=tc.weight_decay,
                            foreach=False)
    return opt, sched, labels


# The elements of the largest chunk of AdamW moments that an offloaded update
# streams at once (2^26: 128 MB a bf16 moment; a layer of a 7B stack)
OFFLOAD_CHUNK = 1 << 26


def pinned_zeros(p: torch.Tensor) -> torch.Tensor:
    """Zeros of ``p``'s shape and dtype in host memory, page-locked where
    ``p`` lies on the card (so that copies to and from it run on a side
    stream alongside the card's work); the reason is raised where it cannot
    be had."""
    if p.device.type != "cuda":
        return torch.zeros(p.shape, dtype=p.dtype)
    try:
        return torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
    except RuntimeError as e:
        raise RuntimeError(
            f"offload_optimizer: {p.numel() * p.element_size()} bytes of "
            f"pinned host memory for an AdamW moment could not be had "
            f"({e}); the moments are not kept on the device instead") from e


def global_norm(grads: List[torch.Tensor], sharded: Optional[List[bool]]
                = None, mesh=None, model_cut: Optional[List[bool]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (without an
    fp32 copy of each gradient).  On a ``mesh``, ``grads`` are this rank's,
    ``sharded`` says which are fsdp slices and ``model_cut`` which are
    ``model`` parts: the norm is the global one (`sharding.sum_squares`),
    each gradient's square summed in the same order as on one device."""
    squares = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
               for g in grads]
    if mesh is not None:
        squares = sharding.sum_squares(squares, sharded, mesh, model_cut)
    return torch.sqrt(sum(squares))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Train ``params`` in place on the batches of ``train_loader`` (an
    object with ``epoch(i)`` yielding collated numpy batches, as the port's
    `DataLoader`; on a mesh, this rank's rows of each global batch).  The
    ``attention`` attribute picks the kernels (the default, `KERNELS`) or
    their plain versions (`PLAIN`, to compare a step on the card against);
    it is read at every step.  ``mesh``: a (data, fsdp, model) mesh, over
    which a full ``params`` is sharded here (a tree `shard_params` cut
    already brings its own)."""

    def __init__(self, cfg: ValleyConfig, tc: TrainConfig,
                 params: valley.ValleyWeights, train_loader,
                 total_steps: Optional[int] = None,
                 eval_fn: Optional[Callable] = None, mesh=None):
        # eval_fn(params, step) -> metrics dict, run every eval_steps
        # updates under evaluation_strategy: steps
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.tc = tc
        check_ported(tc)
        if mesh is not None and sharding.sharding_of(params) is None:
            sharding.shard_params(mesh, params, cfg.text)
        sh = sharding.sharding_of(params)
        self.sharding = sh
        self.mesh = None if sh is None else sh.mesh
        self.rank0 = process_index() == 0
        self.params = params
        self.attention: Attention = KERNELS
        self.device = next(params.parameters()).device
        self.total_steps = total_steps or (
            len(train_loader) * tc.num_train_epochs
            // max(tc.gradient_accumulation_steps, 1))
        self.optimizer, self.schedule, self.labels = make_optimizer(
            params, tc, self.total_steps)
        self.schedules = group_schedules(tc, self.total_steps)
        self._trainable = [p for g in self.optimizer.param_groups
                           for p in g["params"]]
        # the trainable parameters' names in optimizer order, which of them
        # are fsdp slices and, on a model axis above 1, which are cut over
        # it and which take parts of a sum there
        self.names = [n for g in self.optimizer.param_groups
                      for n in g["names"]]
        self._sharded = [sh is not None and n in sh.axes for n in self.names]
        self._model_cut = self._partial = None
        if sh is not None and sh.tp is not None:
            self._model_cut = [n in sh.model_axes for n in self.names]
            self._partial = [sharding.partial_over_model(n)
                             for n in self.names]
        self.lora_dropout = tc.lora_dropout if tc.lora else 0.0
        self.offload = tc.offload_optimizer
        self.offload_chunk = OFFLOAD_CHUNK
        self._copy_streams = None
        if self.offload:
            self._init_offloaded_state()
        self.step = 0      # optimizer updates so far
        self._micro = 0    # micro-batches averaged toward the next update
        self._acc: Optional[List[torch.Tensor]] = None
        if not isinstance(train_loader, PrefetchLoader):
            train_loader = PrefetchLoader(train_loader, depth=2,
                                          transform=self.device_batch)
        self.train_loader = train_loader
        os.makedirs(tc.output_dir, exist_ok=True)
        self._log_path = os.path.join(tc.output_dir, "trainer.log")
        self._metrics_path = os.path.join(tc.output_dir, "metrics.jsonl")

    # -- one step ---------------------------------------------------------

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A collated numpy batch as tensors on the trainer's device; the
        images are cast to bf16 on the host first (trainer.py:500-507),
        which halves the bytes copied to the device."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            if k == "images":
                t = t.to(torch.bfloat16)
            out[k] = t.to(self.device)
        return out

    def lora_rng(self) -> Optional[int]:
        """The adapter-dropout key of the next micro-batch: its index
        folded into the seed (None without dropout)."""
        if self.lora_dropout <= 0.0:
            return None
        k = max(self.tc.gradient_accumulation_steps, 1)
        key = fold_in(self.tc.seed, self.step * k + self._micro)
        if self.mesh is not None and sharding.data_size(
                self.mesh) * sharding.fsdp_size(self.mesh) > 1:
            key = fold_in(key, sharding.batch_rank(self.mesh))
        return key

    def loss_and_grads(self, batch):
        """(loss, global grad norm, [gradient of each trainable parameter,
        in optimizer order]) of one batch, without updating anything.  On
        a mesh: the global batch's loss and norm, and this rank's reduced
        gradients (slices of the sharded parameters)."""
        mesh = self.mesh
        loss = valley.loss_fn(self.params, self.cfg, batch,
                              remat=self.tc.gradient_checkpointing,
                              attention=self.attention,
                              lora_rng=self.lora_rng(),
                              lora_dropout=self.lora_dropout,
                              global_count=mesh is not None)
        grads = torch.autograd.grad(loss, self._trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self._trainable)]
        loss = loss.detach()
        if mesh is not None:
            sharding.all_reduce_replicated(grads, self._sharded, mesh,
                                           self._partial)
            loss = sharding.batch_sum(loss, sharding.batch_group(mesh))
        return loss, global_norm(grads, self._sharded, mesh,
                                 self._model_cut), grads

    def gathered(self, tensors: List[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """{name: full tensor} of per-parameter tensors in optimizer order
        (the gradients of `loss_and_grads`, the parameters): this rank's
        parts gathered over both axes on a mesh (a collective), else as
        they are."""
        if self.mesh is None:
            return dict(zip(self.names, tensors))
        return {n: sharding.full_leaf(n, t, self.sharding)
                for n, t in zip(self.names, tensors)}

    def train_step(self, batch) -> dict:
        """One micro-batch: gradients, accumulation, and every k-th time an
        optimizer update.  Returns the loss, grad_norm and whether the
        parameters were updated."""
        loss, gnorm, grads = self.loss_and_grads(batch)
        k = max(self.tc.gradient_accumulation_steps, 1)
        metrics = {"loss": float(loss), "grad_norm": float(gnorm),
                   "updated": False}
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self._micro
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self._micro = (n + 1) % k
            if self._micro:
                return metrics
            grads, self._acc = self._acc, None
        self._update(grads)
        self.step += 1
        metrics["updated"] = True
        return metrics

    def _update(self, grads: List[torch.Tensor]) -> None:
        # each group clipped on its own norm, in place and without a sync:
        # g / norm * max_norm where norm >= max_norm (the divisor rounded to
        # g's dtype, as optax's `t / g_norm * max_norm` in that dtype), else
        # g / 1 * 1, which is g
        max_norm = self.tc.max_grad_norm
        at = 0
        for group in self.optimizer.param_groups:
            n = len(group["params"])
            gs = grads[at:at + n]
            norm = global_norm(gs, self._sharded[at:at + n], self.mesh,
                               self._model_cut and self._model_cut[at:at + n])
            at += n
            clip = norm >= max_norm
            div = torch.where(clip, norm, 1.0)
            mul = torch.where(clip, max_norm, 1.0)
            for p, g in zip(group["params"], gs):
                p.grad = g.div_(div.to(g.dtype)).mul_(mul)
            group["lr"] = self.schedules[group["label"]](self.step)
        if self.offload:
            self._offloaded_step()
        else:
            self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- optimizer offload ---------------------------------------------------

    def _init_offloaded_state(self) -> None:
        """AdamW's state of every trainable parameter, made now as
        `torch.optim.AdamW` would at its first step (a step count of 0 on
        the host, zero moments), the moments in pinned host memory."""
        for p in self._trainable:
            self.optimizer.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": pinned_zeros(p),
                "exp_avg_sq": pinned_zeros(p)}

    def _chunks(self):
        """(parameter, its group, rows) of each chunk of at most
        ``offload_chunk`` elements (whole rows of the leading axis), in
        optimizer order."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                row = max(p[0].numel(), 1) if p.dim() else 1
                per = max(self.offload_chunk // row, 1)
                n = p.shape[0] if p.dim() else 1
                for i in range(0, n, per):
                    yield p, group, slice(i, min(i + per, n))

    def _offloaded_step(self) -> None:
        """The AdamW update of `torch.optim.AdamW.step` (foreach off), one
        chunk of rows at a time: ``torch.optim.adamw.adamw`` on the chunk's
        parameter and gradient rows and its moments' rows brought to the
        device, each chunk from the same step count.  The arithmetic is
        elementwise, so the result is the on-device update's bit for bit.
        On the card, the next chunk's moments are copied in on one side
        stream while the current chunk updates, and each updated chunk's
        go back on another; the host waits when three chunks are in flight,
        which bounds the device memory the moments take, and for the last
        copy before it returns, so the host moments are whole."""
        cuda = self.device.type == "cuda"
        if cuda and self._copy_streams is None:
            self._copy_streams = (torch.cuda.Stream(self.device),
                                  torch.cuda.Stream(self.device))
        state = self.optimizer.state

        def fetch(chunk):
            p, _, rows = chunk
            host = state[p]["exp_avg"][rows], state[p]["exp_avg_sq"][rows]
            if not cuda:
                return host, host, None
            with torch.cuda.stream(self._copy_streams[0]):
                dev = tuple(h.to(self.device, non_blocking=True)
                            for h in host)
                arrived = torch.cuda.Event()
                arrived.record()
            return host, dev, arrived

        chunks = list(self._chunks())
        steps = {p: state[p]["step"].clone() for p, _, _ in chunks}
        main = torch.cuda.current_stream(self.device) if cuda else None
        in_flight = []
        nxt = fetch(chunks[0]) if chunks else None
        for i, chunk in enumerate(chunks):
            p, group, rows = chunk
            host, dev, arrived = nxt
            if i + 1 < len(chunks):
                nxt = fetch(chunks[i + 1])
            if cuda:
                main.wait_event(arrived)
            beta1, beta2 = group["betas"]
            adamw(
                [p.data[rows]], [p.grad[rows]], [dev[0]], [dev[1]], [],
                [steps[p].clone()], foreach=False, capturable=False,
                differentiable=False, fused=None, amsgrad=group["amsgrad"],
                beta1=beta1, beta2=beta2, lr=group["lr"],
                weight_decay=group["weight_decay"], eps=group["eps"],
                maximize=group["maximize"])
            if not cuda:
                continue
            back = self._copy_streams[1]
            back.wait_stream(main)
            with torch.cuda.stream(back):
                for h, d in zip(host, dev):
                    h.copy_(d, non_blocking=True)
                    d.record_stream(main)
                    d.record_stream(back)
                done = torch.cuda.Event()
                done.record()
            in_flight.append(done)
            if len(in_flight) > 2:
                in_flight.pop(0).synchronize()
        for p in steps:
            state[p]["step"] += 1
        if cuda:
            self._copy_streams[1].synchronize()

    def adam_moments(self) -> List[torch.Tensor]:
        """Every AdamW moment of the trainable parameters, in optimizer
        order (empty before the first update when not offloaded)."""
        return [t for p in self._trainable
                for k, t in self.optimizer.state.get(p, {}).items()
                if k != "step"]

    def _load_optimizer(self, osd: dict) -> None:
        """`torch.optim.Optimizer.load_state_dict`; offloaded, the moments
        go straight into pinned host buffers, never through the device."""
        if not self.offload:
            self.optimizer.load_state_dict(osd)
            return
        moments = {i: {k: st.pop(k) for k in ("exp_avg", "exp_avg_sq")}
                   for i, st in osd["state"].items()}
        self.optimizer.load_state_dict(osd)
        ids = [p for g in self.optimizer.param_groups for p in g["params"]]
        for i, ms in moments.items():
            p = ids[i]
            for k, t in ms.items():
                buf = pinned_zeros(p)
                buf.copy_(t)
                self.optimizer.state[p][k] = buf

    def sync(self) -> None:
        """Wait for the device's queue (the end of a timed step)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop -------------------------------------------------------------

    def log(self, record: dict) -> None:
        if not self.rank0:
            return
        line = json.dumps(record)
        for path in (self._metrics_path, self._log_path):
            with open(path, "a") as f:
                f.write(line + "\n")
        logger.info(line)

    def _optimizer_state(self) -> dict:
        """``optimizer.state_dict()``; on a mesh with every moment gathered
        whole (a collective), on the host on rank 0 (the other ranks keep
        none of it)."""
        osd = self.optimizer.state_dict()
        if self.mesh is None:
            return osd
        states = {}
        for i, st in osd["state"].items():
            st = dict(st)    # the optimizer's own dict: leave it be
            for k in ("exp_avg", "exp_avg_sq"):
                full = sharding.full_leaf(self.names[i], st[k],
                                          self.sharding, self.device)
                st[k] = full.to("cpu", copy=True) if self.rank0 else None
            states[i] = st
        return {**osd, "state": states}

    def save(self, step: int, final: bool = False) -> str:
        """Save ``checkpoint-<step>``: blocking, or with
        ``async_checkpointing`` (but not for the ``final`` save) copied to
        the host here and written on a thread.  On a mesh every rank takes
        part in gathering the full state, which rank 0 writes."""
        params = self.params.state_dict() if self.mesh is None else \
            sharding.gather_state(self.params, to_host=True)
        state = {"params": params, "optimizer": self._optimizer_state(),
                 "step": step}
        path = os.path.abspath(os.path.join(self.tc.output_dir,
                                            f"checkpoint-{step}"))
        if not self.rank0:
            return path
        ckpt_lib.save_checkpoint(
            self.tc.output_dir, state, step, keep=self.tc.save_total_limit,
            block=final or not self.tc.async_checkpointing)
        if self.tc.lora and self.tc.lora_save_strategy == "steps":
            from valley_tpu_torch.train import lora as lora_lib

            tree = self.params if self.mesh is None else \
                from_state_dict(params)
            ckpt_lib.save_pytree(
                os.path.join(self.tc.output_dir, f"adapter-{step}"),
                lora_lib.split_lora(tree))
        return path

    def maybe_resume(self) -> int:
        """Load the newest checkpoint-N of ``output_dir`` into the
        parameters and optimizer, if there is one; returns its step."""
        restored = ckpt_lib.restore_latest(
            self.tc.output_dir,
            map_location="cpu" if self.offload or self.mesh is not None
            else self.device, mmap=self.mesh is not None)
        if restored is None:
            return 0
        state, step = restored
        logger.info("resume from checkpoint-%d", step)
        osd = state["optimizer"]
        if self.mesh is None:
            self.params.load_state_dict(state["params"])
        else:
            # the full tree of any world, cut to this rank's slices
            sharding.load_full_state(self.params, state["params"])
            osd = {**osd, "state": {i: {
                k: v if k == "step" else sharding.local_leaf(
                    self.names[i], v, self.sharding).contiguous()
                for k, v in st.items()} for i, st in osd["state"].items()}}
        self._load_optimizer(osd)
        self.step, self._micro, self._acc = step, 0, None
        return step

    def train(self, resume: bool = True) -> int:
        """Run ``num_train_epochs`` over the loader; returns the number of
        optimizer updates.  A resumed run skips the micro-batches its
        checkpoint already consumed.  Each micro-batch is timed to its
        synchronise; ``profile_steps`` "a:b" traces from the micro-batch
        that follows update a to update b (trainer.py:447-496)."""
        tc = self.tc
        accum = max(tc.gradient_accumulation_steps, 1)
        start_step = self.maybe_resume() if resume else 0
        prof_range = profile_range(tc.profile_steps)
        seen = 0
        t0 = time.time()
        timer = profiling.StepTimer()
        tracing = False
        with contextlib.ExitStack() as trace:
            for epoch in range(tc.num_train_epochs):
                for batch in self.train_loader.epoch(epoch):
                    seen += 1
                    if seen <= start_step * accum:
                        continue   # fast-forward through resumed data
                    if (prof_range and self.step == prof_range[0]
                            and not tracing and self.rank0):
                        trace.enter_context(profiling.trace(
                            os.path.join(tc.output_dir, "trace")))
                        tracing = True
                    t_step = time.perf_counter()
                    timer.start()
                    metrics = self.train_step(batch)
                    self.sync()
                    timer.stop()
                    if not metrics["updated"]:
                        continue   # mid-accumulation micro-batch
                    if tracing and self.step >= prof_range[1]:
                        trace.close()
                        tracing = False
                    self._after_update(epoch, metrics, t0, t_step, timer)
        self.save(self.step, final=True)
        return self.step

    def run_eval(self, step: int):
        """``eval_fn`` over the parameters; on a mesh over the gathered
        tree, on rank 0 while the other ranks wait (they return None)."""
        if self.mesh is None:
            return self.eval_fn(self.params, step)
        full = sharding.gather_params(self.params)
        result = self.eval_fn(full, step) if self.rank0 else None
        del full
        barrier()
        return result

    def _after_update(self, epoch: int, metrics: dict, t0: float,
                      t_step: float, timer: profiling.StepTimer) -> None:
        """The log line, the save and the eval that an update calls for."""
        tc = self.tc
        step = self.step
        if step % tc.logging_steps == 0:
            self.log({"step": step, "epoch": epoch,
                      "loss": metrics["loss"],
                      "grad_norm": metrics["grad_norm"],
                      "learning_rate": self.schedule(step),
                      "seconds": round(time.time() - t0, 2),
                      "step_seconds": round(time.perf_counter() - t_step, 4),
                      **{k: round(v, 4)
                         for k, v in timer.summary().items()}})
        if tc.save_steps and step % tc.save_steps == 0:
            self.save(step)
        if (self.eval_fn is not None and tc.evaluation_strategy == "steps"
                and tc.eval_steps and step % tc.eval_steps == 0):
            result = self.run_eval(step)
            if result:
                self.log({"step": step, **{f"eval_{k}": v
                                           for k, v in result.items()}})
