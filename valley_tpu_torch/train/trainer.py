"""Training loop of the PyTorch port, the counterpart of
``valley_tpu/train/trainer.py`` on one device.

* Parameter groups: the same labels as the JAX `label_params` ('frozen' |
  'base' | 'lora'), applied as ``requires_grad`` flags, so the backward
  computes gradients of the trainable parameters only (stage 1: projector
  and input embeddings) while still flowing through every frozen layer.
* The optimizer is optax's chain per label group, written for torch:
  ``clip_by_global_norm`` on each group's own norm (g * max_norm / norm when
  norm >= max_norm), then AdamW (`torch.optim.AdamW`, the ``foreach``
  implementation, moments in the parameters' dtype as optax keeps them by
  default), the learning rate of update n being ``schedule(n)``.  Frozen
  parameters are not in the optimizer: no update, no weight decay.
* Gradient accumulation as ``optax.MultiSteps``: the running mean of k
  micro-batch gradients, one update every k-th micro-batch; ``step``
  counts updates.  The logged loss and ``grad_norm`` (over every trainable
  gradient, before clipping) are the last micro-batch's.
* ``trainer.log`` / ``metrics.jsonl`` lines, ``checkpoint-N`` saves and
  auto-resume through `valley_tpu_torch.utils.checkpoint`.

Options that only the JAX package's mesh, TPU or LoRA code gave are
refused with NotImplementedError (see `check_ported`).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.data.dataset import PrefetchLoader
from valley_tpu_torch.models import valley
from valley_tpu_torch.ops.attention import KERNELS, Attention
from valley_tpu_torch.utils import checkpoint as ckpt_lib
from valley_tpu_torch.weights import set_trainable

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
    # True/"full": recompute whole layers in the backward; False: off
    gradient_checkpointing: Any = True
    logging_steps: int = 1
    save_steps: int = 2400
    save_total_limit: int = 1
    # the port's saves always block; the files are the same either way
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
    offload_optimizer: bool = False
    report_to: Optional[str] = None
    run_name: str = "valley"
    profile_steps: Optional[str] = None
    predict_with_generate: bool = False
    prediction_file_name: Optional[str] = None
    generation_max_length: int = 1536
    eval_num: int = 400
    evaluation_strategy: str = "no"
    eval_steps: int = 3000
    export_hf: bool = False


def check_ported(tc: TrainConfig) -> None:
    """Refuse the options this port does not run."""
    refused = {
        "lora": tc.lora and "LoRA training (train/lora.py, with its adapter "
        "dropout and dropout_rng_impl) is not ported yet",
        "offload_optimizer": tc.offload_optimizer and "optimizer offload to "
        "host memory is not ported",
        "mesh": ((tc.mesh_data, tc.mesh_model) != (1, 1)
                 or tc.mesh_fsdp not in (-1, 1))
        and f"the port trains on one device: mesh_data/mesh_fsdp/mesh_model "
        f"must be 1/-1/1, got {tc.mesh_data}/{tc.mesh_fsdp}/{tc.mesh_model}",
        "report_to": tc.report_to == "wandb" and "report_to: wandb is not "
        "ported; the trainer writes trainer.log and metrics.jsonl",
        "profile_steps": bool(tc.profile_steps) and "profile_steps (a "
        "jax.profiler trace) is not ported",
    }
    for what in refused.values():
        if what:
            raise NotImplementedError(what)


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


def make_optimizer(params: valley.ValleyWeights, tc: TrainConfig,
                   total_steps: int):
    """Label the parameters, let the trainable ones take gradients, and
    build AdamW over them, one parameter group per label.  Returns
    (optimizer, schedule, labels)."""
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
    opt = torch.optim.AdamW(groups, lr=0.0,
                            betas=(tc.adam_beta1, tc.adam_beta2),
                            eps=tc.adam_eps, weight_decay=tc.weight_decay,
                            foreach=True)
    return opt, sched, labels


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Train ``params`` in place on the batches of ``train_loader`` (an
    object with ``epoch(i)`` yielding collated numpy batches, as the port's
    `DataLoader`).  The ``attention`` attribute picks the kernels (the
    default, `KERNELS`) or their plain versions (`PLAIN`, to compare a
    step on the card against); it is read at every step."""

    def __init__(self, cfg: ValleyConfig, tc: TrainConfig,
                 params: valley.ValleyWeights, train_loader,
                 total_steps: Optional[int] = None):
        self.cfg = cfg
        self.tc = tc
        self.params = params
        self.attention: Attention = KERNELS
        self.device = next(params.parameters()).device
        self.total_steps = total_steps or (
            len(train_loader) * tc.num_train_epochs
            // max(tc.gradient_accumulation_steps, 1))
        self.optimizer, self.schedule, self.labels = make_optimizer(
            params, tc, self.total_steps)
        self._trainable = [p for g in self.optimizer.param_groups
                           for p in g["params"]]
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

    def loss_and_grads(self, batch):
        """(loss, global grad norm, [gradient of each trainable parameter,
        in optimizer order]) of one batch, without updating anything."""
        loss = valley.loss_fn(self.params, self.cfg, batch,
                              remat=self.tc.gradient_checkpointing,
                              attention=self.attention)
        grads = torch.autograd.grad(loss, self._trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self._trainable)]
        return loss.detach(), global_norm(grads), grads

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
        # One schedule for every group.  The JAX trainer gives the 'lora'
        # group its own from ``lora_lr``; that group cannot exist while
        # `check_ported` refuses LoRA, and needs it when train/lora.py lands.
        lr = self.schedule(self.step)
        max_norm = self.tc.max_grad_norm
        it = iter(grads)
        for group in self.optimizer.param_groups:
            gs = [next(it) for _ in group["params"]]
            norm = global_norm(gs)
            for p, g in zip(group["params"], gs):
                p.grad = torch.where(norm < max_norm, g,
                                     g / norm.to(g.dtype) * max_norm)
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- loop -------------------------------------------------------------

    def log(self, record: dict) -> None:
        line = json.dumps(record)
        for path in (self._metrics_path, self._log_path):
            with open(path, "a") as f:
                f.write(line + "\n")
        logger.info(line)

    def save(self, step: int) -> str:
        return ckpt_lib.save_checkpoint(
            self.tc.output_dir,
            {"params": self.params.state_dict(),
             "optimizer": self.optimizer.state_dict(), "step": step},
            step, keep=self.tc.save_total_limit)

    def maybe_resume(self) -> int:
        """Load the newest checkpoint-N of ``output_dir`` into the
        parameters and optimizer, if there is one; returns its step."""
        restored = ckpt_lib.restore_latest(self.tc.output_dir,
                                           map_location=self.device)
        if restored is None:
            return 0
        state, step = restored
        logger.info("resume from checkpoint-%d", step)
        self.params.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self._micro, self._acc = step, 0, None
        return step

    def train(self, resume: bool = True) -> int:
        """Run ``num_train_epochs`` over the loader; returns the number of
        optimizer updates.  A resumed run skips the micro-batches its
        checkpoint already consumed."""
        tc = self.tc
        accum = max(tc.gradient_accumulation_steps, 1)
        start_step = self.maybe_resume() if resume else 0
        seen = 0
        t0 = time.time()
        for epoch in range(tc.num_train_epochs):
            for batch in self.train_loader.epoch(epoch):
                seen += 1
                if seen <= start_step * accum:
                    continue   # fast-forward through resumed data
                t_step = time.perf_counter()
                metrics = self.train_step(batch)
                if not metrics["updated"]:
                    continue   # mid-accumulation micro-batch
                step = self.step
                if step % tc.logging_steps == 0:
                    self.log({"step": step, "epoch": epoch,
                              "loss": metrics["loss"],
                              "grad_norm": metrics["grad_norm"],
                              "learning_rate": self.schedule(step),
                              "seconds": round(time.time() - t0, 2),
                              "step_seconds": round(
                                  time.perf_counter() - t_step, 4)})
                if tc.save_steps and step % tc.save_steps == 0:
                    self.save(step)
        self.save(self.step)
        return self.step
