"""Training runtime, the counterpart of ``deft_tpu/train/trainer.py``.

``Trainer`` holds what the JAX ``TrainState`` holds -- the model (its
parameters and BatchNorm statistics), the optimizer's state, the step and
the Kendall uncertainty weights ``s_det`` and ``s_id`` (initialized to 1.0,
trained with the model) -- and does one step of the reference's iteration
(``loss_and_updates``, ``deft_tpu/train/trainer.py:72-107``): the image
and the ``pre_image`` through the trunk (``DEFTNet.train_forward``), the
head losses, the AFE matching loss and the joint loss, the backward, and
one optimizer update.

* ``make_lr_schedule``: optax's ``piecewise_constant_schedule`` with x0.1 at
  every ``lr_step`` epoch boundary, read at the number of updates made
  before this one (``train.py:123-127``);
* ``make_optimizer``: ``adam`` is ``torch.optim.Adam`` with optax's defaults
  (b1 0.9, b2 0.999, eps 1e-8 outside the square root; the same update as
  ``optax.adam``), ``sgd`` is ``torch.optim.SGD`` with momentum and the
  decayed weights of ``optax.add_decayed_weights`` (added to the gradient
  before the momentum, as torch's ``weight_decay`` does);
* ``train_step`` returns ``loss_and_updates``'s statistics as floats, on
  one host synchronisation; ``eval_step`` the same statistics in eval
  mode with no update.

Under a process group (``deft_tpu_torch.distributed``, one rank per card)
each rank steps on its rows of the global batch: its losses are its parts
of the global loss (``losses.py``), its train-mode BatchNorms take the
global moments (``layers.train_batch_norm``), the gradients are summed over
the ranks after the backward (``sum_gradients``: the global loss's
gradient, with no division by the world size), so every rank makes the
same update; the statistics returned are the sums of the ranks' parts, the
global batch's values.

Float32 products stay off TF32, as everywhere in the port
(``deft_tpu_torch/__init__.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
import torch.nn as nn

from deft_tpu_torch import distributed
from deft_tpu_torch.train import losses as L

# batch keys the model reads; the rest are targets (train.py::_training_keys)
_INPUTS = ("image", "pre_image", "centers_pre", "centers_next")
_INDEX_KEYS = ("ind", "cat", "rotbin")


def training_keys(batch: Dict[str, np.ndarray], cfg) -> list:
    """The keys of ``batch`` the step reads (``train.py:_training_keys``)."""
    keys = {"image", "pre_image", "centers_pre", "centers_next", "labels",
            "mask_pre", "mask_next", "hm", "ind", "cat", "mask"}
    for head in cfg.heads:
        if head == "hm":
            continue
        if head == "rot":
            keys |= {"rotbin", "rotres", "rot_mask"}
        else:
            keys |= {head, f"{head}_mask"}
    return sorted(k for k in keys if k in batch)


def to_device(batch: Dict[str, np.ndarray], keys: Iterable[str],
              device) -> Dict[str, torch.Tensor]:
    """The numpy batch's ``keys`` as tensors on ``device`` (index keys as
    int64, which ``torch.gather`` takes)."""
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if k in _INDEX_KEYS:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def lr_at(cfg, steps_per_epoch: int, step: int) -> float:
    """``make_lr_schedule(cfg, steps_per_epoch)(step)``: the learning rate
    of the update made after ``step`` updates."""
    lr = cfg.lr
    for e in sorted(int(e) for e in cfg.lr_step):
        if step >= e * steps_per_epoch:
            lr *= 0.1
    return lr


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optim}")


class Trainer:
    """Model, optimizer, step and uncertainty weights of a training run
    (module docstring).  ``model`` is a ``DEFTNet`` on ``device``."""

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int = 1000):
        if not hasattr(model, "train_forward"):
            raise ValueError(f"{type(model).__name__} has no train_forward: "
                             "the trainer trains the DEFT tracker (--arch "
                             "dla_<depth>)")
        self.model = model
        self.cfg = cfg
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        dev = next(model.parameters()).device
        self.device = dev
        self.s_det = nn.Parameter(torch.ones((), device=dev))
        self.s_id = nn.Parameter(torch.ones((), device=dev))
        self.params = list(model.parameters()) + [self.s_det, self.s_id]
        self.optimizer = make_optimizer(cfg, self.params)
        self.step = 0

    def loss_and_stats(self, batch: Dict[str, torch.Tensor]):
        """Forward and every loss (``loss_and_updates``): (joint total,
        {name: 0-d tensor})."""
        outputs, affinity = self.model.train_forward(
            *(batch[k] for k in _INPUTS))
        det = L.generic_loss(outputs, batch, self.cfg.weights)
        afe = L.afe_loss(affinity, batch["labels"], batch["mask_pre"],
                         batch["mask_next"])
        total = L.joint_loss(det["tot"], afe["loss"], self.s_det, self.s_id)
        stats = {**det, "matching": afe["loss"],
                 "matching_acc": afe["accuracy"], "joint": total}
        return total, stats

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update on ``batch`` (tensors on the model's device); the
        loss statistics as floats."""
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.cfg, self.steps_per_epoch, self.step)
        self.optimizer.zero_grad(set_to_none=True)
        total, stats = self.loss_and_stats(batch)
        total.backward()
        distributed.sum_gradients(self.params)
        self.optimizer.step()
        self.step += 1
        return _floats(stats)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The statistics of ``batch`` in eval mode (``make_eval_step``)."""
        self.model.eval()
        _, stats = self.loss_and_stats(batch)
        return _floats(stats)


def _floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = sorted(stats)
    values = distributed.global_sum(torch.stack(
        [stats[k].detach().float().reshape(()) for k in keys])).cpu().tolist()
    return dict(zip(keys, values))
