"""LSTM motion-model training, the counterpart of
``deft_tpu/train/prediction.py`` (the reference's ``train_prediction.py``).

SmoothL1 on the future-delta targets with the reference's loss scale
(x100 while 100 x loss < 20, else x10), Adam with step decay, one
trajectory per step at batch 1.  Trajectories vary in length (random frame
drops); each step runs the rollout at its own length.

The JAX ``DecoderRNN`` has one LSTM bias (flax's ``OptimizedLSTMCell``);
the port's module has the reference's two (``bias_ih_l0``, ``bias_hh_l0``),
which only enter as their sum.  Training both would move the sum twice as
far per Adam step, so the trainer folds ``bias_ih_l0`` into ``bias_hh_l0``,
holds it at zero and trains ``bias_hh_l0`` alone, as the JAX trainer
trains its one bias.  The ``.pth`` it writes keeps both keys.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deft_tpu_torch.tracking.motion_lstm import DecoderRNN, init_decoder
from deft_tpu_torch.train.trainer import lr_at


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return F.smooth_l1_loss(pred, target)


def scaled_loss(loss: torch.Tensor) -> torch.Tensor:
    """The reference's schedule: small losses magnified more."""
    return torch.where(100.0 * loss < 20.0, 100.0 * loss, 10.0 * loss)


def train_motion_model(cfg, dataset, num_epochs=None, logger=None,
                       steps_per_epoch=None, save_dir=None,
                       model: Optional[DecoderRNN] = None, device=None,
                       stats: Optional[dict] = None) -> DecoderRNN:
    """Train a ``DecoderRNN`` on a ``TrajectoryDataset``; returns it.

    Starts from ``model`` where given (on its device and in its dtype),
    else from
    ``init_decoder(cfg.dataset, cfg.seed)`` on ``device``.  Per epoch, the
    first ``steps_per_epoch`` (default ``len(dataset)``) indices of
    ``np.random.permutation(len(dataset))``; a trajectory of fewer than two
    steps is skipped and takes no update.  The learning rate drops x0.1
    once ``int(e) * steps_per_epoch`` updates are made, for each ``e`` of
    ``cfg.lr_step`` (``trainer.lr_at``: optax's piecewise-constant
    schedule at the count of updates, as the JAX trainer builds it).  One log line per epoch; ``<save_dir>/model_last.pth``
    written after each.  A dict passed as ``stats`` receives per step
    ``step_seconds`` (host time from the end of the previous step, the
    sample's construction included, to the loss read back),
    ``lengths`` (the trajectory's steps) and ``losses`` (the scaled loss),
    ``skipped`` (trajectories too short to train on) and ``checkpoint``."""
    if model is None:
        from deft_tpu_torch.models.factory import resolve_device

        model = init_decoder(cfg.dataset, cfg.seed).to(
            resolve_device(device or "cuda"))
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    lstm = model.lstm
    with torch.no_grad():
        lstm.bias_hh_l0.add_(lstm.bias_ih_l0)
        lstm.bias_ih_l0.zero_()
    lstm.bias_ih_l0.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    model.train()

    num_epochs = num_epochs or cfg.num_epochs
    n = steps_per_epoch or len(dataset)
    if stats is not None:
        stats.update(step_seconds=[], lengths=[], losses=[], skipped=0)
    step = 0
    for epoch in range(1, num_epochs + 1):
        order = np.random.permutation(len(dataset))[:n]
        losses = []
        t_end = time.perf_counter()
        for idx in order:
            traj, target = dataset[int(idx)]
            if traj.shape[0] < 2:
                if stats is not None:
                    stats["skipped"] += 1
                continue
            for group in optimizer.param_groups:
                group["lr"] = lr_at(cfg, n, step)
            traj_t = torch.from_numpy(traj)[None].to(dev, dtype)
            target_t = torch.from_numpy(target)[None].to(dev, dtype)
            optimizer.zero_grad(set_to_none=True)
            out = model(traj_t)
            loss = scaled_loss(smooth_l1(out.reshape(1, -1),
                                         target_t.reshape(1, -1)))
            loss.backward()
            optimizer.step()
            step += 1
            losses.append(float(loss.detach()))
            if stats is not None:
                now = time.perf_counter()
                stats["step_seconds"].append(now - t_end)
                stats["lengths"].append(int(traj.shape[0]))
                stats["losses"].append(losses[-1])
                t_end = now
        msg = f"motion epoch {epoch}: loss {np.mean(losses):.5f}"
        (logger.write(msg) if logger else print(msg))
        if save_dir:
            from deft_tpu_torch.train.checkpoint import save_motion_checkpoint

            path = save_motion_checkpoint(
                os.path.join(save_dir, "model_last"), model, epoch)
            if stats is not None:
                stats["checkpoint"] = path
    return model
