"""Joint detector + AFE training, the counterpart of the JAX package's root
``train.py`` (``python -m deft_tpu_torch.train`` runs this ``main``):

    python -m deft_tpu_torch.train tracking --exp_id mot17_train \\
        --dataset mot --dataset_version 17trainval --ltrb_amodal \\
        --same_aug_pre --hm_disturb 0.05 --lost_disturb 0.4 \\
        --fp_disturb 0.1 --compute_dtype bfloat16

The flags are ``train.py``'s (``cli.py``), so each ``train.py`` line of
``experiments/*.sh`` runs as it is.  ``--gpus -1`` runs on the CPU; by
default the run is on ``cuda:0``, and it raises where there is no card.

Several ids (``--gpus 0,1,2,3``) train on every one of those cards, as the
JAX trainer shards its batch over every device: one process per id
(``torch.multiprocessing``), each the rank of an NCCL process group that
runs ``train_rank``, with its rows of each global batch of
``--batch_size`` (``data/loader.py``), the global loss normalizers and
BatchNorm moments, and the gradients summed over the ranks
(``deft_tpu_torch/distributed.py``).  Rank 0 alone writes the ``.pth``
files, ``log.txt``, ``scalars/`` and the profile.  ``train_rank(rank,
world, backend, argv)`` is also the entry for one rank of a group started
elsewhere (the tests run two gloo ranks on the CPU).

The loop is the JAX one (``train.py:21-150``): the dataset's ``train``
split through ``data/loader.py`` (``--num_workers``, ``--batch_size``,
order from ``--seed``), a seeded model (``create_model``), a ``Trainer``
(Adam or SGD, step decay at ``--lr_step``), resume from ``--load_model``
or, under ``--resume``, ``<save_dir>/model_last.pth``; per epoch up to
``--num_iters`` steps, the loss statistics of the first step and of every
fifth averaged into ``log.txt`` and ``scalars/``, ``model_last.pth``
written, and ``model_<epoch>.pth`` at ``--save_point``, ``--lr_step`` and
under ``--save_all``; every ``--val_intervals`` epochs the eval step over
the ``val`` split where the dataset has one.  ``--test`` (instead of
training) and ``--eval_val`` (after it) run ``deft_tpu_torch.test.main``
on the same line with the run's ``model_last``, as ``_run_tracking_eval``
does.  ``--profile <dir>`` records the device's activity under
``torch.profiler`` from the second step to the last and writes its trace
to ``<dir>/trace.json``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np


def main(argv=None, stats: Optional[dict] = None):
    """Run the training line ``argv``.  A dict passed as ``stats`` receives,
    per step, ``step_seconds`` (host wall time from the end of the previous
    step, the wait for the batch included, to the end of this one, which
    waits for the device) and ``wait_seconds`` (the wait for the batch),
    ``first`` and ``last`` (the loss statistics of the first and the last
    step), ``samples`` and ``checkpoint`` (the last ``model_last.pth``),
    ``backend`` and ``world`` (the process group's; None and 1 without);
    under ``--profile``, ``device_ms`` (device kernel time) and
    ``profiled_steps`` (the steps it covers).  ``stats`` is kept by a
    one-process run; with several ids, pass it to ``train_rank``.
    Returns the evaluation's value under ``--eval_val``, else None."""
    from deft_tpu_torch.cli import parse_config

    cfg, extras = parse_config(argv)
    if cfg.test:
        return _run_tracking_eval(argv, cfg)
    argv = list(argv) if argv is not None else sys.argv[1:]
    world = len(extras["devices"])
    if world == 1:
        train_rank(0, 1, None, argv, stats)
    else:
        if stats is not None:
            raise ValueError("stats are kept by a one-process run; with "
                             "several --gpus ids pass them to train_rank")
        import torch.multiprocessing as mp

        from deft_tpu_torch.distributed import free_address

        mp.spawn(train_rank, args=(world, "nccl", argv, None,
                                   free_address()), nprocs=world)
    if cfg.eval_val:
        return _run_tracking_eval(argv, cfg)
    return None


def train_rank(rank: int, world: int, backend: Optional[str], argv,
               stats: Optional[dict] = None,
               init_method: Optional[str] = None):
    """Rank ``rank`` of ``world`` training the line ``argv``: on the
    ``rank``-th id of ``--gpus`` (every rank on the one device where it
    names one), in a ``backend`` process group (``"nccl"`` on the card,
    ``"gloo"`` on the CPU) that it joins at ``init_method`` (a free
    localhost port by default, which only ``world`` 1 may take) and leaves
    at the end.  ``backend`` None is the one-process run, with no group.
    ``stats`` as ``main``'s, the rank's own.  Returns the rank's
    ``Trainer``."""
    from deft_tpu_torch import distributed
    from deft_tpu_torch.cli import parse_config
    from deft_tpu_torch.models.factory import resolve_device

    cfg, extras = parse_config(argv)
    devices = extras["devices"]
    if len(devices) not in (1, world):
        raise ValueError(f"{world} ranks on --gpus {devices}")
    device = resolve_device(devices[rank] if len(devices) > 1
                            else devices[0])
    if backend is None:
        if world != 1:
            raise ValueError("several ranks need a process group backend")
        return _train(cfg, extras, device, stats)
    if init_method is None:
        if world != 1:
            raise ValueError("ranks of a group need one init_method")
        init_method = distributed.free_address()
    distributed.init(rank, world, backend, init_method, device)
    try:
        return _train(cfg, extras, device, stats)
    finally:
        distributed.close()


def _train(cfg, extras, device, stats: Optional[dict]):
    """The training loop of one rank (``main``'s docstring); returns its
    ``Trainer``."""
    import random

    import torch

    from deft_tpu_torch import distributed
    from deft_tpu_torch.data.datasets import get_dataset
    from deft_tpu_torch.data.loader import DataLoader
    from deft_tpu_torch.models.factory import create_model, require_deft_arch
    from deft_tpu_torch.train.checkpoint import (load_train_state,
                                                 save_checkpoint)
    from deft_tpu_torch.train.trainer import (Trainer, to_device,
                                              training_keys)
    from deft_tpu_torch.utils.logger import Logger

    require_deft_arch(cfg.arch, "training")
    rank, world = distributed.rank(), distributed.world_size()
    # every rank draws the same augmentations in process (data/loader.py)
    np.random.seed(cfg.seed)
    random.seed(cfg.seed)
    logger = Logger(cfg)
    logger.write(f"device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})"
                    if device.type == "cuda" else "")
                 + (f", rank 0 of {world}" if world > 1 else ""))
    data_dir = os.path.join(extras["data_dir"], _dataset_dirname(cfg))
    dataset_cls = get_dataset(cfg.dataset)
    loader = DataLoader(dataset_cls(cfg, "train", data_dir=data_dir),
                        cfg.batch_size, num_workers=extras["num_workers"],
                        seed=cfg.seed, rank=rank, world=world)
    steps_per_epoch = max(len(loader), 1)
    trainer = Trainer(create_model(cfg.arch, cfg, device), cfg,
                      steps_per_epoch)

    start_epoch = 0
    if cfg.resume or cfg.load_model:
        path = cfg.load_model or os.path.join(cfg.save_dir, "model_last")
        if os.path.exists(path) or os.path.exists(path + ".pth"):
            start_epoch = load_train_state(path, trainer)
            logger.write(f"resumed from {path} at epoch {start_epoch} "
                         f"(step {trainer.step})")

    val_loader = None
    if 0 < cfg.val_intervals <= cfg.num_epochs:
        try:
            val_loader = DataLoader(
                dataset_cls(cfg, "val", data_dir=data_dir), cfg.batch_size,
                shuffle=False, num_workers=extras["num_workers"],
                rank=rank, world=world)
        except (FileNotFoundError, KeyError) as e:
            logger.write(f"no val split available ({e}); skipping periodic "
                         "val")
    logger.write(f"training on {device} | {steps_per_epoch} steps/epoch")

    if stats is not None:
        stats.update(step_seconds=[], wait_seconds=[], samples=0,
                     backend=distributed.backend(), world=world)
    keys = None
    prof = None
    try:
        for epoch in range(start_epoch + 1, cfg.num_epochs + 1):
            t0 = time.time()
            agg = {}
            n_iter = 0
            batches = iter(loader)
            t_end = time.perf_counter()
            while True:
                batch = next(batches, None)
                t_batch = time.perf_counter()
                if batch is None:
                    break
                keys = keys or training_keys(batch, cfg)
                out = trainer.train_step(to_device(batch, keys, device))
                n_iter += 1
                if n_iter % 5 == 0 or n_iter == 1:
                    for k, v in out.items():
                        agg.setdefault(k, []).append(v)
                if stats is not None:
                    now = time.perf_counter()
                    stats["step_seconds"].append(now - t_end)
                    stats["wait_seconds"].append(t_batch - t_end)
                    stats["samples"] += len(batch["image"])
                    stats.setdefault("first", out)
                    stats["last"] = out
                if cfg.profile and prof is None and rank == 0:
                    prof = _device_profiler(device)
                    profiled_from = trainer.step
                t_end = time.perf_counter()
                if cfg.num_iters > 0 and n_iter >= cfg.num_iters:
                    break
            msg = " ".join(f"{k} {np.mean(v):.4f}"
                           for k, v in sorted(agg.items()))
            logger.write(f"epoch {epoch} [{time.time() - t0:.0f}s] {msg}")
            for k, v in agg.items():
                logger.scalar_summary(f"train_{k}", float(np.mean(v)), epoch)
            last = save_checkpoint(os.path.join(cfg.save_dir, "model_last"),
                                   trainer, epoch)
            if stats is not None:
                stats["checkpoint"] = last
            if cfg.save_all or epoch in cfg.save_point or epoch in cfg.lr_step:
                save_checkpoint(os.path.join(cfg.save_dir, f"model_{epoch}"),
                                trainer, epoch)
            if (val_loader is not None and cfg.val_intervals > 0
                    and epoch % cfg.val_intervals == 0):
                vagg = {}
                for batch in val_loader:
                    keys = keys or training_keys(batch, cfg)
                    vout = trainer.eval_step(to_device(batch, keys, device))
                    for k, v in vout.items():
                        vagg.setdefault(k, []).append(v)
                vmsg = " ".join(f"{k} {np.mean(v):.4f}"
                                for k, v in sorted(vagg.items()))
                logger.write(f"epoch {epoch} VAL {vmsg}")
                for k, v in vagg.items():
                    logger.scalar_summary(f"val_{k}", float(np.mean(v)),
                                          epoch)
    finally:
        loader.close()
        if val_loader is not None:
            val_loader.close()
        if prof is not None:
            prof.stop()
    if prof is not None:
        os.makedirs(cfg.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile, "trace.json"))
        if stats is not None:
            stats["device_ms"] = _device_ms(prof)
            stats["profiled_steps"] = trainer.step - profiled_from
    logger.write("training done")
    logger.close()
    return trainer


def _device_profiler(device):
    """A started ``torch.profiler`` recording the device's activity (the
    CPU's where the run is on it)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def _device_ms(prof) -> float:
    """Device kernel milliseconds of a stopped profiler (0 on the CPU)."""
    from torch.autograd import DeviceType

    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if t is None else t
    return total / 1e3


def _run_tracking_eval(argv, cfg):
    """The line through ``deft_tpu_torch.test.main`` with the run's
    ``model_last`` where it names no ``--load_model`` (``train.py``'s
    ``--test`` / ``--eval_val``)."""
    from deft_tpu_torch import test

    args = list(argv) if argv is not None else list(sys.argv[1:])
    if not cfg.load_model:
        args += ["--load_model", os.path.join(cfg.save_dir, "model_last")]
    return test.main(args)


def _dataset_dirname(cfg):
    if cfg.dataset == "mot":
        year = int(cfg.dataset_version[:2]) if cfg.dataset_version else 17
        return f"mot{year}"
    return cfg.dataset
