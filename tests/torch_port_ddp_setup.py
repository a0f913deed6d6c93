"""Shared by the data-parallel training files of the port
(``test_torch_port_ddp*.py``): the data, the runs and the checks.

The MOT recipe's train flags at 64x96 with ``dla_node="conv"`` (as
``test_torch_port_train_step.py``; the JAX gradient of the DCN node would
take minutes to compile), max_object 8, ``--batch_size 4``, one step on
the first global batch of a ``tools/make_synthetic_mot.py`` sequence:

* ``gloo_run``: ``train_rank`` in two spawned processes, a gloo group of
  world size 2 on the CPU (``--gpus -1``, ``--num_workers 0``: the
  in-process loader, each rank keeping rows ``rank::2``), one iteration;
* ``one_process``: the port's ``Trainer`` stepping on the whole global
  batch in this process, from the same seeded weights;
* ``global_batch``: that batch, as the one-process loader gives it after
  the entry's seeding (``np.random`` and ``random`` from ``--seed``).

``check_adam_step`` holds two states after one Adam step from the same
weights with ``test_torch_port_train_step.py``'s criteria: a first Adam
step moves a weight by about lr x sign(g), so every parameter's update is
at most 2 x lr apart, within 1e-3 x lr wherever its gradient is above half
its tensor's largest, and more than that apart on at most 15% of a
tensor's elements and 3% of all (the signs of small gradients are float32
noise); tensors whose gradient is rounding alone (biases that a train-mode
BatchNorm follows) are left out of the last two counts.
"""

import random

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_port_ddp_rank
from torch_port_recipes import mot_dataset

from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.data.datasets import get_dataset
from deft_tpu_torch.data.loader import DataLoader
from deft_tpu_torch.distributed import free_address
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.train.trainer import Trainer, to_device, training_keys

ARGV = ["tracking", "--dataset", "mot", "--dataset_version", "17trainval",
        "--ltrb_amodal", "--same_aug_pre", "--hm_disturb", "0.05",
        "--lost_disturb", "0.4", "--fp_disturb", "0.1", "--input_h", "64",
        "--input_w", "96", "--max_object", "8", "--batch_size", "4",
        "--dla_node", "conv", "--gpus", "-1", "--num_workers", "0",
        "--num_epochs", "1", "--num_iters", "1", "--exp_id", "ddp"]
WORLD = 2
LOSS_RTOL = 1e-4          # test_torch_port_train_step.py's


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return mot_dataset(tmp_path_factory.mktemp("mot"), frames=8,
                       size=(192, 128))


def argv_for(data, exp_dir):
    return ARGV + ["--data_dir", str(data.parent), "--exp_dir", str(exp_dir)]


def loader(data, rank=0, world=1, batch_size=4):
    """The train loader of ``ARGV`` (in process), as a rank builds it."""
    cfg, _ = parse_config(argv_for(data, "unused"))
    return DataLoader(get_dataset("mot")(cfg, "train", data_dir=str(data)),
                      batch_size, num_workers=0, seed=cfg.seed, rank=rank,
                      world=world)


def seeded_batches(data, rank=0, world=1, n=1):
    """The first ``n`` batches of ``loader`` after the entry's seeding."""
    cfg, _ = parse_config(argv_for(data, "unused"))
    np.random.seed(cfg.seed)
    random.seed(cfg.seed)
    out = []
    for batch in loader(data, rank, world):
        out.append(batch)
        if len(out) == n:
            return out


def global_batch(data):
    """The first global batch, with the keys the step reads."""
    cfg, _ = parse_config(argv_for(data, "unused"))
    (batch,) = seeded_batches(data)
    return {k: batch[k] for k in training_keys(batch, cfg)}


@pytest.fixture(scope="module")
def gloo_run(data, tmp_path_factory):
    """Two gloo ranks through ``train_rank``: ({rank: saved state}, the
    save dir)."""
    out = tmp_path_factory.mktemp("ddp")
    exp = out / "exp"
    mp.spawn(torch_port_ddp_rank.run_rank,
             args=(WORLD, argv_for(data, exp), free_address(), str(out)),
             nprocs=WORLD)
    ranks = {r: torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)}
    return ranks, exp / "tracking" / "ddp"


@pytest.fixture(scope="module")
def one_process(data):
    """The port's one-process step on the global batch: (statistics,
    initial state, gradients, trainer)."""
    cfg, _ = parse_config(argv_for(data, "unused"))
    batch = global_batch(data)
    trainer = Trainer(create_model(cfg.arch, cfg, "cpu"), cfg, 1)
    init = {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}
    stats = trainer.train_step(to_device(batch, list(batch), "cpu"))
    grads = {n: p.grad.numpy().copy()
             for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return stats, init, grads, trainer


def check_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1.0), (k, got[k], w)


def check_adam_step(got, want, grads, params, lr, stats_tol):
    """Two state dicts after one Adam step (module docstring); BatchNorm
    statistics within ``stats_tol`` x max(1, max|value|)."""
    top = max(np.abs(g).max() for g in grads.values())
    flips = total = 0
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == int(want[key]), key
            continue
        value = np.asarray(value, np.float32)
        d = np.abs(value - np.asarray(want[key], np.float32))
        if key in grads:
            g = np.abs(grads[key])
            assert d.max() <= 2 * lr + 1e-3 * lr, key
            if g.max() <= 1e-6 * top:
                continue
            sure = g > 0.5 * g.max()
            assert d[sure].max(initial=0) <= 1e-3 * lr, key
            flipped = int((d > 1e-3 * lr).sum())
            assert flipped <= 0.15 * d.size, (key, flipped, d.size)
            flips += flipped
            total += d.size
        elif key in params:
            assert d.max() <= 1e-3 * lr, key    # no gradient: no update
        else:                                   # BatchNorm statistics
            assert d.max() <= stats_tol * max(1.0, np.abs(value).max()), (
                key, d.max())
    assert flips <= 0.03 * total, (flips, total)
    return flips, total
