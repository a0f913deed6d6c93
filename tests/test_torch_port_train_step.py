"""One training step of the port against the JAX package's, and the
training entry point, on the CPU.

``dla_node="conv"`` at 64x96, batch 2, ``max_object`` 8, the MOT recipe's
train flags, one batch of a ``tools/make_synthetic_mot.py`` sequence; the
JAX gradient of the DCN node at full depth would take minutes to compile,
so the DCN's part is held by ``test_torch_port_train_dcn.py``.

* One Adam step from the same weights on the same batch, against
  ``make_train_step``: the loss statistics within 1e-4 relative (float32
  through ~30 train-mode BatchNorms, flax's variance E[x^2] - E[x]^2); the
  port's update equal to ``optax.adam`` (``make_optimizer``) on the port's
  gradients, up to one float32 rounding of the weight; against the JAX
  step, every parameter's update at most 2 x lr apart, within 1e-3 x lr
  wherever its gradient is above half its tensor's largest, and more than
  that apart on at most 15% of a tensor's elements and 3% of all.  A first
  Adam step moves a weight by about lr x sign(g); at this size the deepest
  train-mode BatchNorms see 12 values per channel, and float32 gradients
  there are off by up to a fifth of a tensor's largest against float64 in
  either package, so the signs of small ones are noise.  Tensors whose
  gradient is zero but rounding (biases that a train-mode BatchNorm
  follows) are left out of the last two counts.  The BatchNorm statistics
  within 1e-4 relative (their update carries 0.1 x the batch variance,
  which flax takes as E[x^2] - E[x]^2 in float32, losing digits where the
  mean is large against the spread), ``s_det`` / ``s_id`` within 1e-7.
* Save, resume into a fresh trainer and one more step equals two steps in
  a row (the same CPU arithmetic, exactly).
* ``python -m deft_tpu_torch.train``'s ``main`` for 2 iterations, then
  ``deft_tpu_torch.test`` on the recipe's test line, which names the
  checkpoint without its suffix (``--load_model .../model_last``).
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_recipes import mot_dataset

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.datasets import get_dataset as jax_get_dataset
from deft_tpu.data.loader import DataLoader as JaxLoader
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu.train.trainer import (create_train_state, make_optimizer,
                                    make_train_step)
from deft_tpu_torch import checkpoint as port_checkpoint
from deft_tpu_torch import test as port_test
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.train import run as port_train
from deft_tpu_torch.train.checkpoint import load_train_state, save_checkpoint
from deft_tpu_torch.train.trainer import (Trainer, lr_at, to_device,
                                          training_keys)

ARGV = ["tracking", "--dataset", "mot", "--dataset_version", "17trainval",
        "--ltrb_amodal", "--same_aug_pre", "--hm_disturb", "0.05",
        "--lost_disturb", "0.4", "--fp_disturb", "0.1", "--input_h", "64",
        "--input_w", "96", "--max_object", "8", "--batch_size", "2",
        "--dla_node", "conv"]
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's models: the suite runs several
    test processes on one machine, and each one's default of a thread per
    core oversubscribes it (as ``test_torch_port_nuscenes.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return mot_dataset(tmp_path_factory.mktemp("mot"), frames=8,
                       size=(192, 128))


@pytest.fixture(scope="module")
def batches(data):
    """Two batches of the JAX loader (num_workers 1), the step's keys."""
    cfg, _ = jax_parse_config(ARGV)
    np.random.seed(0)
    random.seed(0)
    loader = JaxLoader(jax_get_dataset("mot")(cfg, "train",
                                              data_dir=str(data)),
                       cfg.batch_size, num_workers=1, seed=0)
    out = []
    for batch in loader:
        keys = training_keys(batch, cfg)
        out.append({k: batch[k] for k in keys})
        if len(out) == 2:
            return out


def _port_trainer(cfg, seed_weights=None):
    model = create_model(cfg.arch, cfg, "cpu")
    if seed_weights is not None:
        model.load_state_dict(seed_weights)
    return Trainer(model, cfg, STEPS_PER_EPOCH)


def test_one_adam_step_matches_jax(batches):
    jcfg, _ = jax_parse_config(ARGV)
    pcfg, _ = parse_config(ARGV)
    trainer = _port_trainer(pcfg)
    init = {k: v.detach().clone().numpy()
            for k, v in trainer.model.state_dict().items()}
    params, stats = TorchConverter(jcfg.dataset).convert_dla34(
        init, jcfg.heads, jcfg.dla_node, DLA_PLANS["34"][0])
    model = jax_create_model(jcfg.arch, jcfg)
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    state = create_train_state(model, jcfg, params, stats, STEPS_PER_EPOCH)
    new, want = make_train_step(model, jcfg, tx)(
        state, {k: jnp.asarray(v) for k, v in batches[0].items()})
    got = trainer.train_step(to_device(batches[0], list(batches[0]), "cpu"))

    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1.0), (k, got[k], w)

    lr = pcfg.lr
    port = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    grads = {n: p.grad.numpy() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    # the optimizer: optax.adam (make_optimizer's) on the port's gradients
    moved = optax.apply_updates(
        {n: init[n] for n in grads},
        tx.update(grads, tx.init({n: init[n] for n in grads}),
                  {n: init[n] for n in grads})[0])
    for n, p in trainer.model.named_parameters():
        want_p = np.asarray(moved[n]) if n in moved else init[n]
        np.testing.assert_allclose(port[n], want_p, rtol=2 ** -23,
                                   atol=1e-8, err_msg=n)

    # the step against make_train_step's
    jsd = from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, new.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)},
        jcfg)
    top = max(np.abs(g).max() for g in grads.values())
    flips = total = 0
    for key, value in port.items():
        if key.endswith("num_batches_tracked"):
            continue
        d = np.abs(value - jsd[key].numpy())
        if key in grads:
            g = np.abs(grads[key])
            assert d.max() <= 2 * lr + 1e-3 * lr, key
            if g.max() <= 1e-6 * top:
                # a bias that a train-mode BatchNorm follows: no gradient
                # but rounding, its steps are noise in both packages
                continue
            sure = g > 0.5 * g.max()
            assert d[sure].max(initial=0) <= 1e-3 * lr, key
            flipped = int((d > 1e-3 * lr).sum())
            assert flipped <= 0.15 * d.size, (key, flipped, d.size)
            flips += flipped
            total += d.size
        elif key in dict(trainer.model.named_parameters()):
            assert d.max() <= 1e-3 * lr, key   # no gradient: no update
        else:                                  # BatchNorm statistics
            assert d.max() <= 1e-4 * max(1.0, np.abs(value).max()), key
    assert flips <= 0.03 * total, (flips, total)
    assert abs(float(trainer.s_det) - float(new.s_det)) <= 1e-7
    assert abs(float(trainer.s_id) - float(new.s_id)) <= 1e-7
    assert abs(float(trainer.s_det) - (1.0 - lr)) <= 1e-7


def test_lr_schedule_steps_at_lr_step():
    cfg, _ = parse_config(ARGV + ["--lr", "0.01", "--lr_step", "2,3"])
    got = [lr_at(cfg, 5, s) for s in range(20)]
    assert got[:10] == [0.01] * 10
    assert all(abs(v - 1e-3) < 1e-12 for v in got[10:15])
    assert all(abs(v - 1e-4) < 1e-12 for v in got[15:])


def test_save_resume_step_equals_two_steps(batches, tmp_path):
    cfg, _ = parse_config(ARGV)
    b0, b1 = (to_device(b, list(b), "cpu") for b in batches)
    seed = create_model(cfg.arch, cfg, "cpu").state_dict()
    straight = _port_trainer(cfg, seed)
    straight.train_step(b0)
    want = straight.train_step(b1)

    first = _port_trainer(cfg, seed)
    first.train_step(b0)
    path = save_checkpoint(tmp_path / "model_last", first, epoch=1)
    assert path.endswith("model_last.pth")
    blob = torch.load(path, weights_only=True)
    assert {"epoch", "state_dict", "optimizer", "s_det", "s_id",
            "step"} <= set(blob)
    resumed = _port_trainer(cfg)
    assert load_train_state(str(tmp_path / "model_last"), resumed) == 1
    assert resumed.step == 1
    got = resumed.train_step(b1)
    assert got == want
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(resumed.s_det) == float(straight.s_det)


def test_checkpoint_path_without_suffix(tmp_path):
    """``--load_model <dir>/model_last`` names ``model_last.pth``; a path
    with neither form is refused with the same message as before."""
    torch.save({"epoch": 3, "state_dict": {"a": torch.ones(2)}},
               tmp_path / "model_last.pth")
    sd = port_checkpoint.load_torch_state_dict(str(tmp_path / "model_last"))
    assert list(sd) == ["a"]
    with pytest.raises(NotImplementedError, match="only reference PyTorch"):
        port_checkpoint.load_torch_state_dict(str(tmp_path / "model_first"))


def test_train_entry_then_test_line(data, tmp_path):
    """The recipe's train line (``--gpus -1``, 2 iterations, workers 0)
    writes ``model_last.pth``; the recipe's test line loads it as
    ``--load_model <exp>/tracking/<id>/model_last``."""
    exp = tmp_path / "exp"
    common = ["--gpus", "-1", "--data_dir", str(data.parent), "--exp_dir",
              str(exp), "--input_h", "64", "--input_w", "96",
              "--max_object", "8", "--exp_id", "mot17_train"]
    stats = {}
    port_train.main(["tracking", "--dataset", "mot", "--dataset_version",
                     "17trainval", "--ltrb_amodal", "--same_aug_pre",
                     "--hm_disturb", "0.05", "--lost_disturb", "0.4",
                     "--fp_disturb", "0.1", "--compute_dtype", "bfloat16",
                     "--batch_size", "2", "--num_epochs", "1",
                     "--num_iters", "2", "--num_workers", "0"] + common,
                    stats)
    assert len(stats["step_seconds"]) == 2 and stats["samples"] == 4
    assert all(np.isfinite(v) for v in stats["last"].values())
    save = exp / "tracking" / "mot17_train"
    assert (save / "model_last.pth").is_file()
    assert "epoch 1" in (save / "log.txt").read_text()
    metrics = port_test.main(
        ["tracking", "--dataset", "mot", "--dataset_version", "17halfval",
         "--ltrb_amodal", "--track_thresh", "0.4", "--pre_thresh", "0.5",
         "--load_model", str(save / "model_last"), "--compute_dtype",
         "bfloat16"] + common)
    assert "overall" in metrics
