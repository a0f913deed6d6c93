"""The KITTI and nuScenes recipes' train lines through the port against the
JAX package, on the CPU.

The train flags of ``experiments/kitti_tracking.sh`` (``--dataset_version
train --same_aug_pre --hm_disturb 0.05 --lost_disturb 0.2 --fp_disturb
0.1``, three classes) and ``experiments/nuScenes_3Dtracking.sh``
(``tracking,ddd --nuscenes_att --velocity --shift 0.01 --scale 0.05
--lost_disturb 0.4 --fp_disturb 0.1 --hm_disturb 0.05 --lr 2.5e-4``: the
``dep``, ``rot``, ``dim``, ``amodel_offset``, ``velocity`` and
``nuscenes_att`` heads) at a small input, ``max_object`` 40 (above the boxes of a frame, as the
AFE pairing needs), batch 2, on the
PNG layouts ``chip_smoke.py`` trains on (``torch_port_layouts.py``: 12
KITTI frames of 128x416 with cars, pedestrians and cyclists, 3 nuScenes
samples x 2 cameras of 90x160).

* Both packages' datasets and loaders (``num_workers`` 1) from the same
  seeds give every target equal, bit for bit, and the images within the
  warp's one uint8 step carried through colour augmentation and
  normalization (``test_torch_port_train_data.py``'s bound).
* One Adam step (here KITTI's; nuScenes' in
  ``test_torch_port_train_kitti_nuscenes_step.py``) at ``--dla_node conv``
  and float32 (KITTI 64x96,
  nuScenes 64x128: DLA-34 needs a width divisible by 32) on
  the same weights and batch, held to ``test_torch_port_train_step.py``'s
  criteria: the loss statistics within 1e-4 relative, the update equal to
  ``optax.adam`` on the port's gradients up to one float32 rounding, every
  parameter's update within 2 x lr of the JAX step's and within 1e-3 x lr
  where the gradient is above half its tensor's largest, more than that
  apart on at most 15% of a tensor and 3% of all, the BatchNorm statistics
  within 1e-4 relative.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_layouts import layout_kitti, layout_nuscenes_train
from test_torch_port_train_data import IMAGE_BOUND, IMAGES

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.datasets import get_dataset as jax_get_dataset
from deft_tpu.data.loader import DataLoader as JaxLoader
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu.train.trainer import (create_train_state, make_optimizer,
                                    make_train_step)
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.data.datasets import get_dataset
from deft_tpu_torch.data.loader import DataLoader
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.train.trainer import Trainer, to_device, training_keys

from recipe_lines import recipe_lines, with_flags

BATCHES = 3
STEPS_PER_EPOCH = 10
INPUT = {"kitti": (64, 96), "nuscenes": (64, 128)}
KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


def train_argv(recipe, **flags):
    """The recipe's ``train.py`` argv at the test's size."""
    (argv,) = [a for (r, script, _), a in recipe_lines().items()
               if r == recipe and script == "train.py"]
    h, w = INPUT[recipe]
    return with_flags(argv, input_h=h, input_w=w, max_object=40,
                      batch_size=2, **flags)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    return {"kitti": layout_kitti(root, 12, (128, 416), seed=4,
                                  classes=KITTI_CLASSES),
            "nuscenes": layout_nuscenes_train(root, 3, (90, 160), seed=3,
                                              cameras=2)}


def _batches(make, get, cfg, data, seed, n=BATCHES, keys=None):
    np.random.seed(seed)
    random.seed(seed)
    ds = get(cfg.dataset)(cfg, "train", data_dir=str(data))
    loader = make(ds, cfg.batch_size, num_workers=1, seed=cfg.seed)
    out = []
    for batch in loader:
        out.append({k: batch[k] for k in (keys or training_keys(batch, cfg))}
                   if keys is not False else batch)
        if len(out) == n:
            break
    return out


@pytest.fixture(scope="module")
def batches(data):
    out = {}
    for recipe in ("kitti", "nuscenes"):
        jcfg, _ = jax_parse_config(train_argv(recipe))
        pcfg, _ = parse_config(train_argv(recipe))
        want = _batches(JaxLoader, jax_get_dataset, jcfg, data[recipe], 5,
                        keys=False)
        got = _batches(DataLoader, get_dataset, pcfg, data[recipe], 5,
                       keys=False)
        out[recipe] = (want, got)
    return out


@pytest.mark.parametrize("recipe", ["kitti", "nuscenes"])
def test_batch_keys_and_shapes(batches, recipe):
    want, got = batches[recipe]
    assert len(want) == len(got) == BATCHES
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    heads = {"kitti": {"hm", "reg", "wh", "tracking"},
             "nuscenes": {"hm", "reg", "wh", "tracking", "dep", "rotbin",
                          "dim", "amodel_offset", "velocity",
                          "nuscenes_att"}}[recipe]
    assert heads <= set(want[0])


@pytest.mark.parametrize("recipe", ["kitti", "nuscenes"])
def test_targets_equal(batches, recipe):
    """Every key but the images equal, bit for bit; the targets are not
    empty."""
    want, got = batches[recipe]
    for w, g in zip(want, got):
        for k in w:
            if k not in IMAGES:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert sum(w["mask"].sum() for w in want) > 0
    if recipe == "kitti":
        # more than one of the three classes has targets
        cats = np.concatenate([w["cat"][w["mask"] > 0] for w in want])
        assert len(set(cats.tolist())) > 1
    else:
        assert sum(w["dep_mask"].sum() for w in want) > 0
        assert sum(w["nuscenes_att_mask"].sum() for w in want) > 0


@pytest.mark.parametrize("recipe", ["kitti", "nuscenes"])
@pytest.mark.parametrize("key", IMAGES)
def test_images_within_one_warp_step(batches, recipe, key):
    want, got = batches[recipe]
    for w, g in zip(want, got):
        err = np.abs(g[key] - w[key])
        assert err.max() <= IMAGE_BOUND, (key, err.max())
        assert (err > 1e-5).mean() < 0.05, key


def test_one_adam_step_matches_jax(data):
    """KITTI; nuScenes' step is in
    ``test_torch_port_train_kitti_nuscenes_step.py`` (each JAX step
    compiles for ~35 s)."""
    adam_step_check(data, "kitti")


def adam_step_check(data, recipe):
    argv = train_argv(recipe, dla_node="conv", compute_dtype="float32")
    jcfg, _ = jax_parse_config(argv)
    pcfg, _ = parse_config(argv)
    (batch,) = _batches(JaxLoader, jax_get_dataset, jcfg, data[recipe], 0,
                        n=1)

    model = create_model(pcfg.arch, pcfg, "cpu")
    trainer = Trainer(model, pcfg, STEPS_PER_EPOCH)
    init = {k: v.detach().clone().numpy()
            for k, v in trainer.model.state_dict().items()}
    params, stats = TorchConverter(jcfg.dataset).convert_dla34(
        init, jcfg.heads, jcfg.dla_node, DLA_PLANS["34"][0])
    jmodel = jax_create_model(jcfg.arch, jcfg)
    tx = make_optimizer(jcfg, STEPS_PER_EPOCH)
    state = create_train_state(jmodel, jcfg, params, stats, STEPS_PER_EPOCH)
    new, want = make_train_step(jmodel, jcfg, tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = trainer.train_step(to_device(batch, list(batch), "cpu"))

    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        assert np.isfinite(got[k]), k
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1.0), (k, got[k], w)

    lr = pcfg.lr
    port = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    grads = {n: p.grad.numpy() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    moved = optax.apply_updates(
        {n: init[n] for n in grads},
        tx.update(grads, tx.init({n: init[n] for n in grads}),
                  {n: init[n] for n in grads})[0])
    for n, p in trainer.model.named_parameters():
        want_p = np.asarray(moved[n]) if n in moved else init[n]
        np.testing.assert_allclose(port[n], want_p, rtol=2 ** -23,
                                   atol=1e-8, err_msg=n)

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
                continue
            sure = g > 0.5 * g.max()
            assert d[sure].max(initial=0) <= 1e-3 * lr, key
            flipped = int((d > 1e-3 * lr).sum())
            assert flipped <= 0.15 * d.size, (key, flipped, d.size)
            flips += flipped
            total += d.size
        elif key in dict(trainer.model.named_parameters()):
            assert d.max() <= 1e-3 * lr, key
        else:
            assert d.max() <= 1e-4 * max(1.0, np.abs(value).max()), key
    assert flips <= 0.03 * total, (flips, total)
    assert abs(float(trainer.s_det) - float(new.s_det)) <= 1e-7
    assert abs(float(trainer.s_id) - float(new.s_id)) <= 1e-7
