"""The LSTM motion model's trainer against the JAX package's, on the CPU.

* ``DecoderRNN.forward`` (the training rollout) against flax's
  ``DecoderRNN.__call__`` on the JAX weights through
  ``from_jax_motion_variables``: within 1e-5 (float32 products in another
  order), 2-D and 3-D, at several lengths.
* ``init_decoder`` draws flax's initialization: lecun-normal input kernels,
  orthogonal recurrent kernels per gate, zero biases.
* 12 steps of ``train_motion_model`` (2 epochs of 6, ``--lr_step 1``: the
  learning rate drops x0.1 before the 7th update) from the JAX init against
  ``deft_tpu.train.prediction.train_motion_model``, both from the same
  ``random`` / ``np.random`` seeds over the same trajectories: every loss
  and every parameter within 1e-5 relative (float32 through 12 Adam updates;
  ``torch.optim.Adam`` and ``optax.adam`` round differently).
* The loss scale: the gradient of a step whose loss is below 0.2 carries
  x100 and of one above it x10, in both packages (within 1e-5 relative of
  each other).
* The ``.pth`` round trip: ``model_last.pth`` loads strictly through
  ``cfg.load_model_traj`` into the detector's motion model, bit for bit;
  ``python -m deft_tpu_torch.train_prediction``'s ``main`` with ``--gpus
  -1``, and without it on a machine with no card, where it raises.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_trajectory import mot_train_json, nuscenes_train_json

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.trajectory_dataset import (
    TrajectoryDataset as JaxTrajectoryDataset)
from deft_tpu.tracking.motion_lstm import DecoderRNN as JaxDecoderRNN
from deft_tpu.train.prediction import make_lstm_train_step
from deft_tpu.train.prediction import train_motion_model as jax_train
from deft_tpu_torch import train_prediction
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.convert import from_jax_motion_variables
from deft_tpu_torch.data.datasets import get_dataset
from deft_tpu_torch.tracking.motion_lstm import (DecoderRNN, init_decoder,
                                                 motion_feature_dim)
from deft_tpu_torch.train.prediction import (scaled_loss, smooth_l1,
                                             train_motion_model)

ARGV = {"mot": ["tracking", "--dataset", "mot", "--dataset_version",
                "17trainval", "--lr", "1e-3", "--lr_step", "1"],
        "nuscenes": ["tracking,ddd", "--dataset", "nuscenes", "--lr",
                     "1e-3", "--lr_step", "1"]}
STEPS_PER_EPOCH = 6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ann_paths(tmp_path_factory):
    return {"mot": mot_train_json(tmp_path_factory.mktemp("mot")),
            "nuscenes": nuscenes_train_json(tmp_path_factory.mktemp("ns"))}


def jax_variables(dataset: str, seed: int = 0):
    """The JAX trainer's init (``train_motion_model``'s ``model.init``), as
    numpy copies (the jitted step donates its inputs' buffers)."""
    model = JaxDecoderRNN(dataset=dataset)
    dummy = jnp.zeros((1, 5, motion_feature_dim(dataset)))
    return jax.tree.map(np.array,
                        model.init(jax.random.PRNGKey(seed), dummy))


def port_model(variables, dataset) -> DecoderRNN:
    model = DecoderRNN(dataset)
    model.load_state_dict(from_jax_motion_variables(variables))
    return model


@pytest.mark.parametrize("dataset", ["mot", "nuscenes"])
@pytest.mark.parametrize("length", [1, 4, 11])
def test_forward_matches_flax(dataset, length):
    variables = jax_variables(dataset, seed=length)
    rng = np.random.RandomState(length)
    traj = rng.normal(0, 3, (2, length, motion_feature_dim(dataset))
                      ).astype(np.float32)
    want = np.asarray(JaxDecoderRNN(dataset=dataset).apply(
        variables, jnp.asarray(traj)))
    with torch.no_grad():
        got = port_model(variables, dataset)(torch.from_numpy(traj)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_decoder_scheme():
    a, b = init_decoder("nuscenes", 3), init_decoder("nuscenes", 3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.out1.weight, init_decoder("nuscenes", 4).out1.weight)
    lstm = a.lstm
    h = lstm.hidden_size
    for g in range(4):
        w = lstm.weight_hh_l0[g * h:(g + 1) * h].detach()
        assert torch.allclose(w @ w.T, torch.eye(h), atol=1e-5)
        ih = lstm.weight_ih_l0[g * h:(g + 1) * h].detach()
        bound = 2 * (1.0 / ih.shape[1]) ** 0.5 / 0.87962566103423978
        assert ih.abs().max() <= bound + 1e-6
    assert abs(float(lstm.weight_ih_l0.detach().std()) * 18 ** 0.5 - 1.0) < 0.05
    for t in (lstm.bias_ih_l0, lstm.bias_hh_l0, a.out1.bias, a.out2.bias):
        assert not t.any()
    # the JAX init's leaves have the same scales
    v = jax_variables("nuscenes")["params"]
    assert abs(float(np.std(v["cell"]["ii"]["kernel"])) * 18 ** 0.5
               - 1.0) < 0.1


def jax_steps(cfg, ann_path, variables, dtype):
    """The JAX trainer's loop (``train_motion_model``: its schedule,
    ``optax.adam``, its jitted ``make_lstm_train_step``) over 2 epochs of
    ``STEPS_PER_EPOCH`` from ``variables`` in ``dtype``, from seed 11:
    (params, losses)."""
    random.seed(11)
    np.random.seed(11)
    ds = JaxTrajectoryDataset(cfg, "train", ann_path)
    sched = optax.piecewise_constant_schedule(
        cfg.lr, {int(e) * STEPS_PER_EPOCH: 0.1 for e in cfg.lr_step})
    tx = optax.adam(sched)
    params = jax.tree.map(lambda a: jnp.array(a, dtype), variables["params"])
    opt_state = tx.init(params)
    step = make_lstm_train_step(JaxDecoderRNN(dataset=cfg.dataset), tx)
    losses = []
    for _ in range(2):
        for idx in np.random.permutation(len(ds))[:STEPS_PER_EPOCH]:
            traj, target = ds[int(idx)]
            params, opt_state, loss = step(params, opt_state,
                                           jnp.asarray(traj)[None],
                                           jnp.asarray(target)[None])
            losses.append(float(loss))
    return jax.tree.map(np.array, params), losses


def port_steps(cfg, ann_path, variables, dtype):
    """``train_motion_model`` over the same draws: (model, stats)."""
    random.seed(11)
    np.random.seed(11)
    stats = {}
    model = train_motion_model(
        cfg, get_dataset(cfg.dataset, prediction_model=True)(
            cfg, "train", ann_path),
        num_epochs=2, steps_per_epoch=STEPS_PER_EPOCH,
        model=port_model(variables, cfg.dataset).to(dtype), stats=stats)
    return model, stats


@pytest.mark.parametrize("dataset", ["mot", "nuscenes"])
def test_training_matches_jax(ann_paths, dataset):
    """float32, against ``deft_tpu.train.prediction.train_motion_model``
    itself.  The features' raw pixel and metre coordinates (up to ~150)
    saturate LSTM gates, so some weights' gradients are sums that cancel to
    ~1e-3 of their terms; the two packages round them differently in the
    last bits, and Adam, which divides each gradient by its own running
    size, turns that into updates that differ by up to one update (lr) on a
    few elements, which then feed the later losses.  So here: every loss
    within 1e-3 relative (1.1e-4 seen); every parameter's change from the
    init within 2 x lr x 12 steps of the JAX change, and within 1% of the
    tensor's largest JAX change on 97% of its elements.  ``test_training_matches_jax_float64`` holds every loss
    and parameter to 1e-5 relative with the rounding gone."""
    jcfg, _ = jax_parse_config(ARGV[dataset])
    pcfg, _ = parse_config(ARGV[dataset])
    variables = jax_variables(dataset, jcfg.seed)

    random.seed(11)
    np.random.seed(11)
    want = jax_train(jcfg, JaxTrajectoryDataset(jcfg, "train",
                                                ann_paths[dataset]),
                     num_epochs=2, steps_per_epoch=STEPS_PER_EPOCH)
    # the JAX trainer keeps its losses to itself: its loop again for them
    again, want_losses = jax_steps(jcfg, ann_paths[dataset], variables,
                                   jnp.float32)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    got, stats = port_steps(pcfg, ann_paths[dataset], variables,
                            torch.float32)

    assert len(stats["losses"]) == 2 * STEPS_PER_EPOCH
    assert len(set(stats["lengths"])) > 1
    np.testing.assert_allclose(stats["losses"], want_losses, rtol=1e-3)
    want_sd = from_jax_motion_variables(jax.tree.map(np.array, want))
    init_sd = from_jax_motion_variables(variables)
    for k, v in got.state_dict().items():
        if k == "lstm.bias_ih_l0":
            continue
        moved = want_sd[k].numpy() - init_sd[k].numpy()
        d = np.abs(v.numpy() - want_sd[k].numpy())
        assert np.abs(moved).max() > 0.5 * pcfg.lr, k
        assert d.max() <= 2 * pcfg.lr * 12, k
        close = d <= 0.01 * np.abs(moved).max()
        assert close.mean() >= 0.97, (k, close.mean())
    assert not got.lstm.bias_ih_l0.any()


@pytest.mark.parametrize("dataset", ["mot", "nuscenes"])
def test_training_matches_jax_float64(ann_paths, dataset):
    """The same 12 steps in float64 (the JAX package's loop and step with
    x64 on, the port's trainer on a float64 model), where the rounding that
    Adam amplifies is gone: every loss and every parameter within 1e-5
    relative (1e-9 absolute near zero), across the learning-rate drop."""
    jcfg, _ = jax_parse_config(ARGV[dataset])
    pcfg, _ = parse_config(ARGV[dataset])
    variables = jax_variables(dataset, jcfg.seed)
    with jax.enable_x64(True):
        want, want_losses = jax_steps(jcfg, ann_paths[dataset], variables,
                                      jnp.float64)
    got, stats = port_steps(pcfg, ann_paths[dataset], variables,
                            torch.float64)
    np.testing.assert_allclose(stats["losses"], want_losses, rtol=1e-5)
    want_sd = from_jax_motion_variables({"params": want})
    for k, v in got.state_dict().items():
        assert v.dtype == torch.float64
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy().astype(
            np.float64), rtol=1e-5, atol=1e-9, err_msg=k)
    # without the drop at update 7 the run ends elsewhere
    flat = pcfg.replace(lr_step=(100,))
    undecayed, _ = port_steps(flat, ann_paths[dataset], variables,
                              torch.float64)
    assert not torch.allclose(undecayed.out2.weight, got.out2.weight,
                              rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("branch", ["x100", "x10"])
def test_loss_scale_branches(branch):
    """One step's gradient under each branch of the scale, port against
    JAX (``make_lstm_train_step`` with plain SGD at lr 1: the update is
    minus the gradient)."""
    dataset = "mot"
    variables = jax_variables(dataset, 5)
    rng = np.random.RandomState(5)
    traj = rng.normal(0, 1, (1, 6, 11)).astype(np.float32)
    model = port_model(variables, dataset)
    with torch.no_grad():
        out = model(torch.from_numpy(traj)).numpy()
    # below 0.2 the loss is magnified x100, above it x10
    offset = 0.05 if branch == "x100" else 5.0
    target = (out + offset).astype(np.float32)
    loss = smooth_l1(model(torch.from_numpy(traj)).reshape(1, -1),
                     torch.from_numpy(target).reshape(1, -1))
    scaled = scaled_loss(loss)
    factor = 100.0 if branch == "x100" else 10.0
    assert float(scaled) == pytest.approx(factor * float(loss), rel=1e-6)
    scaled.backward()

    params = jax.tree.map(jnp.array, variables["params"])
    tx = optax.sgd(1.0)
    new, _, jloss = make_lstm_train_step(JaxDecoderRNN(dataset=dataset), tx)(
        params, tx.init(params), jnp.asarray(traj), jnp.asarray(target))
    assert float(jloss) == pytest.approx(float(scaled), rel=1e-5)
    moved = from_jax_motion_variables(
        {"params": jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                variables["params"], new)})
    grads = {n: p.grad for n, p in model.named_parameters()}
    for k, g in moved.items():
        if k == "lstm.bias_ih_l0":
            continue
        want = g.numpy()
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_checkpoint_loads_through_load_model_traj(ann_paths, tmp_path):
    """``model_last.pth`` is ``{"epoch", "state_dict"}`` under the
    reference keys, and ``--load_model_traj`` loads it strictly into the
    nuScenes detector's motion model."""
    from deft_tpu_torch.inference.detector import Detector

    pcfg, _ = parse_config(ARGV["nuscenes"])
    random.seed(2)
    np.random.seed(2)
    stats = {}
    model = train_motion_model(
        pcfg, get_dataset("nuscenes", prediction_model=True)(
            pcfg, "train", ann_paths["nuscenes"]),
        num_epochs=1, steps_per_epoch=3, save_dir=str(tmp_path),
        device="cpu", stats=stats)
    path = tmp_path / "model_last.pth"
    assert stats["checkpoint"] == str(path)
    blob = torch.load(path, weights_only=True)
    assert blob["epoch"] == 1
    assert sorted(blob["state_dict"]) == sorted(DecoderRNN("nuscenes")
                                                .state_dict())
    cfg, _ = parse_config(["tracking,ddd", "--dataset", "nuscenes",
                           "--input_h", "64", "--input_w", "112",
                           "--dla_node", "conv", "--load_model_traj",
                           str(tmp_path / "model_last")])
    det = Detector(cfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(det.motion.model.state_dict()[k], v), k
    bad = dict(blob["state_dict"], extra=torch.zeros(1))
    torch.save({"epoch": 1, "state_dict": bad}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="extra"):
        Detector(cfg.replace(load_model_traj=str(tmp_path / "bad.pth")),
                 device="cpu")


def test_entry_point(ann_paths, tmp_path, monkeypatch):
    """The MOT recipe's ``train_prediction.py`` line with ``--gpus -1`` in a
    directory whose ``data/mot17`` holds the trajectories; one epoch takes
    one step per trajectory and writes ``model_last.pth``."""
    import shutil
    from pathlib import Path

    from recipe_lines import recipe_lines

    (argv,) = [a for (r, script, _), a in recipe_lines().items()
               if r == "mot" and script == "train_prediction.py"]
    ann = tmp_path / "data" / "mot17" / "annotations"
    ann.mkdir(parents=True)
    shutil.copy(ann_paths["mot"], ann / "train.json")
    monkeypatch.chdir(tmp_path)
    stats = {}
    random.seed(0)
    np.random.seed(0)
    model = train_prediction.main(argv + ["--num_epochs", "1", "--gpus", "-1",
                                          "--data_dir", "ignored"], stats)
    assert len(stats["losses"]) == stats["trajectories"] == 24
    assert all(np.isfinite(stats["losses"]))
    save = Path("exp") / "tracking" / "mot17_motion_model"
    assert stats["checkpoint"] == str(save / "model_last.pth")
    assert "motion epoch 1" in (save / "log.txt").read_text()
    fresh = DecoderRNN("mot")
    fresh.load_state_dict(torch.load(stats["checkpoint"],
                                     weights_only=True)["state_dict"])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v.cpu()), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_prediction.main(argv + ["--num_epochs", "1"])
