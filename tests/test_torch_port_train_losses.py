"""The port's training losses and train-mode BatchNorm against the JAX
package, on the CPU.

* Every loss of ``deft_tpu_torch/train/losses.py`` on the same numpy inputs
  as ``deft_tpu/train/losses.py``: each head loss, ``afe_loss`` (its masked
  softmaxes over zeroed logits, the false row and column, the accuracies),
  ``generic_loss`` with every head and ``joint_loss``; float32 sums in
  another order, within 1e-5 relative (accuracies exactly).
* ``BatchNorm2d`` and the AFE's last-axis BatchNorm in train mode against
  flax's ``BatchNorm(use_running_average=False)``: the output within 1e-5,
  ``running_mean`` / ``running_var`` after one and after two calls within
  1e-6 (the biased variance, momentum 0.9 in flax's convention; torch's own
  update would take the unbiased one).
"""

from __future__ import annotations

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.train.losses as JL
import deft_tpu_torch.train.losses as PL
from deft_tpu.models.layers import BN_EPS, BN_MOMENTUM
from deft_tpu_torch.models.afe import _bn_last
from deft_tpu_torch.models.layers import batch_norm

B, H, W, M = 2, 8, 12, 6


def _batch(rng, heads):
    out = {"hm": rng.normal(0, 2, (B, H, W, 3)).astype(np.float32)}
    batch = {
        "hm": (rng.uniform(0, 1, (B, H, W, 3)) ** 6).astype(np.float32),
        "ind": rng.randint(0, H * W, (B, M)).astype(np.int32),
        "cat": rng.randint(0, 3, (B, M)).astype(np.int32),
        "mask": (rng.uniform(0, 1, (B, M)) < 0.6).astype(np.float32),
    }
    for head, d in heads.items():
        out[head] = rng.normal(0, 1, (B, H, W, d)).astype(np.float32)
        if head == "rot":
            batch["rotbin"] = rng.randint(0, 2, (B, M, 2)).astype(np.int32)
            batch["rotres"] = rng.normal(0, 1, (B, M, 2)).astype(np.float32)
            batch["rot_mask"] = batch["mask"].copy()
        else:
            batch[head] = rng.normal(0, 1, (B, M, d)).astype(np.float32)
            batch[f"{head}_mask"] = (rng.uniform(0, 1, (B, M, d)) < 0.5
                                     ).astype(np.float32)
    if "nuscenes_att" in heads:
        batch["nuscenes_att"] = (batch["nuscenes_att"] > 0).astype(np.float32)
    return out, batch


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0), (
        got, want)


HEADS = {"reg": 2, "wh": 2, "tracking": 2, "ltrb_amodal": 4, "dep": 1,
         "dim": 3, "amodel_offset": 2, "velocity": 3, "rot": 8,
         "nuscenes_att": 8}


def test_head_losses_match_jax():
    rng = np.random.RandomState(0)
    out, batch = _batch(rng, HEADS)
    pred = 1.0 / (1.0 + np.exp(-out["hm"]))
    pred = np.clip(pred, 1e-4, 1 - 1e-4).astype(np.float32)
    args = (pred, batch["hm"], batch["ind"], batch["mask"], batch["cat"])
    _close(PL.fast_focal_loss(*(torch.from_numpy(a) for a in args)),
           JL.fast_focal_loss(*(jnp.asarray(a) for a in args)))
    for head in ("reg", "ltrb_amodal", "velocity"):
        args = (out[head], batch[f"{head}_mask"], batch["ind"], batch[head])
        _close(PL.reg_weighted_l1_loss(*(torch.from_numpy(a) for a in args)),
               JL.reg_weighted_l1_loss(*(jnp.asarray(a) for a in args)))
    args = (out["nuscenes_att"], batch["nuscenes_att_mask"], batch["ind"],
            batch["nuscenes_att"])
    _close(PL.weighted_bce_loss(*(torch.from_numpy(a) for a in args)),
           JL.weighted_bce_loss(*(jnp.asarray(a) for a in args)))
    args = (out["rot"], batch["rot_mask"], batch["ind"], batch["rotbin"],
            batch["rotres"])
    _close(PL.bin_rot_loss(*(torch.from_numpy(a) for a in args)),
           JL.bin_rot_loss(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("heads", [
    {"reg": 2, "wh": 2, "tracking": 2, "ltrb_amodal": 4},    # MOT
    HEADS])
def test_generic_and_joint_loss_match_jax(heads):
    rng = np.random.RandomState(len(heads))
    out, batch = _batch(rng, heads)
    weights = {h: float(w) for h, w in zip(
        ["hm"] + list(heads), rng.uniform(0.1, 2, len(heads) + 1))}
    got = PL.generic_loss(_t(out), _t(batch), weights)
    want = JL.generic_loss(_j(out), _j(batch), weights)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    s_det, s_id = 0.7, 1.3
    _close(PL.joint_loss(got["tot"], torch.tensor(2.5), torch.tensor(s_det),
                         torch.tensor(s_id)),
           JL.joint_loss(want["tot"], 2.5, s_det, s_id))


@pytest.mark.parametrize("n_pre,n_next", [(4, 5), (0, 3), (6, 6)])
def test_afe_loss_matches_jax(n_pre, n_next):
    rng = np.random.RandomState(10 * n_pre + n_next)
    n = 6
    aff = np.abs(rng.normal(0, 2, (B, n + 1, n + 1))).astype(np.float32)
    aff[:, n, :] = 1.0
    aff[:, :, n] = 1.0
    target = np.zeros((B, n + 1, n + 1), np.float32)
    mask_pre = np.zeros((B, n + 1), np.float32)
    mask_next = np.zeros((B, n + 1), np.float32)
    for b in range(B):
        mask_pre[b, rng.permutation(n)[:n_pre]] = 1
        mask_next[b, rng.permutation(n)[:n_next]] = 1
        rows, cols = np.nonzero(mask_pre[b, :n])[0], np.nonzero(
            mask_next[b, :n])[0]
        for i, j in zip(rows[: len(cols) - 1], cols):
            target[b, i, j] = 1
        target[b, :n, n] = (target[b, :n, :n].sum(1) == 0) * mask_pre[b, :n]
        target[b, n, :n] = (target[b, :n, :n].sum(0) == 0) * mask_next[b, :n]
    mask_pre[:, n] = 1
    mask_next[:, n] = 1
    got = PL.afe_loss(*(torch.from_numpy(a) for a in
                        (aff, target, mask_pre, mask_next)))
    want = JL.afe_loss(*(jnp.asarray(a) for a in
                         (aff, target, mask_pre, mask_next)))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def _flax_bn(x, stats, calls):
    bn = fnn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM,
                       epsilon=BN_EPS)
    c = x[0].shape[-1]
    scale = jnp.asarray(np.linspace(0.5, 1.5, c), jnp.float32)
    bias = jnp.asarray(np.linspace(-0.2, 0.3, c), jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": stats}
    outs = []
    for xi in x[:calls]:
        y, upd = bn.apply(variables, jnp.asarray(xi), mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
        outs.append(np.asarray(y))
    return outs, variables["batch_stats"]


@pytest.mark.parametrize("calls", [1, 2])
@pytest.mark.parametrize("layout", ["nchw", "last"])
def test_batchnorm_train_statistics_match_flax(calls, layout):
    rng = np.random.RandomState(calls)
    c = 5
    xs = [rng.normal(1.5, 2.0, (2, 3, 3, c)).astype(np.float32)
          for _ in range(2)]
    stats = {"mean": jnp.asarray(rng.normal(0, 1, c), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32)}
    want, want_stats = _flax_bn(xs, stats, calls)
    bn = batch_norm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(np.linspace(0.5, 1.5, c)))
        bn.bias.copy_(torch.tensor(np.linspace(-0.2, 0.3, c)))
        bn.running_mean.copy_(torch.tensor(np.asarray(stats["mean"])))
        bn.running_var.copy_(torch.tensor(np.asarray(stats["var"])))
    bn.train()
    for xi, wi in zip(xs[:calls], want):
        xt = torch.from_numpy(xi)
        if layout == "nchw":
            y = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            y = _bn_last(xt, bn)
        np.testing.assert_allclose(y.detach().numpy(), wi, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_stats["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_stats["var"],
                               rtol=0, atol=1e-6)
    # torch's own update (the unbiased variance) is another number here
    unbiased = torch.nn.BatchNorm2d(c, momentum=0.1)
    unbiased.running_var.copy_(torch.tensor(np.asarray(stats["var"])))
    unbiased.train()(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    if calls == 1:
        assert np.abs(unbiased.running_var.numpy()
                      - want_stats["var"]).max() > 1e-3
