"""T5, the backward of the DCNv2 sampling, on the CPU: its plain version
(``cuda_dcn.deform_sample_backward_reference``, which the wrapper runs for
CPU tensors) against the JAX package and the pre-port reference.

* Away from integer sampling positions, the port's conv through
  ``trainable(sampler)`` and ``addmm`` has the gradients of ``jax.vjp`` of
  ``deform_conv_onehot`` (x, offsets, mask, weight, bias): on a float32 x
  with T1's function within 1e-4 x max|grad| (float32 sums in another
  order); on a bfloat16 x with T4's function (``deform_conv_rounded``)
  within 2^-5 x max|grad| (both round patches, weight and output to
  bfloat16; the hat weights round in T4's function only).
* At zero offsets every position is an integer one.  The port gives DCNv2's
  one-sided difference m * sum_c g (v(p + 1) - v(p)) per axis, the same as
  autograd of ``tests/torch_dcn_ref.py`` (the pre-port DCNv2 with the
  reference kernel's floor-based corners); JAX gives
  m * sum_c g (v(p + 1) - v(p - 1)) / 2 -/+ m * sum_c g v(p), minus on the
  vertical axis and plus on the horizontal one: the subgradients of
  ``jnp.abs`` and ``jnp.maximum`` at their kinks (ROADMAP.md, C.3).
* ``torch.autograd.gradcheck`` (float64) of the sampling with T5's plain
  version as its backward, away from kinks.
* ``DeformNode`` in train mode (batch statistics, flax's updates) against
  the JAX node's ``jax.grad``, every parameter and the input.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dcn_ref import _modulated_deform_conv

from deft_tpu.models.dla import DeformNode as JaxDeformNode
from deft_tpu.ops.pallas_dcn import deform_conv_onehot
from deft_tpu_torch.convert import _Inverse
from deft_tpu_torch.models.dla import DeformNode
from deft_tpu_torch.ops import cuda_dcn

SHAPES = [(7, 9, 5, 6), (10, 8, 12, 4)]      # H, W, C, Cout


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's models: the suite runs several
    test processes on one machine, and each one's default of a thread per
    core oversubscribes it (as ``test_torch_port_nuscenes.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _problem(h, w, c, cout, radius, seed, offsets=True):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    if offsets:
        # past the clamp too, never on an integer position
        off = rng.uniform(-radius - 1.5, radius + 1.5, (h, w, 9, 2))
        off = np.where(np.abs(off - np.round(off)) < 0.05, off + 0.1, off)
    else:
        off = np.zeros((h, w, 9, 2))
    mask = rng.uniform(0.1, 1, (h, w, 9)).astype(np.float32)
    wt = rng.normal(0, 0.3, (9 * c, cout)).astype(np.float32)
    b = rng.normal(0, 1, cout).astype(np.float32)
    g = rng.normal(0, 1, (h, w, cout)).astype(np.float32)
    return x, off.astype(np.float32), mask, wt, b, g


def _port_grads(x, off, mask, wt, b, g, radius, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    xt = torch.tensor(x).to(dt).requires_grad_()
    rest = [torch.tensor(a, requires_grad=True) for a in (off, mask, wt, b)]
    if bf16:
        out = cuda_dcn.deform_conv_rounded(
            cuda_dcn.trainable(cuda_dcn.deform_sample_onehot), xt, *rest,
            radius)
    else:
        out = cuda_dcn.deform_conv(
            xt, *rest, radius,
            sample=cuda_dcn.trainable(cuda_dcn.deform_sample))
    out.backward(torch.tensor(g).to(out.dtype))
    return [t.grad.float().numpy() for t in [xt] + rest]


def _jax_grads(x, off, mask, wt, b, g, radius, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    args = (jnp.asarray(x, dt), jnp.asarray(off), jnp.asarray(mask),
            jnp.asarray(wt, dt), jnp.asarray(b))
    out, vjp = jax.vjp(lambda *a: deform_conv_onehot(*a, radius=radius),
                       *args)
    return [np.asarray(v, np.float32)
            for v in vjp(jnp.asarray(g, out.dtype))]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("h,w,c,cout", SHAPES)
def test_plain_matches_jax_vjp(h, w, c, cout, radius, bf16):
    prob = _problem(h, w, c, cout, radius, seed=h + c + radius)
    got = _port_grads(*prob, radius, bf16)
    want = _jax_grads(*prob, radius, bf16)
    rel = 2.0 ** -5 if bf16 else 1e-4
    for name, a, b in zip(("x", "offsets", "mask", "weight", "bias"), got,
                          want):
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(),
                                                    scale)
    # the clamp's gradient: offsets past +-radius get none
    off = prob[1]
    assert np.all(got[1][np.abs(off) > radius] == 0)


def _one_sided(x, g, mask):
    """m * sum_c g (v(p+1) - v(p)) per axis at zero offsets, and JAX's
    central difference -/+ v(p), from the padded input (zeros outside)."""
    h, w, c = x.shape
    xp = np.pad(x, ((2, 2), (2, 2), (0, 0)))
    gk = g.reshape(h, w, 9, c)
    port = np.zeros((h, w, 9, 2), np.float64)
    jax_rule = np.zeros((h, w, 9, 2), np.float64)
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        def v(dy, dx):
            y, x = 2 + ky + dy, 2 + kx + dx
            return xp[y: y + h, x: x + w]
        v0 = v(0, 0)
        for axis, (p1, m1) in enumerate((((1, 0), (-1, 0)),
                                         ((0, 1), (0, -1)))):
            vp, vm = v(*p1), v(*m1)
            sign = -1.0 if axis == 0 else 1.0
            port[:, :, k, axis] = (gk[:, :, k] * (vp - v0)).sum(-1)
            jax_rule[:, :, k, axis] = (gk[:, :, k] * (0.5 * (vp - vm)
                                                      + sign * v0)).sum(-1)
    return port * mask[..., None], jax_rule * mask[..., None]


@pytest.mark.parametrize("h,w,c,cout", SHAPES)
def test_zero_offsets_one_sided(h, w, c, cout):
    x, off, mask, _, _, _ = _problem(h, w, c, cout, 2, seed=40 + c,
                                     offsets=False)
    rng = np.random.RandomState(41 + c)
    g = rng.normal(0, 1, (h * w, 9 * c)).astype(np.float32)
    port_rule, jax_rule = _one_sided(x, g, mask)
    # the port's plain version
    _, doff, _ = cuda_dcn.deform_sample_backward_reference(
        torch.tensor(g), torch.tensor(x), torch.tensor(off),
        torch.tensor(mask), 2)
    np.testing.assert_allclose(doff.numpy(), port_rule, rtol=0,
                               atol=1e-4 * np.abs(port_rule).max())
    # autograd of the pre-port reference DCNv2 (identity weight: out =
    # patches)
    xt = torch.tensor(x).permute(2, 0, 1)[None].double()
    o = torch.zeros((1, 18, h, w), dtype=torch.float64, requires_grad=True)
    mt = torch.tensor(mask).permute(2, 0, 1)[None].double()
    eye = torch.zeros((9 * c, c, 3, 3), dtype=torch.float64)
    for k in range(9):
        eye[k * c: (k + 1) * c, :, k // 3, k % 3] = torch.eye(c)
    zero = torch.zeros(9 * c, dtype=torch.float64)
    y = _modulated_deform_conv(xt, o, mt, eye, zero, 1, 1, 1)
    y.backward(torch.tensor(g).double().reshape(h, w, 9 * c).permute(2, 0, 1)
               [None])
    ref = o.grad[0].reshape(9, 2, h, w).permute(2, 3, 0, 1).numpy()
    np.testing.assert_allclose(doff.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    # JAX: the central difference -/+ v(p) (identity weight, zero bias)
    eye_w = np.eye(9 * c, dtype=np.float32)
    _, vjp = jax.vjp(lambda o_: deform_conv_onehot(
        jnp.asarray(x), o_, jnp.asarray(mask), jnp.asarray(eye_w),
        jnp.zeros(9 * c), radius=2), jnp.asarray(off))
    (jdoff,) = vjp(jnp.asarray(g.reshape(h, w, 9 * c)))
    np.testing.assert_allclose(np.asarray(jdoff), jax_rule, rtol=0,
                               atol=1e-4 * np.abs(jax_rule).max())
    assert np.abs(port_rule - jax_rule).max() > 0.1 * np.abs(port_rule).max()


def _sample64(x, off, mask, radius):
    """The float64 sampling of ``torch_dcn_ref`` (identity weight), in the
    port's layouts: x [H, W, C], off [H, W, 9, 2], mask [H, W, 9] ->
    [H*W, 9*C]."""
    h, w, c = x.shape
    eye = torch.zeros((9 * c, c, 3, 3), dtype=torch.float64)
    for k in range(9):
        eye[k * c: (k + 1) * c, :, k // 3, k % 3] = torch.eye(c)
    y = _modulated_deform_conv(
        x.permute(2, 0, 1)[None], off.reshape(h, w, 18).permute(2, 0, 1)[None],
        mask.permute(2, 0, 1)[None], eye,
        torch.zeros(9 * c, dtype=torch.float64), 1, 1, 1)
    return y[0].permute(1, 2, 0).reshape(h * w, 9 * c)


class _Plain(torch.autograd.Function):
    """The float64 sampling with T5's plain version as its backward (the
    wrapper takes float32 and bfloat16 only)."""

    @staticmethod
    def forward(ctx, x, off, mask, radius):
        ctx.save_for_backward(x, off, mask)
        ctx.radius = radius
        return _sample64(x, off, mask, radius)

    @staticmethod
    def backward(ctx, g):
        x, off, mask = ctx.saved_tensors
        return (*cuda_dcn.deform_sample_backward_reference(
            g, x, off, mask, ctx.radius), None)


def test_gradcheck_float64():
    rng = np.random.RandomState(7)
    h, w, c, radius = 4, 5, 2, 2
    x = torch.tensor(rng.normal(0, 1, (h, w, c)), requires_grad=True)
    off = rng.uniform(-1.8, 1.8, (h, w, 9, 2))
    off = np.where(np.abs(off - np.round(off)) < 0.1, off + 0.25, off)
    off = torch.tensor(off, requires_grad=True)
    mask = torch.tensor(rng.uniform(0.1, 1, (h, w, 9)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, o, m: _Plain.apply(a, o, m, radius),
        (x, off, mask), eps=1e-6, atol=1e-5)


def test_deform_node_train_grads_match_jax():
    """``DeformNode`` (8 -> 8 channels, 10x12, radius 2, batch 2, offset
    conv random) in train mode against the JAX node's ``jax.grad`` with
    ``train=True``: every parameter's gradient within 1e-4 x the largest
    gradient of any parameter (the DCN bias's is zero up to rounding: a
    shift before a train-mode BatchNorm), the input's within 1e-4 x its
    max, the BatchNorm's running statistics after the step within 1e-6
    (flax's biased variance)."""
    rng = np.random.RandomState(11)
    cin = cout = 8
    x = rng.normal(0, 1, (2, 10, 12, cin)).astype(np.float32)
    g = rng.normal(0, 1, (2, 10, 12, cout)).astype(np.float32)
    node = JaxDeformNode(cout, dcn_impl="hybrid", dcn_offset_range=2)
    variables = node.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.3, a.shape), jnp.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])

    def loss(p, xx):
        out, upd = node.apply({"params": p, "batch_stats": stats}, xx,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), upd

    (_, upd), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params,
                                                          jnp.asarray(x))

    def torch_sd(tree):
        inv = _Inverse(jax.tree_util.tree_map(np.asarray, tree),
                       jax.tree_util.tree_map(np.asarray, stats))
        inv.node((), "n", "dcn")
        return {k[2:]: v for k, v in inv.sd.items()}

    port = DeformNode(cin, cout, 2, "hybrid")
    port.load_state_dict(torch_sd(params))
    port.train()
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    out = port(xt)
    out.backward(torch.tensor(g).permute(0, 3, 1, 2))
    want = torch_sd(gp)
    scale = max(np.abs(want[name].numpy()).max()
                for name, _ in port.named_parameters())
    for name, p in port.named_parameters():
        a, b = p.grad.numpy(), want[name].numpy()
        assert np.abs(a - b).max() <= 1e-4 * scale, name
    gxt = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(gxt - np.asarray(gx)).max() <= 1e-4 * np.abs(gx).max()
    bn = port.actf[0]
    jbn = upd["batch_stats"]["actf_bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), jbn["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), jbn["var"], rtol=0,
                               atol=1e-6)
