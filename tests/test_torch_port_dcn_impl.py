"""The DCN variants of the PyTorch port vs the JAX package, on the CPU.

* The plain versions of the three kernels that have no counterpart in slice
  1 against their TPU kernels in interpret mode (as tests/test_pallas_dcn.py
  runs them): T2 (``deform_sample_pallas`` / ``deform_conv_pallas_tap``), T4
  (``deform_conv_pallas_onehot``) and T3 (``deform_conv_pallas``, which runs
  on the CPU only with a bf16 x), each with offsets inside the clamp and
  with U(-6, 6) offsets that reach past it.
* ``DCNv2(impl=...)`` of the port against the JAX ``DCNv2(impl=...)`` for
  every ``dcn_impl``, for one sample and for a batch of two.
* The model with ``dcn_impl="pallas"`` and randomized offset convs, JAX (T2
  in interpret mode) against the port.

Problem size 16x24x8 -> 16 at radius 4 unless stated; the T1 interpret path
(``pallas_cm``) runs at 9x10x8, radius 1, because interpreting it costs ~50 s
at radius 4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.pallas_dcn as pallas_dcn
from deft_tpu.config import mot_config
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dcn import DCNv2 as JaxDCNv2
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import _OM_SRC, from_jax_variables
from deft_tpu_torch.models.dcn import DCN_IMPLS, DCNv2
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.ops import cuda_dcn

H, W, C, COUT, R = 16, 24, 8, 16, 4
REGIMES = {"inside": (-R, R), "clamp": (-6.0, 6.0)}


def _problem(regime, seed, h=H, w=W, c=C, cout=COUT):
    lo, hi = REGIMES[regime] if isinstance(regime, str) else regime
    rng = np.random.RandomState(seed)
    x = rng.randn(h, w, c).astype(np.float32)
    offs = rng.uniform(lo, hi, (h, w, 9, 2)).astype(np.float32)
    mask = rng.rand(h, w, 9).astype(np.float32)
    wt = (rng.randn(9 * c, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, offs, mask, wt, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_tap_plain_matches_t2(regime):
    """T2's plain version vs the TPU kernel: its patches (channel padding to
    128 cut away) and its conv, within 1e-5 * max|out| (float32 sums of the
    same bf16-rounded corners in another order)."""
    x, offs, mask, wt, b = _problem(regime, seed=1)
    patches, cp = pallas_dcn.deform_sample_pallas(*_j(x, offs, mask), radius=R,
                                                  interpret=True)
    ref = np.asarray(patches).reshape(H, W, 9, cp)[..., :C].reshape(H * W, -1)
    got = cuda_dcn.deform_sample_tap(*_t(x, offs, mask), R).numpy()
    assert _rel_err(got, ref) <= 1e-5
    ref_out = np.asarray(pallas_dcn.deform_conv_pallas_tap(
        *_j(x, offs, mask, wt, b), radius=R, interpret=True))
    got_out = cuda_dcn.deform_conv_tap(*_t(x, offs, mask, wt, b), R).numpy()
    assert _rel_err(got_out, ref_out) <= 1e-5
    # the bf16 rounding of x is part of the function: float32 sampling of x
    # as given is further away than the tolerance
    plain = cuda_dcn.deform_conv(*_t(x, offs, mask, wt, b), R).numpy()
    assert _rel_err(plain, ref_out) > 1e-4


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_onehot_plain_matches_t4(regime):
    """T4's plain version vs the TPU kernel within 2e-3 * max|out| (the
    kernel's own test allows 2e-2 against float32 sampling): both round x,
    the horizontal weights and the patches to bf16 at the same places, and
    differ only where float32 sums in another order round a patch to the
    neighbouring bf16 value."""
    x, offs, mask, wt, b = _problem(regime, seed=2)
    ref = np.asarray(pallas_dcn.deform_conv_pallas_onehot(
        *_j(x, offs, mask, wt, b), radius=R, interpret=True))
    got = cuda_dcn.deform_conv_onehot_sampled(*_t(x, offs, mask, wt, b),
                                              R).numpy()
    assert _rel_err(got, ref) <= 2e-3
    patches = cuda_dcn.deform_sample_onehot(*_t(x, offs, mask), R)
    assert patches.dtype == torch.bfloat16 and patches.shape == (H * W, 9 * C)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_fused_plain_matches_t3(regime):
    """T3's plain version vs the TPU kernel, which runs on the CPU only with
    a bf16 x (ROADMAP.md, C): bf16 output within 2**-7 * max|out|, one bf16
    step at the top of the output's range."""
    x, offs, mask, wt, b = _problem(regime, seed=3)
    xb = x.astype(jnp.bfloat16)
    ref = np.asarray(pallas_dcn.deform_conv_pallas(
        jnp.asarray(xb), *_j(offs, mask, wt, b), radius=R, interpret=True),
        np.float32)
    x_t = torch.from_numpy(x).to(torch.bfloat16)
    got = cuda_dcn.deform_conv_fused(x_t, *_t(offs, mask, wt, b), R)
    assert got.dtype == torch.bfloat16 and got.shape == (H, W, COUT)
    assert _rel_err(got.float().numpy(), ref) <= 2.0 ** -7
    # float32 x: the same function without the final bf16 rounding
    got32 = cuda_dcn.deform_conv_fused(*_t(x, offs, mask, wt, b), R).numpy()
    assert _rel_err(got32, ref) <= 2.0 ** -7


def test_wrappers_take_plain_path_on_cpu():
    """CPU tensors run the plain versions and launch nothing; the clamped
    kernels refuse a negative radius."""
    x, offs, mask, wt, b = _t(*_problem("inside", seed=4))
    counts = (cuda_dcn.LAUNCHES_TAP, cuda_dcn.LAUNCHES_ONEHOT,
              cuda_dcn.LAUNCHES_FUSED)
    assert torch.equal(cuda_dcn.deform_sample_tap(x, offs, mask, R),
                       cuda_dcn.deform_sample_tap_reference(x, offs, mask, R))
    assert torch.equal(
        cuda_dcn.deform_sample_onehot(x, offs, mask, R),
        cuda_dcn.deform_sample_onehot_reference(x, offs, mask, R))
    assert torch.equal(
        cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, R),
        cuda_dcn.deform_conv_fused_reference(x, offs, mask, wt, b, R))
    assert counts == (cuda_dcn.LAUNCHES_TAP, cuda_dcn.LAUNCHES_ONEHOT,
                      cuda_dcn.LAUNCHES_FUSED)
    for fn in (cuda_dcn.deform_sample_tap, cuda_dcn.deform_sample_onehot):
        with pytest.raises(ValueError):
            fn(x, offs, mask, -1)
    with pytest.raises(ValueError):
        cuda_dcn.deform_conv_fused(x, offs, mask, wt[:-1], b, R)


# ---- DCNv2 dispatch per dcn_impl ---------------------------------------------

@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX DCNv2 imports its Pallas functions at call time; run them in
    interpret mode, as the JAX package's own tests do on the CPU."""
    for name in ("deform_conv_pallas_tap", "deform_conv_pallas_cm"):
        monkeypatch.setattr(pallas_dcn, name, functools.partial(
            getattr(pallas_dcn, name), interpret=True))


def _dcn_pair(impl, cin, cout, radius, seed):
    """A JAX DCNv2 with random weights (offset conv included) and the port's
    DCNv2 carrying the same weights."""
    rng = np.random.RandomState(seed)
    wk = (rng.randn(9 * cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    om_w = (rng.randn(3, 3, cin, 27) * 0.4).astype(np.float32)
    om_b = rng.uniform(-2.0, 2.0, 27).astype(np.float32)
    jmod = JaxDCNv2(features=cout, impl=impl, offset_range=radius)
    params = {"params": {"weight": wk, "bias": bias, "conv_offset_mask": {
        "kernel": om_w, "bias": om_b}}}
    pmod = DCNv2(cin, cout, radius, impl)
    with torch.no_grad():
        pmod.weight.copy_(torch.from_numpy(np.transpose(
            wk.reshape(3, 3, cin, cout), (3, 2, 0, 1)).copy()))
        pmod.bias.copy_(torch.from_numpy(bias))
        pmod.conv_offset_mask.weight.copy_(torch.from_numpy(
            np.transpose(om_w, (3, 2, 0, 1))[_OM_SRC].copy()))
        pmod.conv_offset_mask.bias.copy_(torch.from_numpy(om_b[_OM_SRC]))
    return jmod, params, pmod


# float32 functions agree to float32 noise; pallas_cm's bf16 patches and
# weight to a bf16 step
_DISPATCH_TOL = {"pallas_cm": 2e-2}


@pytest.mark.parametrize("impl", DCN_IMPLS)
@pytest.mark.parametrize("batch", [1, 2])
def test_dcnv2_dispatch_matches_jax(impl, batch, interpret_pallas):
    """Port vs JAX DCNv2 for each dcn_impl, one sample and a batch of two,
    offsets spread past the radius; within 1e-5 * max|out| (2e-2 for the
    bf16 pallas_cm path).  The float32 path is far from the T2 and T1
    functions, so each impl is told apart from it where it should be."""
    h, w, cin, cout, radius = (9, 10, 8, 6, 1) if impl == "pallas_cm" else (
        12, 14, 8, 6, 2)
    jmod, params, pmod = _dcn_pair(impl, cin, cout, radius, seed=5 + batch)
    x = np.random.RandomState(7).randn(batch, h, w, cin).astype(np.float32)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= _DISPATCH_TOL.get(impl, 1e-5), impl
    if impl == "pallas" or (impl == "pallas_cm" and batch == 1):
        f32 = DCNv2(cin, cout, radius, "hybrid")
        f32.load_state_dict(pmod.state_dict())
        with torch.no_grad():
            other = f32(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).numpy()
        assert _rel_err(other, ref) > 1e-4


def test_unknown_dcn_impl_raises():
    with pytest.raises(ValueError):
        DCNv2(8, 8, 4, "pallas_onehot")


# ---- the model under dcn_impl="pallas" ---------------------------------------

def test_model_pallas_matches_jax(interpret_pallas):
    """dcn_impl="pallas" end to end: DLA-34 with 16 DCNv2 layers at 64x64,
    every offset conv randomized so the samples are fractional and reach
    past radius 1; every head within rtol 2e-4, atol 2e-4 * max|out|
    (test_torch_port_model.py's float32 tolerance, doubled: where float32
    noise from the layers below moves a DCN input across a bf16 rounding
    boundary, the two round it to neighbouring bf16 values; measured at
    0.44 of this tolerance).  The float32 DCN path of hybrid (1.8x the
    tolerance) and the bf16 one of pallas_cm (3.7x) miss it: before the
    port dispatched on dcn_impl, "pallas" ran hybrid's function."""
    size = dict(input_h=64, input_w=64, max_object=8, K=16,
                dcn_offset_range=1, dcn_impl="pallas")
    cfg = mot_config(**size)
    model = jax_create_model(cfg.arch, cfg)
    params, stats = jax_init_model(model, cfg)
    variables = jax.tree.map(np.array, {"params": params,
                                        "batch_stats": stats})
    rng = np.random.RandomState(13)

    def randomize(tree):
        """Offset convs random; every other bias shifted, so that no head
        is ~0 at init and its relative error is not float32 noise."""
        for key, v in tree.items():
            if key == "conv_offset_mask":
                v["kernel"] = rng.normal(0, 0.05, v["kernel"].shape).astype(
                    np.float32)
                v["bias"] = rng.uniform(-1.5, 1.5, v["bias"].shape).astype(
                    np.float32)
            elif isinstance(v, dict):
                randomize(v)
            elif key == "bias":
                tree[key] = (v + rng.normal(0, 0.05, v.shape)).astype(
                    np.float32)

    randomize(variables["params"])
    image = rng.randn(1, 64, 64, 3).astype(np.float32)
    ref, _ = model.apply(variables, jnp.asarray(image))
    sd = from_jax_variables(variables, cfg)
    for impl, should_match in (("pallas", True), ("hybrid", False),
                               ("pallas_cm", False)):
        port = create_model(cfg.arch, port_mot_config(
            **dict(size, dcn_impl=impl)), "cpu")
        port.load_state_dict(sd)
        with torch.no_grad():
            got, _ = port(torch.from_numpy(image))
        # |got - ref| over the tolerance atol + rtol * |ref|, atol = rtol *
        # max|ref|, rtol = 2e-4
        ratios = {h: float((np.abs(got[h].numpy() - ref[h]) / (2e-4 * (
            np.abs(ref[h]) + np.abs(ref[h]).max()))).max()) for h in ref}
        assert (max(ratios.values()) <= 1.0) == should_match, (impl, ratios)
