"""DCNv2 sampling in the PyTorch port vs the JAX package.

The port's plain version (``deform_sample_reference``, which the wrapper runs
for CPU tensors) is held against three JAX functions: the gather oracle
``deft_tpu.models.dcn.deform_sample`` (no clamp), the XLA
``deform_conv_onehot`` (clamped), and the TPU kernel itself,
``deform_conv_pallas_cm`` in interpret mode.  The CUDA kernel is held against
the plain version on the card in ``test_torch_port_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.models.dcn import deform_sample as jax_deform_sample
from deft_tpu.ops.pallas_dcn import deform_conv_onehot, deform_conv_pallas_cm
from deft_tpu_torch.ops import cuda_dcn

SHAPES = [(13, 19, 16), (11, 21, 40)]       # H, W not multiples of 8


def _problem(h, w, c, off_lo, off_hi, seed, cout=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(h, w, c).astype(np.float32)
    offs = rng.uniform(off_lo, off_hi, (h, w, 9, 2)).astype(np.float32)
    mask = rng.rand(h, w, 9).astype(np.float32)
    wt = (rng.randn(9 * c, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, offs, mask, wt, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("h,w,c", SHAPES)
@pytest.mark.parametrize("r", [1, 4])
def test_plain_matches_gather_oracle(h, w, c, r):
    """No clamp (radius -1) and offsets inside +-r: the port's patches equal
    deform_sample's (fp32, same float ops; atol 1e-5)."""
    x, offs, mask, _, _ = _problem(h, w, c, -r, r, seed=c + r)
    ref = np.asarray(jax_deform_sample(jnp.asarray(x), jnp.asarray(offs),
                                       jnp.asarray(mask)))
    got = cuda_dcn.deform_sample_reference(*_torch(x, offs, mask), -1)
    np.testing.assert_allclose(got.numpy(), ref.reshape(h * w, 9 * c),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,c", SHAPES)
@pytest.mark.parametrize("r", [1, 4])
def test_plain_matches_onehot_with_clamp(h, w, c, r):
    """Offsets in U(-6, 6) reach past +-r, so the clamp matters; after the
    same [9C, Cout] weight product the port equals deform_conv_onehot
    (fp32 sums of 9C products in another order; atol 1e-5)."""
    x, offs, mask, wt, b = _problem(h, w, c, -6.0, 6.0, seed=10 + c + r)
    ref = np.asarray(deform_conv_onehot(
        *(jnp.asarray(a) for a in (x, offs, mask, wt, b)), radius=r))
    got = cuda_dcn.deform_conv(*_torch(x, offs, mask, wt, b), radius=r)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # and the clamp is what makes them agree: unclamped sampling differs
    free = cuda_dcn.deform_conv(*_torch(x, offs, mask, wt, b), radius=-1)
    assert np.abs(free.numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("h,w,c,r", [SHAPES[0] + (4,), SHAPES[1] + (1,)])
def test_plain_matches_pallas_cm_kernel(h, w, c, r):
    """The TPU kernel itself (interpret mode, as tests/test_pallas_dcn.py
    runs it): it samples a bf16 slab and multiplies bf16 patches by a bf16
    weight, so the tolerance is its bf16-mantissa one (rtol = atol = 3e-2).
    Two of the four (shape, radius) pairs: interpreting the r=4 kernel takes
    ~35 s a case on one CPU core."""
    x, offs, mask, wt, b = _problem(h, w, c, -1.5 * r, 1.5 * r, seed=20 + c + r)
    ref = np.asarray(deform_conv_pallas_cm(
        *(jnp.asarray(a) for a in (x, offs, mask, wt, b)), radius=r,
        tile_h=8, interpret=True))
    got = cuda_dcn.deform_conv(*_torch(x, offs, mask, wt, b), radius=r)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-2, atol=3e-2)


def test_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor runs the plain version and launches no kernel."""
    x, offs, mask, _, _ = _problem(9, 10, 8, -2.0, 2.0, seed=3)
    before = cuda_dcn.LAUNCHES
    got = cuda_dcn.deform_sample(*_torch(x, offs, mask), 2)
    ref = cuda_dcn.deform_sample_reference(*_torch(x, offs, mask), 2)
    assert cuda_dcn.LAUNCHES == before
    assert torch.equal(got, ref)
    assert got.shape == (9 * 10, 9 * 8)


def test_wrapper_rejects_bad_inputs():
    x, offs, mask, _, _ = _torch(*_problem(5, 6, 4, -1.0, 1.0, seed=4))
    with pytest.raises(ValueError):
        cuda_dcn.deform_sample(x, offs[:, :, :8], mask, 1)
    with pytest.raises(TypeError):
        cuda_dcn.deform_sample(x.double(), offs, mask, 1)
    with pytest.raises(TypeError):
        cuda_dcn.deform_sample(x, offs.half(), mask, 1)
