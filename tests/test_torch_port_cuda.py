"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from deft_tpu_torch.ops import cuda_dcn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(h, w, c, seed, dev, dtype):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(h, w, c).astype(np.float32)).to(dev, dtype)
    offs = torch.from_numpy(
        rng.uniform(-6.0, 6.0, (h, w, 9, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.rand(h, w, 9).astype(np.float32)).to(dev)
    return x, offs, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256)])
@pytest.mark.parametrize("radius", [4, -1])
def test_dcn_sample_matches_plain(cuda_device, h, w, c, dtype, radius):
    """fp32 within 1e-5 * max|x|; bf16 within one bf16 step of max|x|
    (2**-7 * max|x|: both round an fp32 sum taken in another order)."""
    x, offs, mask = _inputs(h, w, c, 5, cuda_device, dtype)
    before = cuda_dcn.LAUNCHES
    got = cuda_dcn.deform_sample(x, offs, mask, radius)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_reference(x, offs, mask, radius)
    bound = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * x.abs().max()
    assert (got.float() - ref.float()).abs().max() <= bound


def test_dcn_sample_rejects_non_contiguous(cuda_device):
    x, offs, mask = _inputs(8, 10, 4, 6, cuda_device, torch.float32)
    with pytest.raises(ValueError):
        cuda_dcn.deform_sample(x.transpose(0, 1), offs.transpose(0, 1),
                               mask.transpose(0, 1), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256), (17, 30, 512),
                                   (136, 240, 64)])
def test_dcn_sample_tap_matches_plain(cuda_device, h, w, c, dtype):
    """T2's kernel: within 1e-5 * max|x| in float32, one bf16 step of
    max|x| (2**-7 * max|x|) in bf16."""
    x, offs, mask = _inputs(h, w, c, 7, cuda_device, dtype)
    before = cuda_dcn.LAUNCHES_TAP
    got = cuda_dcn.deform_sample_tap(x, offs, mask, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_TAP == before + 1
    assert got.dtype == dtype and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_tap_reference(x, offs, mask, 4)
    bound = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * x.abs().max()
    assert (got.float() - ref.float()).abs().max() <= bound


@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256), (17, 30, 512),
                                   (136, 240, 64)])
def test_dcn_sample_tap_is_plain_sampling_of_rounded_x(cuda_device, h, w, c):
    """T2 on x equals T1 on x rounded to bf16, bit for bit in float32: the
    two entries share one template and each element's arithmetic."""
    x, offs, mask = _inputs(h, w, c, 11, cuda_device, torch.float32)
    tap = cuda_dcn.deform_sample_tap(x, offs, mask, 4)
    plain = cuda_dcn.deform_sample(x.bfloat16().float(), offs, mask, 4)
    torch.cuda.synchronize()
    assert torch.equal(tap, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256)])
def test_dcn_sample_onehot_matches_plain(cuda_device, h, w, c, dtype):
    """T4's kernel: bf16 patches within one bf16 step of max|patch|."""
    x, offs, mask = _inputs(h, w, c, 8, cuda_device, dtype)
    before = cuda_dcn.LAUNCHES_ONEHOT
    got = cuda_dcn.deform_sample_onehot(x, offs, mask, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_ONEHOT == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_onehot_reference(x, offs, mask, 4).float()
    assert (got.float() - ref).abs().max() <= 2.0 ** -7 * ref.abs().max()


def _weights(c, cout, seed, dev):
    rng = np.random.RandomState(seed)
    wt = torch.from_numpy((rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev)
    return wt, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,cout", [
    (13, 19, 16, 6), (11, 21, 40, 70), (9, 7, 3, 64), (34, 60, 256, 128),
    # split-K: the smallest DLA-34 layer, a few pixels with a large K, and
    # C = 3 (K = 27, one ragged chunk) with ragged and wide Cout
    (17, 30, 512, 256), (5, 7, 512, 256), (9, 7, 3, 6), (9, 7, 3, 70),
    (9, 7, 3, 256)])
def test_dcn_fused_matches_plain(cuda_device, h, w, c, cout, dtype):
    """T3's kernel, ragged pixel and channel tiles and split reductions
    included: within 1e-4 * max|out| in float32 (3xTF32 products summed in
    another order), one bf16 step of max|out| in bf16."""
    x, offs, mask = _inputs(h, w, c, 9, cuda_device, dtype)
    wt, b = _weights(c, cout, 10, cuda_device)
    before = cuda_dcn.LAUNCHES_FUSED
    got = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_FUSED == before + 1
    assert got.dtype == dtype and got.shape == (h, w, cout)
    ref = cuda_dcn.deform_conv_fused_reference(x, offs, mask, wt, b, 4).float()
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * ref.abs().max()
    assert (got.float() - ref).abs().max() <= tol


def test_dcn_fused_is_deterministic(cuda_device):
    """The split-K reduction sums in a fixed order: two calls on the same
    inputs give the same bits (17x30x512 -> 256 splits its reduction)."""
    x, offs, mask = _inputs(17, 30, 512, 13, cuda_device, torch.float32)
    wt, b = _weights(512, 256, 14, cuda_device)
    assert cuda_dcn.plan_fused(17, 30, 512, 256).splits > 1
    first = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    second = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_clamped_kernels_reject_negative_radius(cuda_device):
    x, offs, mask = _inputs(8, 10, 4, 6, cuda_device, torch.float32)
    for fn in (cuda_dcn.deform_sample_tap, cuda_dcn.deform_sample_onehot):
        with pytest.raises(ValueError):
            fn(x, offs, mask, -1)
