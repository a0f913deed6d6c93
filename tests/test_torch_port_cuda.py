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
