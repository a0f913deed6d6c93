"""YUV 4:2:0 uploads (``cfg.yuv_upload``): the port's host packer
``runner.pack_yuv420`` and device decode ``DEFTNet._decode_input`` against
the JAX package's, and the port's ``PipelinedRunner`` under ``yuv_upload``
against the JAX runner at chunk 1 and chunk 4 (``tests/
torch_port_bench_setup.py`` says what the scene, the weights and the checks
are).  The packed bytes must be equal, the decoded frame within DECODE_TOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_bench_setup as B
from torch_port_bench_setup import few_threads  # noqa: F401

from deft_tpu.inference.runner import pack_yuv420 as jax_pack
from deft_tpu.models.deft import DEFTNet as JaxNet
from deft_tpu_torch.inference.runner import pack_yuv420

DECODE_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    return B.build_weights(B.frames()[0])


@pytest.mark.parametrize("shape", [(96, 160), (2, 2), (30, 48)])
def test_pack_yuv420_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    bgr = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    bgr[:2, :2] = (255, 255, 255)       # saturated corners round to 255/0
    bgr[-2:, -2:] = 0
    got = pack_yuv420(bgr)
    assert got.dtype == np.uint8 and got.shape == (shape[0] * 3 // 2,
                                                   shape[1])
    np.testing.assert_array_equal(got, jax_pack(bgr))


def test_decode_input_matches_jax(weights):
    """Random packed buffers (any byte: chroma far from grey drives the BGR
    clip) and the packing of real frames, batch of 3."""
    rng = np.random.RandomState(1)
    packed = np.stack([rng.randint(0, 256, (48, 64)).astype(np.uint8),
                       pack_yuv420(B.frames()[0][:32, :64]),
                       pack_yuv420(B.frames()[5][-32:, -64:])])
    want = np.asarray(JaxNet._decode_input(jnp.asarray(packed), True))
    bgr = np.stack(B.frames()[:3])
    model = B.port_runner(weights, 1).det.model
    with torch.no_grad():
        got = model._decode_input(torch.from_numpy(packed), True).numpy()
        plain = model._decode_input(torch.from_numpy(bgr), False).numpy()
    assert got.shape == want.shape == (3, 32, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL)
    # without yuv_in a uint8 frame is only normalized
    np.testing.assert_allclose(
        plain, np.asarray(JaxNet._decode_input(jnp.asarray(bgr), False)),
        rtol=0, atol=DECODE_TOL)


@pytest.mark.parametrize("chunk", [1, 4])
def test_runner_yuv_matches_jax(weights, chunk):
    seq = B.frames()
    jrun = B.jax_runner(weights, chunk, yuv_upload=True)
    prun = B.port_runner(weights, chunk, yuv_upload=True)
    assert jrun._yuv_mode and prun._yuv_mode and prun.host_warp
    want = jrun.track_sequence(seq)
    got = prun.track_sequence(seq)
    B.check_tracks(got, want, f"yuv chunk {chunk}")
    assert B.n_tracks(got) >= 2 * len(seq)
    assert prun.timings()["host_prep"] > 0


def test_yuv_off_for_odd_sizes_and_public(weights):
    """The YUV mode needs even input sizes, fix_res and no public
    detections (runner.py:140-142); else the runner uploads plain frames,
    as the JAX one does."""
    for flags in (dict(public_det=True), dict(keep_res=True)):
        jrun = B.jax_runner(weights, 1, yuv_upload=True, **flags)
        prun = B.port_runner(weights, 1, yuv_upload=True, **flags)
        assert not jrun._yuv_mode and not prun._yuv_mode, flags
    odd = dict(B.SIZE, input_h=97)
    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.inference.runner import PipelinedRunner

    prun = PipelinedRunner(Detector(mot_config(yuv_upload=True, **odd),
                                    device="cpu"))
    assert not prun._yuv_mode and not prun.host_warp
