"""The PyTorch port's decode, sampling and warp ops vs the JAX package's."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.ops import decode as jax_decode
from deft_tpu.ops import sampling as jax_sampling
from deft_tpu.ops import warp as jax_warp
from deft_tpu_torch.ops import decode, sampling, warp
from deft_tpu_torch.ops.affine import get_affine_transform


def _heads(rng, b, h, w, c):
    """Head maps whose heatmap has exact ties: values on a 0.1 grid, zeros
    over a third of the plane and a flat plateau."""
    hm = np.round(rng.rand(b, h, w, c) * 10.0) / 10.0
    hm[rng.rand(b, h, w, c) < 0.33] = 0.0
    hm[:, 2:5, 3:7, :] = 0.7
    return {
        "hm": hm.astype(np.float32),
        "reg": rng.rand(b, h, w, 2).astype(np.float32),
        "wh": (rng.randn(b, h, w, 2) * 5).astype(np.float32),
        "tracking": rng.randn(b, h, w, 2).astype(np.float32),
        "ltrb_amodal": (rng.randn(b, h, w, 4) * 3).astype(np.float32),
    }


@pytest.mark.parametrize("c,drop", [(1, ()), (3, ("ltrb_amodal",)),
                                    (1, ("reg", "ltrb_amodal"))])
def test_generic_decode_with_ties(c, drop):
    """Every output of generic_decode, in JAX's order among tied scores
    (lower flat index first), exactly (integer fields) or to 1e-6 (the same
    float32 additions)."""
    rng = np.random.RandomState(c + len(drop))
    heads = {k: v for k, v in _heads(rng, 2, 13, 17, c).items()
             if k not in drop}
    k = 40
    ref = jax_decode.generic_decode({h: jnp.asarray(v) for h, v in heads.items()},
                                    k=k)
    got = decode.generic_decode({h: torch.from_numpy(v)
                                 for h, v in heads.items()}, k=k)
    assert set(got) == set(ref)
    scores = np.asarray(ref["scores"])
    assert (np.diff(scores, axis=1) == 0).sum() > 20   # the ties are real
    for key in ("inds", "clses"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_heat_nms_and_clamped_sigmoid():
    rng = np.random.RandomState(1)
    x = (rng.randn(1, 9, 11, 2) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        decode.heat_nms(torch.from_numpy(x)).numpy(),
        np.asarray(jax_decode.heat_nms(jnp.asarray(x))))
    from deft_tpu.models.deft import clamped_sigmoid
    np.testing.assert_allclose(
        decode.clamped_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(clamped_sigmoid(jnp.asarray(x))), rtol=0, atol=1e-7)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_points(align_corners):
    """Border padding, points inside and outside [-1, 1] (fp32, same
    operations; 1e-6)."""
    rng = np.random.RandomState(2)
    feat = rng.randn(7, 12, 5).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (50, 2)).astype(np.float32)
    grid[:4] = [[-1, -1], [1, 1], [-1, 1], [0, 0]]
    ref = jax_sampling.grid_sample_points(
        jnp.asarray(feat), jnp.asarray(grid), padding_mode="border",
        align_corners=align_corners)
    got = sampling.grid_sample_points(
        torch.from_numpy(feat), torch.from_numpy(grid), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


GEOMETRIES = [(108, 192, 64, 96), (75, 100, 96, 64), (64, 64, 64, 64)]


def _fix_res(h, w, out_h, out_w):
    c = np.array([w / 2.0, h / 2.0], np.float32)
    s = max(h, w) * 1.0
    return c, s


@pytest.mark.parametrize("h,w,out_h,out_w", GEOMETRIES)
def test_warp_matches_jax(h, w, out_h, out_w):
    """The two-matmul warp vs the JAX package's (fp32 sums of up to two
    nonzero terms per axis over 0..255 values; atol 1e-3)."""
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3), np.uint8)
    c, s = _fix_res(h, w, out_h, out_w)
    inv6 = warp.separable_inverse_tf(c, s, out_w, out_h)
    np.testing.assert_array_equal(
        inv6, jax_warp.separable_inverse_tf(c, s, out_w, out_h))
    ref = np.asarray(jax_warp.warp_affine_separable(
        jnp.asarray(img[None]), jnp.asarray(inv6), out_h, out_w))
    got = warp.warp_affine_separable(torch.from_numpy(img[None]), inv6,
                                     out_h, out_w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,w,out_h,out_w", GEOMETRIES)
def test_warp_within_one_step_of_cv2(h, w, out_h, out_w):
    """Against cv2.warpAffine (INTER_LINEAR, BORDER_CONSTANT 0) on a smooth
    frame: cv2 quantizes positions to 1/32 px and rounds to uint8, so the
    interior (2 px from the border) agrees within one uint8 step."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 120 * np.sin(xx / 9.0 + yy / 13.0),
                    255 * xx / w, 255 * yy / h], axis=-1).astype(np.uint8)
    c, s = _fix_res(h, w, out_h, out_w)
    trans = get_affine_transform(c, s, 0, [out_w, out_h])
    ref = cv2.warpAffine(img, trans, (out_w, out_h),
                         flags=cv2.INTER_LINEAR).astype(np.float32)
    got = warp.warp_affine_separable(
        torch.from_numpy(img[None]),
        warp.separable_inverse_tf(c, s, out_w, out_h), out_h, out_w)[0]
    diff = np.abs(got.numpy() - ref)[2:-2, 2:-2]
    assert diff.max() <= 1.0, diff.max()
