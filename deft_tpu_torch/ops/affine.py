"""Affine-warp geometry, copied from ``deft_tpu/ops/affine.py``.

Pure-numpy mirrors of the reference helpers in
the reference DEFT's ``src/lib/utils/image.py:25-100`` (``get_affine_transform``,
``affine_transform``, ``transform_preds_with_trans``).  These run on host (they
shape metadata, not tensors), so numpy is the right tool; the image warp itself
is done by the two-matmul separable warp in ``deft_tpu_torch.ops.warp``.

The reference builds the 2x3 affine from three point correspondences via
``cv2.getAffineTransform``; we solve the same 3-point system directly so the
core library has no cv2 dependency.
"""

from __future__ import annotations

import numpy as np


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _rotate(pt, rad):
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine mapping the three ``src`` points onto ``dst``."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros(6, dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    sol = np.linalg.solve(a, b)
    return sol.reshape(2, 3).astype(np.float32)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0), inv=False):
    """Affine from a (center, scale, rot) crop spec to ``output_size`` pixels.

    Mirrors ``image.py:42-73``: scale is the source-crop edge length, and the
    second correspondence point sits half a crop above the center (rotated by
    ``rot`` degrees).
    """
    center = np.asarray(center, dtype=np.float32)
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, trans):
    """Apply a 2x3 affine to one 2-D point (image.py:76-80)."""
    p = np.array([pt[0], pt[1], 1.0], dtype=np.float32)
    return (trans @ p)[:2]


def transform_preds_with_trans(coords: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to an [N, 2] array of points (image.py:25-31)."""
    n = coords.shape[0]
    homo = np.ones((n, 3), dtype=np.float32)
    homo[:, :2] = coords
    return (trans @ homo.T).T[:, :2]


def transform_bbox_with_trans(bbox: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Back-transform an [..., 4] tlbr box by transforming both corners."""
    pts = bbox.reshape(-1, 2)
    out = transform_preds_with_trans(pts, trans)
    return out.reshape(bbox.shape)
