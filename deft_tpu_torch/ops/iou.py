"""Pairwise 2-D IoU, copied from ``deft_tpu/ops/iou.py`` (the 2-D part).

Replaces the reference's ``cython_bbox.bbox_overlaps`` with vectorized numpy;
host-side per-frame work.
"""

from __future__ import annotations

import numpy as np


def pairwise_iou(atlbr: np.ndarray, btlbr: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] tlbr boxes -> [N, M] IoU.

    Matches cython_bbox's convention of +1 pixel areas (inclusive pixel
    coordinates), which the reference relies on for its IoU-association
    thresholds.
    """
    atlbr = np.ascontiguousarray(atlbr, dtype=np.float64)
    btlbr = np.ascontiguousarray(btlbr, dtype=np.float64)
    n, m = atlbr.shape[0], btlbr.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.float64)

    lt = np.maximum(atlbr[:, None, :2], btlbr[None, :, :2])
    rb = np.minimum(atlbr[:, None, 2:4], btlbr[None, :, 2:4])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (atlbr[:, 2] - atlbr[:, 0] + 1.0) * (atlbr[:, 3] - atlbr[:, 1] + 1.0)
    area_b = (btlbr[:, 2] - btlbr[:, 0] + 1.0) * (btlbr[:, 3] - btlbr[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou
