"""Association costs, copied from ``deft_tpu/tracking/matching.py`` (the 2-D
Kalman path).

Mirror of the reference's ``utils/matching.py`` on top of the
dependency-free IoU/assignment ops: ``iou_distance`` and ``fuse_motion``
(Mahalanobis gating blended into the appearance cost).  The LSTM and 3-D
(nuScenes) variants wait for their slices.
"""

from __future__ import annotations

import numpy as np

from deft_tpu_torch.ops.iou import pairwise_iou
from deft_tpu_torch.tracking.assignment import linear_assignment  # re-export
from deft_tpu_torch.tracking.kalman import chi2inv95

__all__ = ["linear_assignment", "ious", "iou_distance", "fuse_motion"]


def ious(atlbrs, btlbrs) -> np.ndarray:
    if len(atlbrs) == 0 or len(btlbrs) == 0:
        return np.zeros((len(atlbrs), len(btlbrs)))
    return pairwise_iou(np.asarray(atlbrs), np.asarray(btlbrs))


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU cost between two STrack lists (matching.py:80-104)."""
    from deft_tpu_torch.tracking.tracker import stacked_tlbrs

    return 1.0 - ious(stacked_tlbrs(atracks), stacked_tlbrs(btracks))


def fuse_motion(cost_matrix, tracks, detections,
                lambda_: float = 0.9) -> np.ndarray:
    """Blend the appearance cost with Kalman motion gating
    (matching.py:311-364): Mahalanobis distance of each detection's center
    to each track's predicted position, gated at 5x chi2(2 dof), blended
    ``0.9 c + 0.05 * 0.1 * d``."""
    if cost_matrix.size == 0:
        return cost_matrix
    gating_threshold = chi2inv95[2]
    # vectorized to_xyah over the detections (fresh STracks: tlwh = _tlwh)
    tl = np.stack([d.tlwh for d in detections]).astype(np.float64)
    measurements = tl.copy()
    measurements[:, :2] += tl[:, 2:] / 2
    measurements[:, 2] /= np.where(tl[:, 3] != 0, tl[:, 3], 1e-6)

    # batched over all tracks; the 2x2 SPD solve is closed-form
    #   d' S^-1 d = (c dx^2 - 2b dx dy + a dy^2) / (ac - b^2)
    means = np.stack([t.mean[:2] for t in tracks])          # [T, 2]
    covs = np.stack([t.covariance[:2, :2] for t in tracks]) # [T, 2, 2]
    a = covs[:, 0, 0] + 1e-8
    b = covs[:, 0, 1]
    c = covs[:, 1, 1] + 1e-8
    det = a * c - b * b
    dx = measurements[None, :, 0] - means[:, None, 0]       # [T, M]
    dy = measurements[None, :, 1] - means[:, None, 1]
    gd = (c[:, None] * dx * dx - 2.0 * b[:, None] * dx * dy
          + a[:, None] * dy * dy) / det[:, None]
    cost_matrix[gd > 5.0 * gating_threshold] = np.inf
    return lambda_ * cost_matrix + 0.05 * (1 - lambda_) * gd
