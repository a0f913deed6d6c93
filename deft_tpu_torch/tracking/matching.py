"""Association costs, copied from ``deft_tpu/tracking/matching.py``.

Mirror of the reference's ``utils/matching.py`` on top of the
dependency-free IoU/assignment ops: ``iou_distance`` (optionally against the
LSTM's future predictions), ``iou_ddd_distance`` (3-D IoU), ``fuse_motion``
(Kalman Mahalanobis gating, or the LSTM's gaussian gating, blended into the
appearance cost) and ``fuse_motion_ddd`` (the 3-D centre distance, gated by
depth).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deft_tpu_torch.ops.iou import pairwise_iou, pairwise_iou3d
from deft_tpu_torch.tracking.assignment import linear_assignment  # re-export
from deft_tpu_torch.tracking.kalman import chi2inv95
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion

__all__ = ["linear_assignment", "ious", "iou_distance", "iou_ddd_distance",
           "fuse_motion", "fuse_motion_ddd"]


def ious(atlbrs, btlbrs) -> np.ndarray:
    if len(atlbrs) == 0 or len(btlbrs) == 0:
        return np.zeros((len(atlbrs), len(btlbrs)))
    return pairwise_iou(np.asarray(atlbrs), np.asarray(btlbrs))


def iou_distance(atracks, btracks, frame_id: int = 0,
                 use_prediction: bool = False) -> np.ndarray:
    """1 - IoU cost between two STrack lists (matching.py:80-104); with
    ``use_prediction`` the first list's boxes are its LSTM predictions for
    ``frame_id``."""
    from deft_tpu_torch.tracking.tracker import stacked_tlbrs

    if use_prediction:
        atlbrs = [t.prediction_at_frame_tlbr(frame_id) for t in atracks]
    else:
        atlbrs = stacked_tlbrs(atracks)
    return 1.0 - ious(atlbrs, stacked_tlbrs(btracks))


def iou_ddd_distance(atracks, btracks) -> np.ndarray:
    """1 - 3-D IoU of two STrack lists' [h, w, l, x, y, z, rot] boxes
    (matching.py:107-133)."""
    if len(atracks) == 0 or len(btracks) == 0:
        return np.zeros((len(atracks), len(btracks)), dtype=np.float32)
    return 1.0 - pairwise_iou3d([t.ddd_bbox for t in atracks],
                                [t.ddd_bbox for t in btracks])


def fuse_motion(cost_matrix, tracks, detections, lambda_: float = 0.9,
                frame_id: int = 0, use_lstm: bool = False) -> np.ndarray:
    """Blend the appearance cost with motion gating (matching.py:311-364).

    Kalman: Mahalanobis distance of each detection's center to each track's
    predicted position, gated at 5x chi2(2 dof), blended
    ``0.9 c + 0.05 * 0.1 * d``.  LSTM: the gaussian distance over dims 3:-1
    of the [cx, cy, a, h] prediction for ``frame_id`` -- an empty slice, so
    0, as in the reference -- gated at 50 and blended ``0.9 c + 0.0005 * 0.1
    * d``; a track with 300 observations or more gates by the Mahalanobis
    distance to its prediction under its empirical covariance instead."""
    if cost_matrix.size == 0:
        return cost_matrix
    gating_threshold = chi2inv95[2]
    # vectorized to_xyah over the detections (fresh STracks: tlwh = _tlwh)
    tl = np.stack([d.tlwh for d in detections]).astype(np.float64)
    measurements = tl.copy()
    measurements[:, :2] += tl[:, 2:] / 2
    measurements[:, 2] /= np.where(tl[:, 3] != 0, tl[:, 3], 1e-6)

    if use_lstm:
        for row, track in enumerate(tracks):
            pred = track.prediction_at_frame(frame_id)
            if len(track.observations) < 300:
                dd = measurements[:, 3:-1] - pred[3:-1]
                gd = np.sqrt(np.sum(dd * dd, axis=1))
                cost_matrix[row, gd > 50] = np.inf
                cost_matrix[row] = (lambda_ * cost_matrix[row]
                                    + 0.0005 * (1 - lambda_) * gd)
            else:
                gd = LSTMMotion.gating_distance(
                    pred, track.covariance, measurements, only_position=True,
                    metric="maha")
                cost_matrix[row, gd > 5.0 * gating_threshold] = np.inf
                cost_matrix[row] = (lambda_ * cost_matrix[row]
                                    + 0.05 * (1 - lambda_) * gd)
        return cost_matrix

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


def fuse_motion_ddd(cost_matrix, tracks, detections,
                    classe_name: Optional[str] = None,
                    lambda_: float = 0.9) -> np.ndarray:
    """3-D motion fusion (matching.py:367-415): the distance between each
    track's and each detection's 3-D box centre, gated at 0.2 x the track's
    depth with a floor of 5 m (pedestrians) or 10 m, blended
    ``0.9 c + 0.001 d``."""
    if cost_matrix.size == 0:
        return cost_matrix
    measurements = np.asarray([d.ddd_bbox for d in detections])
    floor = 5.0 if classe_name == "pedestrian" else 10.0
    for row, track in enumerate(tracks):
        gd = LSTMMotion.gating_distance(track.ddd_bbox, track.covariance,
                                        measurements)
        cost_matrix[row, gd > max(0.2 * track.depth, floor)] = np.inf
        cost_matrix[row] = lambda_ * cost_matrix[row] + 0.001 * gd
    return cost_matrix
