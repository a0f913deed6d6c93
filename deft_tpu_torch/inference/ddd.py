"""Monocular 3-D geometry on the host, copied from
``deft_tpu/inference/ddd.py``: the corners of a 3-D box in the camera
frame, their projection to pixels, unprojection of a 2-D centre and
depth, alpha -> rot_y, the 8-bin rot head's alpha, and the greedy 2-D NMS the
nuScenes detector applies per class.  Numpy, small-N work.
"""

from __future__ import annotations

import numpy as np


def compute_corners_3d(dim, rotation_y):
    """dim: [h, w, l]; returns [8, 3] corners in camera frame."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    h, w, l = dim
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [0, 0, 0, 0, -h, -h, -h, -h]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    return (r @ np.array([x, y, z], dtype=np.float32)).T


def compute_box_3d(dim, location, rotation_y):
    """[8, 3] corners of the box of ``dim`` [h, w, l] at the bottom centre
    ``location``, yawed by ``rotation_y`` about the camera's y axis."""
    corners = compute_corners_3d(dim, rotation_y)
    return corners + np.asarray(location, np.float32).reshape(1, 3)


def project_to_image(pts_3d, p):
    """[N, 3] camera points + [3, 4] projection -> [N, 2] pixels
    (``deft_tpu/inference/ddd.py:30``)."""
    n = pts_3d.shape[0]
    homo = np.concatenate([pts_3d, np.ones((n, 1), np.float32)], axis=1)
    pts_2d = homo @ p.T
    return pts_2d[:, :2] / pts_2d[:, 2:]


def unproject_2d_to_3d(pt_2d, depth, p):
    """Pixel ``pt_2d`` at ``depth`` through the [3, 4] projection ``p`` ->
    camera-frame [x, y, z] float32."""
    z = depth - p[2, 3]
    x = (pt_2d[0] * depth - p[0, 3] - p[0, 2] * z) / p[0, 0]
    y = (pt_2d[1] * depth - p[1, 3] - p[1, 2] * z) / p[1, 1]
    return np.array([x, y, z], dtype=np.float32)


def alpha2rot_y(alpha, x, cx, fx):
    rot_y = alpha + np.arctan2(x - cx, fx)
    if rot_y > np.pi:
        rot_y -= 2 * np.pi
    if rot_y < -np.pi:
        rot_y += 2 * np.pi
    return rot_y


def ddd2locrot(center, alpha, dim, depth, calib):
    """2-D center + depth + alpha -> 3-D bottom-center location and yaw."""
    locations = unproject_2d_to_3d(center, depth, calib)
    locations[1] += dim[0] / 2
    rotation_y = alpha2rot_y(alpha, center[0], calib[0, 2], calib[0, 0])
    return locations, rotation_y


def get_alpha(rot):
    """[N, 8] 2-bin rot head output -> [N] alpha."""
    rot = np.asarray(rot)
    idx = (rot[:, 1] > rot[:, 5]).astype(np.float32)
    alpha1 = np.arctan2(rot[:, 2], rot[:, 3]) + (-0.5 * np.pi)
    alpha2 = np.arctan2(rot[:, 6], rot[:, 7]) + (0.5 * np.pi)
    return alpha1 * idx + alpha2 * (1 - idx)


def nms_greedy(boxes: np.ndarray, scores: np.ndarray, overlap: float = 0.5,
               top_k: int = 200):
    """Greedy IoU NMS over [N, 4] tlbr boxes.  Returns (keep indices, count)."""
    if boxes.size == 0:
        return np.zeros(0, np.int64), 0
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(scores)[-top_k:]
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(i)
        order = order[:-1]
        if order.size == 0:
            break
        xx1 = np.maximum(x1[order], x1[i])
        yy1 = np.maximum(y1[order], y1[i])
        xx2 = np.minimum(x2[order], x2[i])
        yy2 = np.minimum(y2[order], y2[i])
        w = np.clip(xx2 - xx1, 0, None)
        h = np.clip(yy2 - yy1, 0, None)
        inter = w * h
        union = area[order] + area[i] - inter
        iou = np.where(union > 0, inter / union, 0)
        order = order[iou <= overlap]
    return np.asarray(keep, np.int64), len(keep)
