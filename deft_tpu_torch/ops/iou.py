"""Pairwise IoU, copied from ``deft_tpu/ops/iou.py``: vectorized 2-D IoU
(the reference's ``cython_bbox.bbox_overlaps``) and the 3-D IoU of the
nuScenes association (yaw-rotated 8-corner boxes, Sutherland-Hodgman
clipping of the bird's-eye rectangles, convex-hull area, height overlap).
Host-side per-frame work in numpy.
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


# --------------------------------------------------------------------------
# 3-D IoU (nuScenes association): BEV convex clipping + height overlap.
# --------------------------------------------------------------------------

def rot_y_matrix(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def box3d_to_corners(bbox3d: np.ndarray) -> np.ndarray:
    """nuScenes-order box [h, w, l, x, y, z, rot_y] -> [8, 3] corners.

    Mirrors ``convert_3dbox_to_8corner`` (matching.py:207-240): reorder to
    KITTI [x, y, z, yaw, l, w, h], rotate the canonical corner set about y and
    translate.
    """
    h, w, l = bbox3d[0], bbox3d[1], bbox3d[2]
    x, y, z = bbox3d[3], bbox3d[4], bbox3d[5]
    yaw = bbox3d[6]

    r = rot_y_matrix(yaw)
    x_c = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y_c = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
    z_c = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    corners = r @ np.vstack([x_c, y_c, z_c])
    corners[0] += x
    corners[1] += y
    corners[2] += z
    return corners.T


def _poly_area(x: np.ndarray, y: np.ndarray) -> float:
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject, clip):
    """Sutherland-Hodgman clip of ``subject`` by convex ``clip`` (CCW points)."""

    def inside(p, cp1, cp2):
        # On-edge points count as inside (>= -eps): this avoids fabricating
        # intersection points from numerically parallel coincident edges, a
        # degenerate case where the reference's strict-inequality clip
        # (matching.py:172-173) yields IoU > 1 for identical boxes.
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) - (cp2[1] - cp1[1]) * (
            p[0] - cp1[0]
        ) >= -1e-9

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        input_list = output
        output = []
        if not input_list:
            return None
        s = input_list[-1]
        for e in input_list:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if not output:
            return None
    return output


def _convex_area(points) -> float:
    """Area of the convex hull of ``points`` via monotone chain (replaces
    scipy.spatial.ConvexHull; the clipped polygon is already convex)."""
    pts = sorted(set((float(p[0]), float(p[1])) for p in points))
    if len(pts) < 3:
        return 0.0

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    hull = lower[:-1] + upper[:-1]
    xs = np.array([p[0] for p in hull])
    ys = np.array([p[1] for p in hull])
    return _poly_area(xs, ys)


def _box3d_vol(corners: np.ndarray) -> float:
    a = np.sqrt(np.sum((corners[0] - corners[1]) ** 2))
    b = np.sqrt(np.sum((corners[1] - corners[2]) ** 2))
    c = np.sqrt(np.sum((corners[0] - corners[4]) ** 2))
    return a * b * c


def iou3d(corners1: np.ndarray, corners2: np.ndarray):
    """3-D IoU of two [8, 3] corner sets (up = -Y). Returns (iou, bev_iou)."""
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = _poly_area(np.array([p[0] for p in rect1]), np.array([p[1] for p in rect1]))
    area2 = _poly_area(np.array([p[0] for p in rect2]), np.array([p[1] for p in rect2]))
    inter = polygon_clip(rect1, rect2)
    inter_area = _convex_area(inter) if inter is not None else 0.0
    denom_bev = area1 + area2 - inter_area
    iou_2d = inter_area / denom_bev if denom_bev > 0 else 0.0
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = _box3d_vol(corners1)
    vol2 = _box3d_vol(corners2)
    denom = vol1 + vol2 - inter_vol
    return (inter_vol / denom if denom > 0 else 0.0), iou_2d


def pairwise_iou3d(aboxes, bboxes) -> np.ndarray:
    """[N][h,w,l,x,y,z,rot] x [M][...] -> [N, M] 3-D IoU."""
    acorners = [box3d_to_corners(np.asarray(b, dtype=np.float64)) for b in aboxes]
    bcorners = [box3d_to_corners(np.asarray(b, dtype=np.float64)) for b in bboxes]
    out = np.zeros((len(acorners), len(bcorners)), dtype=np.float32)
    for i, ca in enumerate(acorners):
        for j, cb in enumerate(bcorners):
            out[i, j] = iou3d(cb, ca)[0]
    return out
