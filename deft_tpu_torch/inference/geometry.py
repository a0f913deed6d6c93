"""Quaternions and camera -> global boxes, copied from
``deft_tpu/inference/geometry.py`` (the part the nuScenes path uses).

The subset of ``pyquaternion.Quaternion`` and of the nuscenes-devkit ``Box``
that the reference's camera -> global chain needs: axis-angle construction,
composition, inverse, rotation of points, box translate / rotate.  Numpy, float64.
"""

from __future__ import annotations

import numpy as np


class Quaternion:
    """Unit quaternion (w, x, y, z)."""

    def __init__(self, wxyz=None, axis=None, angle=None):
        if wxyz is not None:
            q = np.asarray(wxyz, np.float64)
        else:
            axis = np.asarray(axis, np.float64)
            axis = axis / np.linalg.norm(axis)
            half = angle / 2.0
            q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        self.q = q / np.linalg.norm(q)

    @property
    def w(self):
        return self.q[0]

    @property
    def x(self):
        return self.q[1]

    @property
    def y(self):
        return self.q[2]

    @property
    def z(self):
        return self.q[3]

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    def rotate(self, v: np.ndarray) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, np.float64)

    @property
    def inverse(self) -> "Quaternion":
        return Quaternion([self.w, -self.x, -self.y, -self.z])

    @property
    def angle(self) -> float:
        """Rotation angle in (-pi, pi] (pyquaternion convention)."""
        n = np.linalg.norm(self.q[1:])
        a = 2.0 * np.arctan2(n, self.q[0])
        if a > np.pi:
            a -= 2 * np.pi
        return a

    @property
    def axis(self) -> np.ndarray:
        n = np.linalg.norm(self.q[1:])
        if n < 1e-12:
            return np.array([0.0, 0.0, 1.0])
        return self.q[1:] / n


class Box3D:
    """nuscenes-devkit-style box: center, wlh size, orientation quaternion."""

    def __init__(self, center, size, orientation: Quaternion):
        self.center = np.asarray(center, np.float64)
        self.wlh = np.asarray(size, np.float64)   # (w, l, h)
        self.orientation = orientation

    def translate(self, v):
        self.center = self.center + np.asarray(v, np.float64)
        return self

    def rotate(self, q: Quaternion):
        self.center = q.rotate(self.center)
        self.orientation = q * self.orientation
        return self


def camera_box_to_global(loc, size_wlh, rot_y, cs_rot, cs_trans, pose_rot,
                         pose_trans) -> Box3D:
    """Camera-frame box -> global frame: camera -> ego through the
    calibrated sensor's record, ego -> global through the ego pose's.

    loc: bottom-center in camera coords; size_wlh: (w, l, h); rot_y: camera
    yaw."""
    box = Box3D(np.asarray(loc, np.float64), size_wlh,
                Quaternion(axis=[0, 1, 0], angle=rot_y))
    box.translate(np.array([0, -box.wlh[2] / 2, 0]))
    box.rotate(Quaternion(cs_rot))
    box.translate(np.asarray(cs_trans, np.float64))
    box.rotate(Quaternion(pose_rot))
    box.translate(np.asarray(pose_trans, np.float64))
    return box
