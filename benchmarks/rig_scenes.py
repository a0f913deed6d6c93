"""The rig cells' traffic generator: one nuScenes-like scene of a six-camera
rig on a moving ego car, made from a seed.

``make_rig(params, seed, device)`` returns the scene's frames, uint8 BGR
[samples, cameras, H, W, 3] drawn on the device, and per sample and camera
the image info the program's ``Detector.run_multi`` takes (``calib``, the
camera's and the ego pose's records, ``trans_matrix``).  The rig is
nuScenes': six cameras at their yaws on the car (front, front right, front
left, back, back left, back right) with intrinsics near those of nuScenes'
cameras at 1600x900 (the back camera's wider lens among them), scaled to
the frame size.  The ego car drives straight ahead, ``ego_step_m`` metres
a sample.  The objects (``params["objects"]``: per class a count, a speed
range in metres a sample and the class's mean size, w x l x h) keep to the
road: vehicles in lanes 3.5 m apart going either way, pedestrians on the
pavements beyond, the rest standing; each one's place along the road
relative to the ego car wraps within ``radius_m``, so that the scene holds
the same traffic around the car throughout.  Objects are drawn far first
as textured rectangles at the extent of their projected corners, on a
background per camera (``scenes._background``).

Every seed draws the same number of objects of each class at the same
ranges; where they are, how fast they go and how they look changes.

``new_scene(i, n)``: a cell plays the scene's samples forward and
backward (``scenes.pingpong``); each run from one end to the other is a
scene of its own, on which the trackers start afresh, as an offline
evaluation starts them on each scene.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from benchmarks.scenes import _background

# (yaw on the car in degrees, fx, cx, cy) at 1600x900, fy = fx
CAMERAS = ((0.0, 1266.4, 816.3, 491.5), (-55.0, 1260.8, 808.0, 495.3),
           (55.0, 1272.6, 826.6, 479.8), (180.0, 809.2, 829.2, 481.8),
           (110.0, 1256.7, 817.8, 452.0), (-110.0, 1259.5, 807.3, 501.2))
# camera axes (x right, y down, z ahead) in the car's frame (x ahead, y
# left, z up) for a camera that looks ahead
R_FRONT = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
LANE_M = 3.5
PAVEMENT_M = (13.0, 18.0)
VEHICLES = ("car", "truck", "bus", "trailer", "motorcycle", "bicycle")
NEAREST_M = 1.0        # a box with a corner nearer the camera is not drawn


def rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def quaternion(r: np.ndarray) -> List[float]:
    """A rotation matrix -> (w, x, y, z), by its largest component."""
    t = np.trace(r)
    if t > 0:
        s = 2.0 * math.sqrt(1.0 + t)
        q = [s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    return [float(v) for v in q]


def camera(k: int, height: int, width: int):
    """Camera ``k``'s ([3, 4] projection, rotation, translation on the
    car)."""
    yaw, f, cx, cy = CAMERAS[k]
    sx, sy = width / 1600.0, height / 900.0
    calib = np.array([[f * sx, 0.0, cx * sx, 0.0], [0.0, f * sy, cy * sy, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])
    r = rot_z(math.radians(yaw))
    return calib, r @ R_FRONT, r @ [1.0, 0.0, 0.0] + np.array([0.5, 0.0, 1.5])


def _objects(params: dict, rng: np.random.Generator):
    """(classes, sizes [N, 3] w l h, places [N, 2] along and across the
    road at sample 0, velocities [N, 2] along and across, in m a sample)."""
    names, sizes, places, vels = [], [], [], []
    radius = float(params["radius_m"])
    for name, spec in params["objects"].items():
        n = int(spec["count"])
        speed = rng.uniform(*spec["speed"], n)
        along = rng.uniform(-radius, radius, n)
        if name in VEHICLES:
            lane = rng.integers(1, 4, n) * rng.choice([-1, 1], n)
            across = lane * LANE_M - np.sign(lane) * LANE_M / 2
            heading = np.where(across > 0, -1.0, 1.0)      # keep right
            vel = np.stack([heading * speed, np.zeros(n)], 1)
        elif name == "pedestrian":
            across = (rng.uniform(*PAVEMENT_M, n) * rng.choice([-1, 1], n))
            angle = rng.uniform(-math.pi, math.pi, n)
            vel = np.stack([speed * np.cos(angle), 0.2 * speed
                            * np.sin(angle)], 1)
        else:
            across = rng.uniform(*PAVEMENT_M, n) * rng.choice([-1, 1], n) / 2
            vel = np.zeros((n, 2))
        names += [name] * n
        sizes.append(np.tile(spec["size"], (n, 1)))
        places.append(np.stack([along, across], 1))
        vels.append(vel)
    return (names, np.concatenate(sizes), np.concatenate(places),
            np.concatenate(vels))


def new_scene(i: int, n: int) -> bool:
    """Whether sample i of a cell's pass over a scene of n samples
    (``scenes.pingpong``) starts a new scene: at either end of the
    scene but the first sample."""
    return i > 0 and i % (n - 1) == 0


def make_rig(params: dict, seed: int, device
             ) -> Tuple[torch.Tensor, List[List[dict]]]:
    """(frames uint8 [S, C, H, W, 3] on ``device``, infos [S][C])."""
    h, w = int(params["height"]), int(params["width"])
    n_samples, n_cams = int(params["samples"]), int(params["cameras"])
    step = float(params["ego_step_m"])
    radius = float(params["radius_m"])
    rng = np.random.default_rng(int(seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    names, size, place, vel = _objects(params, rng)
    n_obj = len(names)
    base = rng.integers(70, 180, (n_obj, 3))
    colour = torch.tensor(0.7 * base.mean(1, keepdims=True) + 0.3 * base,
                          dtype=torch.float32, device=device)
    dark = (colour * torch.tensor(rng.uniform(0.55, 0.85, (n_obj, 1)),
                                  dtype=torch.float32, device=device))
    colour, dark = colour.to(torch.uint8), dark.to(torch.uint8)
    stripe = rng.integers(3, 7, n_obj)
    yaw = np.arctan2(vel[:, 1], vel[:, 0])
    yaw = np.where(np.abs(vel).sum(1) > 0, yaw, rng.uniform(-math.pi,
                                                            math.pi, n_obj))
    # unit box corners [8, 3], then each object's in the car-aligned frame
    unit = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                     for sz in (0.0, 1.0)])
    corners = np.einsum("nij,nkj->nki", np.stack([rot_z(a) for a in yaw]),
                        unit[None] * size[:, None, [1, 0, 2]])

    cams = [camera(k, h, w) for k in range(n_cams)]
    frames = torch.cat([_background(h, w, gen, device)
                        for _ in range(n_cams)])
    frames = frames[None].expand(n_samples, -1, -1, -1, -1).clone()
    infos = []
    for t in range(n_samples):
        ego = np.array([step * t, 0.0, 0.0])
        rel = place + vel * t - [step * t, 0.0]
        rel[:, 0] = (rel[:, 0] + radius) % (2 * radius) - radius
        centre = np.c_[ego[0] + rel[:, 0], rel[:, 1], np.zeros(n_obj)]
        pose_rot = [1.0, 0.0, 0.0, 0.0]
        row = []
        for k, (calib, r_cs, t_cs) in enumerate(cams):
            to_global = np.eye(4)
            to_global[:3, :3] = r_cs
            to_global[:3, 3] = t_cs + ego
            to_cam = np.linalg.inv(to_global)
            pts = corners + centre[:, None]                    # [N, 8, 3]
            cam = pts @ to_cam[:3, :3].T + to_cam[:3, 3]
            depth = cam[:, :, 2].mean(1)
            for i in np.argsort(-depth):
                if (cam[i, :, 2] < NEAREST_M).any():
                    continue
                uv = cam[i] @ calib[:, :3].T
                uv = uv[:, :2] / uv[:, 2:]
                x0, y0 = np.clip(uv.min(0), 0, [w, h]).astype(int)
                x1, y1 = np.clip(uv.max(0), 0, [w, h]).astype(int)
                if x1 - x0 < 4 or y1 - y0 < 4:
                    continue
                frames[t, k, y0:y1, x0:x1] = colour[i]
                frames[t, k, y0:y1:int(stripe[i]), x0:x1] = dark[i]
            row.append({"calib": calib.tolist(),
                        "trans_matrix": to_global.tolist(),
                        "cs_record_rot": quaternion(r_cs),
                        "cs_record_trans": [float(v) for v in t_cs],
                        "pose_record_rot": pose_rot,
                        "pose_record_trans": [float(v) for v in ego]})
        infos.append(row)
    return frames, infos
