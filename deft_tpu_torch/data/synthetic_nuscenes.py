"""A synthetic nuScenes-like scene: a six-camera rig on a moving ego car,
boxes moving around it, rendered with numpy.

``make_scene`` returns one scene as (image info, frame) pairs in the fields
``tools/convert_nuscenes.py`` writes (``id``, ``frame_id``, ``sensor_id``,
``sample_token``, ``calib``, ``trans_matrix`` and the camera and ego-pose
records), so ``track.py::track_nuscenes`` and ``nuscenes_submission`` take
it as they take converted data.  ``make_tables`` gives the same scene's
ground truth as the raw v1.0 tables ``tools/eval_nuscenes.py`` reads
(``scene``, ``sample``, ``sample_annotation``, ``instance``,
``category``).  Each camera has a nuScenes-like intrinsic
(f = 1266, principal point (816, 491) at 1600x900, scaled to the frame
size) and its own yaw on the ego car; the ego pose advances every sample.
Objects are solid rectangles at their projected 3-D extents.  Everything
comes from ``seed``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from deft_tpu_torch.inference.geometry import Quaternion

# the rig's cameras by sensor id, with their yaw on the ego car (degrees)
CAMERAS = (("CAM_FRONT", 0.0), ("CAM_FRONT_RIGHT", -55.0),
           ("CAM_FRONT_LEFT", 55.0), ("CAM_BACK", 180.0),
           ("CAM_BACK_LEFT", 110.0), ("CAM_BACK_RIGHT", -110.0))
# camera axes (x right, y down, z forward) in the ego frame (x forward,
# y left, z up) of a camera that looks ahead
_R_FRONT = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
# (w, l, h) in metres and nuScenes category: a car, a pedestrian, a truck
_SIZES = ((1.9, 4.5, 1.6), (0.6, 0.6, 1.7), (2.5, 8.0, 3.0))
_CATEGORIES = ("vehicle.car", "human.pedestrian.adult", "vehicle.truck")
EGO_STEP = 1.0        # metres the ego car moves per sample


def _rot_z(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float64)


def _quaternion(r: np.ndarray) -> List[float]:
    """3x3 rotation -> (w, x, y, z); valid where the trace is > -1."""
    w = np.sqrt(max(1.0 + np.trace(r), 1e-12)) / 2.0
    return [w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
            (r[1, 0] - r[0, 1]) / (4 * w)]


def _matrix(translation, rotation) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = Quaternion(rotation).rotation_matrix
    t[:3, 3] = translation
    return t


def _corners(center, size, yaw) -> np.ndarray:
    """[8, 3] corners of a box standing on the ground, yawed about z."""
    w, l, h = size
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    return (_rot_z(np.rad2deg(yaw)) @ np.vstack([x, y, z])).T + center


def _objects(rng, n_objects: int):
    """The scene's objects at sample 0, drawn from ``rng``: (centres [N, 3],
    kinds [N], sizes [N, 3], yaws [N], velocities per sample [N, 3])."""
    radius = rng.uniform(6.0, 40.0, n_objects)
    bearing = rng.uniform(-np.pi, np.pi, n_objects)
    start = np.stack([radius * np.cos(bearing), radius * np.sin(bearing),
                      np.zeros(n_objects)], axis=1)
    kind = rng.randint(0, len(_SIZES), n_objects)
    size = np.array([_SIZES[k] for k in kind])
    start[:, 2] = size[:, 2] / 2
    yaw = rng.uniform(-np.pi, np.pi, n_objects)
    speed = rng.uniform(0.0, 1.5, n_objects)
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw),
                    np.zeros(n_objects)], axis=1)
    return start, kind, size, yaw, vel


def make_scene(n_samples: int = 10, cameras: int = 6, height: int = 900,
               width: int = 1600, n_objects: int = 36, seed: int = 0
               ) -> List[Tuple[dict, np.ndarray]]:
    """One scene: ``n_samples`` samples of the first ``cameras`` cameras of
    the rig, as (image info, [height, width, 3] uint8 BGR frame) pairs in
    sample-major order."""
    rng = np.random.RandomState(seed)
    sx, sy = width / 1600.0, height / 900.0
    intrinsic = np.array([[1266.0 * sx, 0, 816.0 * sx],
                          [0, 1266.0 * sy, 491.0 * sy], [0, 0, 1]])
    calib = np.concatenate([intrinsic, np.zeros((3, 1))], axis=1)
    start, _, size, yaw, vel = _objects(rng, n_objects)
    colours = rng.randint(40, 256, (n_objects, 3))
    bases = [rng.randint(0, 48, (height, width, 3)).astype(np.uint8)
             for _ in range(cameras)]

    out = []
    for t in range(n_samples):
        pose_trans = [EGO_STEP * t, 0.0, 0.0]
        pose_rot = [1.0, 0.0, 0.0, 0.0]
        centers = start + vel * t
        for k in range(cameras):
            r_cs = _rot_z(CAMERAS[k][1]) @ _R_FRONT
            cs_rot = _quaternion(r_cs)
            cs_trans = (_rot_z(CAMERAS[k][1]) @ [1.0, 0.0, 0.0]
                        + [0.5, 0.0, 1.5]).tolist()
            trans = _matrix(pose_trans, pose_rot) @ _matrix(cs_trans, cs_rot)
            to_cam = np.linalg.inv(trans)
            img = bases[k].copy()
            depth = (to_cam[:3, :3] @ centers.T + to_cam[:3, 3:]).T[:, 2]
            for i in np.argsort(-depth):        # far boxes first
                pts = _corners(centers[i], size[i], yaw[i])
                cam = to_cam[:3, :3] @ pts.T + to_cam[:3, 3:]
                if (cam[2] < 1.0).any():
                    continue
                uv = (intrinsic @ cam)[:2] / cam[2]
                x0, y0 = np.clip(uv.min(axis=1), 0, [width, height]).astype(int)
                x1, y1 = np.clip(uv.max(axis=1), 0, [width, height]).astype(int)
                if x1 - x0 >= 2 and y1 - y0 >= 2:
                    img[y0:y1, x0:x1] = colours[i]
            info = {
                "id": t * cameras + k + 1, "video_id": 1, "frame_id": t + 1,
                "sensor_id": k + 1, "sample_token": f"sample_{t}",
                "file_name": f"{CAMERAS[k][0]}/{t:04d}.jpg",
                "width": width, "height": height,
                "calib": calib.tolist(), "trans_matrix": trans.tolist(),
                "cs_record_rot": cs_rot, "cs_record_trans": cs_trans,
                "pose_record_rot": pose_rot, "pose_record_trans": pose_trans,
            }
            out.append((info, img))
    return out


def make_tables(n_samples: int = 10, n_objects: int = 36, seed: int = 0
                ) -> Dict[str, list]:
    """The ground truth of ``make_scene`` (same ``n_samples``,
    ``n_objects`` and ``seed``) as v1.0 tables: one scene ``scene-0001``,
    its samples ``sample_<t>`` chained by ``next``, one instance per object
    and every object annotated at its global centre in every sample."""
    start, kind, size, yaw, vel = _objects(np.random.RandomState(seed),
                                           n_objects)
    tables = {
        "category": [{"token": f"category_{k}", "name": name}
                     for k, name in enumerate(_CATEGORIES)],
        "instance": [{"token": f"instance_{i}",
                      "category_token": f"category_{kind[i]}",
                      "nbr_annotations": n_samples}
                     for i in range(n_objects)],
        "scene": [{"token": "scene_1", "name": "scene-0001",
                   "nbr_samples": n_samples,
                   "first_sample_token": "sample_0",
                   "last_sample_token": f"sample_{n_samples - 1}"}],
        "sample": [{"token": f"sample_{t}", "scene_token": "scene_1",
                    "prev": f"sample_{t - 1}" if t else "",
                    "next": f"sample_{t + 1}" if t < n_samples - 1 else ""}
                   for t in range(n_samples)],
        "sample_annotation": [],
    }
    for t in range(n_samples):
        centers = start + vel * t
        for i in range(n_objects):
            tables["sample_annotation"].append({
                "token": f"annotation_{t}_{i}", "sample_token": f"sample_{t}",
                "instance_token": f"instance_{i}",
                "translation": centers[i].tolist(),
                "size": list(size[i]),
                "rotation": _quaternion(_rot_z(np.rad2deg(yaw[i])))})
    return tables
