"""Synthetic nuScenes scene generator (raw v1.0 schema), the port's copy of
the JAX repo's ``tools/make_synthetic_nuscenes.py``:

    python -m deft_tpu_torch.tools.make_synthetic_nuscenes \\
        --out data/nuscenes [--samples 8] [--width 800 --height 450]

Emits the ten schema tables ``convert_nuscenes`` reads (scene,
sample, sample_data, calibrated_sensor, ego_pose, sample_annotation,
category, attribute, instance, sensor) plus rendered camera JPEGs under
``v1.0-trainval/samples/CAM_{FRONT,BACK}/``, so the chain raw schema ->
converter -> dataset -> ``Detector`` -> per-class trackers -> submission
runs without the real dataset.  From the same flags it writes the same
tables, byte for byte (the same rows, built with the same arithmetic and
key order), and the same pixels, encoded by ``data/image_io.imwrite_jpeg``.
``data/synthetic_nuscenes.py`` is another scene (six cameras, PNG).

The scripted scene: a slowly moving ego with two ring cameras (CAM_FRONT,
CAM_BACK); two cars and a pedestrian ahead, one car behind, all moving at
constant velocity.  Boxes are rendered as solid colour rectangles at their
projected 2-D extents.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from deft_tpu_torch.data.image_io import imwrite_jpeg


def rot_to_quat(r):
    """3x3 rotation matrix -> (w, x, y, z)."""
    m = np.asarray(r, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return [0.25 * s, (m[2, 1] - m[1, 2]) / s,
                (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


# sensor->ego rotations: COLUMNS are the camera axes (x right, y down,
# z forward) expressed in the ego frame (x forward, y left, z up)
R_FRONT = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
R_BACK = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float64)

OBJECTS = [
    # (name, category, size (w, l, h), start xyz (global), velocity xyz)
    ("car_a", "vehicle.car", (1.9, 4.5, 1.6), (14.0, 2.5, 0.8), (1.2, 0.0, 0.0)),
    ("car_b", "vehicle.car", (1.9, 4.5, 1.6), (20.0, -3.0, 0.8), (-0.8, 0.3, 0.0)),
    ("ped_a", "human.pedestrian.adult", (0.6, 0.6, 1.7), (10.0, -1.5, 0.85),
     (0.2, 0.4, 0.0)),
    ("car_c", "vehicle.car", (1.9, 4.5, 1.6), (-12.0, 1.0, 0.8), (0.5, 0.0, 0.0)),
]
ATTR_OF = {"vehicle.car": "vehicle.moving",
           "human.pedestrian.adult": "pedestrian.moving"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/nuscenes")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=450)
    args = ap.parse_args(argv)
    generate(args.out, args.samples, args.width, args.height)


def generate(out, n_samples=8, width=800, height=450):
    version = "v1.0-trainval"
    root = os.path.join(out, version)
    os.makedirs(root, exist_ok=True)

    fx = fy = 500.0
    intrinsic = [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0],
                 [0.0, 0.0, 1.0]]

    sensors = [
        {"token": "sen_front", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "sen_back", "channel": "CAM_BACK", "modality": "camera"},
    ]
    cal = [
        {"token": "cs_front", "sensor_token": "sen_front",
         "translation": [1.5, 0.0, 1.6], "rotation": rot_to_quat(R_FRONT),
         "camera_intrinsic": intrinsic},
        {"token": "cs_back", "sensor_token": "sen_back",
         "translation": [-1.0, 0.0, 1.6], "rotation": rot_to_quat(R_BACK),
         "camera_intrinsic": intrinsic},
    ]
    categories = [{"token": f"cat_{n}", "name": n}
                  for n in ("vehicle.car", "human.pedestrian.adult")]
    attributes = [{"token": f"att_{n}", "name": n}
                  for n in ("vehicle.moving", "pedestrian.moving")]
    instances = [
        {"token": f"inst_{name}", "category_token": f"cat_{cat}",
         "nbr_annotations": n_samples}
        for name, cat, *_ in OBJECTS
    ]
    scene = [{"token": "scene_1", "name": "scene-0001",
              "nbr_samples": n_samples,
              "first_sample_token": "samp_0",
              "last_sample_token": f"samp_{n_samples - 1}"}]

    samples, sample_data, ego_poses, anns = [], [], [], []
    colors = {"car_a": (60, 60, 220), "car_b": (60, 220, 60),
              "ped_a": (220, 180, 40), "car_c": (200, 60, 200)}

    for t in range(n_samples):
        stok = f"samp_{t}"
        samples.append({
            "token": stok, "scene_token": "scene_1",
            "timestamp": 1_000_000 * t // 2,
            "prev": f"samp_{t - 1}" if t else "",
            "next": f"samp_{t + 1}" if t < n_samples - 1 else "",
        })
        ego_t = [0.5 * t, 0.0, 0.0]                    # slow forward ego
        ego_poses.append({
            "token": f"pose_{t}", "translation": ego_t,
            "rotation": [1.0, 0.0, 0.0, 0.0],
            "timestamp": 1_000_000 * t // 2,
        })

        # annotations (global frame)
        for name, cat, (w_, l_, h_), p0, v in OBJECTS:
            pos = [p0[0] + v[0] * 0.5 * t, p0[1] + v[1] * 0.5 * t,
                   p0[2] + v[2] * 0.5 * t]
            anns.append({
                "token": f"ann_{name}_{t}", "sample_token": stok,
                "instance_token": f"inst_{name}",
                "translation": pos, "size": [w_, l_, h_],
                "rotation": [1.0, 0.0, 0.0, 0.0],
                "attribute_tokens": [f"att_{ATTR_OF[cat]}"],
                "visibility_token": "4",
            })

        # images per camera
        for cs, pose_r in (("cs_front", R_FRONT), ("cs_back", R_BACK)):
            channel = "CAM_FRONT" if cs == "cs_front" else "CAM_BACK"
            fname = f"samples/{channel}/{channel}_{t:04d}.jpg"
            sample_data.append({
                "token": f"sd_{channel}_{t}", "sample_token": stok,
                "ego_pose_token": f"pose_{t}",
                "calibrated_sensor_token": cs,
                "filename": fname, "width": width, "height": height,
                "is_key_frame": True, "fileformat": "jpg",
            })

            img = np.full((height, width, 3), 90, np.uint8)
            cs_rec = cal[0] if cs == "cs_front" else cal[1]
            k = np.asarray(intrinsic)
            for name, cat, (w_, l_, h_), p0, v in OBJECTS:
                pos = np.array([p0[0] + v[0] * 0.5 * t,
                                p0[1] + v[1] * 0.5 * t,
                                p0[2] + v[2] * 0.5 * t])
                # global -> ego -> camera
                pe = pos - np.asarray(ego_t)
                pc = pose_r.T @ (pe - np.asarray(cs_rec["translation"]))
                if pc[2] < 1.0:
                    continue
                # project the 8 box corners (axis-aligned in global here);
                # a corner too close to the camera ends only the innermost
                # loop, and the box is then dropped by the count below
                dx, dy, dz = l_ / 2, w_ / 2, h_ / 2
                corners = []
                for sx in (-dx, dx):
                    for sy in (-dy, dy):
                        for sz in (-dz, dz):
                            cg = pos + np.array([sx, sy, sz])
                            ce = cg - np.asarray(ego_t)
                            cc = pose_r.T @ (
                                ce - np.asarray(cs_rec["translation"]))
                            if cc[2] < 0.2:
                                break
                            p = k @ cc
                            corners.append(p[:2] / p[2])
                if len(corners) != 8:
                    continue
                corners = np.array(corners)
                x1, y1 = corners.min(0)
                x2, y2 = corners.max(0)
                x1, y1 = max(int(x1), 0), max(int(y1), 0)
                x2, y2 = min(int(x2), width - 1), min(int(y2), height - 1)
                if x2 > x1 and y2 > y1:
                    img[y1:y2, x1:x2] = colors[name]
            path = os.path.join(root, fname)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            imwrite_jpeg(path, img)

    tables = {
        "scene": scene, "sample": samples, "sample_data": sample_data,
        "calibrated_sensor": cal, "ego_pose": ego_poses,
        "sample_annotation": anns, "category": categories,
        "attribute": attributes, "instance": instances, "sensor": sensors,
    }
    for name, table in tables.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(table, f)
    print(f"synthetic nuScenes at {root}: {n_samples} samples x 2 cameras, "
          f"{len(anns)} annotations")


if __name__ == "__main__":
    main()
