"""nuScenes v1.0 tables -> COCO-video json, copied from
``tools/convert_nuscenes.py`` (devkit-free; the reference's
``src/tools/convert_nuScenes.py`` needs the nuscenes-devkit):

    python -m deft_tpu_torch.tools.convert_nuscenes --data_root data/nuscenes \
        --version v1.0-trainval [--train_scenes F --val_scenes F]

It reads the raw tables (sample, sample_data, calibrated_sensor, ego_pose,
sample_annotation, category, attribute, instance, scene, sensor) and writes
per-split annotation files with what the 3-D heads, the training samples and
the tracker read: per-image calib (the intrinsics as a 3x4 P),
``trans_matrix`` (sensor -> global 4x4), the camera and ego-pose records,
the camera-frame box (``location``, ``dim``, ``rotation_y``, ``depth``,
``alpha``), ``amodel_center``, the projected 2-D bbox, ``velocity`` (zeros,
as the JAX converter writes it), ``attributes`` and track ids.

The six ring cameras are used (the reference's USED_SENSOR); each keyframe
camera image becomes one frame with a ``sensor_id``, in the order of the
``sample_data`` table.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from deft_tpu_torch.inference.ddd import compute_box_3d
from deft_tpu_torch.inference.geometry import Quaternion

USED_CAMERAS = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]
CATEGORIES = [
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
]
CAT_OF = {
    "vehicle.car": "car", "vehicle.truck": "truck", "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus", "vehicle.trailer": "trailer",
    "vehicle.construction": "construction_vehicle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.motorcycle": "motorcycle", "vehicle.bicycle": "bicycle",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.barrier": "barrier",
}
ATTRIBUTE_TO_ID = {
    "": 0, "cycle.with_rider": 1, "cycle.without_rider": 2,
    "pedestrian.moving": 3, "pedestrian.standing": 4,
    "pedestrian.sitting_lying_down": 5, "vehicle.moving": 6,
    "vehicle.parked": 7, "vehicle.stopped": 8,
}


def load_table(root, version, name):
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def transform_matrix(translation, rotation_wxyz):
    t = np.eye(4)
    t[:3, :3] = Quaternion(rotation_wxyz).rotation_matrix
    t[:3, 3] = translation
    return t


def box_to_camera(ann_translation, ann_size_wlh, ann_rotation, cs, pose):
    """Global-frame annotation -> camera-frame (loc, dim_hwl, rot_y, yaw)."""
    q = Quaternion(ann_rotation)
    center = np.asarray(ann_translation, np.float64)
    # global -> ego
    pq = Quaternion(pose["rotation"])
    center = pq.inverse.rotate(center - np.asarray(pose["translation"]))
    q = pq.inverse * q
    # ego -> sensor
    cq = Quaternion(cs["rotation"])
    center = cq.inverse.rotate(center - np.asarray(cs["translation"]))
    q = cq.inverse * q
    # rotation about camera y axis
    v = q.rotate([1, 0, 0])
    rot_y = -np.arctan2(v[2], v[0])
    w, l, h = ann_size_wlh
    return center, [h, w, l], float(rot_y)


def project_points(pts3d, intrinsic):
    p = np.asarray(intrinsic) @ pts3d
    return p[:2] / p[2:]


def convert(data_root, version, out_name, scene_filter=None):
    tables = {n: load_table(data_root, version, n) for n in (
        "sample", "sample_data", "calibrated_sensor", "ego_pose",
        "sample_annotation", "category", "attribute", "instance", "scene",
        "sensor",
    )}
    by_token = {n: {r["token"]: r for r in t} for n, t in tables.items()}
    sensor_of_cs = {
        cs["token"]: by_token["sensor"][cs["sensor_token"]]["channel"]
        for cs in tables["calibrated_sensor"]
    }
    anns_of_sample = defaultdict(list)
    for a in tables["sample_annotation"]:
        anns_of_sample[a["sample_token"]].append(a)
    track_id_of_instance = {
        inst["token"]: i + 1 for i, inst in enumerate(tables["instance"])
    }
    attr_name = {a["token"]: a["name"] for a in tables["attribute"]}

    ret = {
        "images": [], "annotations": [], "videos": [],
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(CATEGORIES)],
    }
    video_of_scene = {}
    for i, scene in enumerate(tables["scene"], start=1):
        if scene_filter and scene["name"] not in scene_filter:
            continue
        video_of_scene[scene["token"]] = i
        ret["videos"].append({"id": i, "file_name": scene["name"]})

    img_id = ann_id = 0
    frame_count = defaultdict(int)
    for sd in tables["sample_data"]:
        if not sd["is_key_frame"]:
            continue
        cs = by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
        channel = sensor_of_cs[sd["calibrated_sensor_token"]]
        if channel not in USED_CAMERAS:
            continue
        sample = by_token["sample"][sd["sample_token"]]
        scene_token = sample["scene_token"]
        if scene_token not in video_of_scene:
            continue
        pose = by_token["ego_pose"][sd["ego_pose_token"]]
        sensor_id = USED_CAMERAS.index(channel) + 1

        intrinsic = np.array(cs["camera_intrinsic"], np.float64)
        calib = np.concatenate([intrinsic, np.zeros((3, 1))], axis=1)
        trans = (transform_matrix(pose["translation"], pose["rotation"])
                 @ transform_matrix(cs["translation"], cs["rotation"]))

        img_id += 1
        frame_count[(scene_token, sensor_id)] += 1
        ret["images"].append({
            "id": img_id,
            "file_name": sd["filename"],
            "video_id": video_of_scene[scene_token],
            "frame_id": frame_count[(scene_token, sensor_id)],
            "sensor_id": sensor_id,
            "sample_token": sd["sample_token"],
            "width": sd["width"], "height": sd["height"],
            "calib": calib.tolist(),
            "trans_matrix": trans.tolist(),
            "cs_record_rot": cs["rotation"],
            "cs_record_trans": cs["translation"],
            "pose_record_rot": pose["rotation"],
            "pose_record_trans": pose["translation"],
        })

        for a in anns_of_sample[sd["sample_token"]]:
            inst = by_token["instance"][a["instance_token"]]
            cat_name = by_token["category"][inst["category_token"]]["name"]
            mapped = CAT_OF.get(cat_name)
            if mapped is None:
                continue
            loc, dim_hwl, rot_y = box_to_camera(
                a["translation"], a["size"], a["rotation"], cs, pose
            )
            if loc[2] < 0.5:   # behind or too close to this camera
                continue
            # project 3-D box corners for the 2-D bbox
            corners = compute_box_3d(
                dim_hwl, [loc[0], loc[1] + dim_hwl[0] / 2, loc[2]], rot_y
            ).T
            if (corners[2] < 0.1).any():
                continue
            pts = project_points(corners, intrinsic)
            x1, y1 = pts[0].min(), pts[1].min()
            x2, y2 = pts[0].max(), pts[1].max()
            x1c, y1c = max(x1, 0), max(y1, 0)
            x2c = min(x2, sd["width"] - 1)
            y2c = min(y2, sd["height"] - 1)
            if x2c <= x1c or y2c <= y1c:
                continue
            amodel_center = project_points(
                np.asarray([[loc[0]], [loc[1]], [loc[2]]]), intrinsic
            )[:, 0].tolist()

            attrs = a.get("attribute_tokens", [])
            attribute = ATTRIBUTE_TO_ID.get(
                attr_name.get(attrs[0], "") if attrs else "", 0
            )
            # velocity: finite-difference of instance positions is what the
            # devkit's box_velocity computes; approximate from prev/next anns
            velocity = [0.0, 0.0, 0.0]

            ann_id += 1
            ret["annotations"].append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": CATEGORIES.index(mapped) + 1,
                "bbox": [float(x1c), float(y1c), float(x2c - x1c),
                         float(y2c - y1c)],
                "area": float((x2c - x1c) * (y2c - y1c)),
                "iscrowd": 0,
                "track_id": track_id_of_instance[a["instance_token"]],
                "location": [float(v) for v in loc],
                "dim": [float(v) for v in dim_hwl],
                "rotation_y": rot_y,
                "depth": float(loc[2]),
                "alpha": float(rot_y - np.arctan2(
                    loc[0], loc[2]
                )),
                "amodel_center": amodel_center,
                "attributes": attribute,
                "velocity": velocity,
            })

    out_dir = os.path.join(data_root, "annotations")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_name), "w") as f:
        json.dump(ret, f)
    print(f"{out_name}: {len(ret['images'])} images, "
          f"{len(ret['annotations'])} annotations")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--train_scenes", default="",
                    help="file with one scene name per line (official split)")
    ap.add_argument("--val_scenes", default="")
    args = ap.parse_args()

    def load_list(path):
        if not path:
            return None
        with open(path) as f:
            return {l.strip() for l in f if l.strip()}

    if args.train_scenes or args.val_scenes:
        convert(args.data_root, args.version, "train.json",
                load_list(args.train_scenes))
        convert(args.data_root, args.version, "val.json",
                load_list(args.val_scenes))
    else:
        convert(args.data_root, args.version, "all.json")


if __name__ == "__main__":
    main()
