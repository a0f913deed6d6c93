"""KITTI tracking -> COCO-video json converter, copied from
``tools/convert_kittitrack_to_coco.py`` (numpy only; the port keeps its own
copy).

Equivalent of the reference ``src/tools/convert_kittitrack_to_coco.py``:
parses ``label_02/<seq>.txt`` (frame, track_id, type, truncated, occluded,
alpha, bbox x4, dim hwl, loc xyz, rotation_y) and ``calib/<seq>.txt`` (P2),
emits ``annotations/tracking_{train,val,train_half,val_half,test}.json`` with
the 3-D fields the ddd heads train on (alpha, dim, depth, location,
rotation_y, amodel_center).

Category mapping matches the dataset class (kitti_tracking.py:28):
Pedestrian/Car/Cyclist -> 1/2/3, Van/Truck -> -2 (ignore-as-neighbor),
Person_sitting -> -1, Tram/Misc -> -9999, DontCare -> 0.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CATS = {"Pedestrian": 1, "Car": 2, "Cyclist": 3, "Van": 4, "Truck": 5,
        "Person": 6, "Person_sitting": 6, "Tram": 7, "Misc": 8, "DontCare": 9}
# which sequences form the conventional train/val split (CenterTrack uses
# even/odd; "3dop"-style subsets also seen). We expose full + halves.
IMG_W, IMG_H = 1242, 375


def read_calib(path):
    with open(path) as f:
        for line in f:
            if line.startswith("P2:"):
                vals = [float(x) for x in line.split()[1:]]
                return np.array(vals, np.float32).reshape(3, 4)
    return None


def project(pt3d, calib):
    p = calib @ np.array([pt3d[0], pt3d[1], pt3d[2], 1.0], np.float32)
    return [float(p[0] / p[2]), float(p[1] / p[2])]


def convert(data_dir: str, which: str):
    img_root = os.path.join(data_dir, "data_tracking_image_2",
                            "training" if which != "test" else "testing",
                            "image_02")
    label_root = os.path.join(data_dir, "label_02")
    calib_root = os.path.join(data_dir, "calib")
    seqs = sorted(os.listdir(img_root))

    ret = {"images": [], "annotations": [], "videos": [],
           "categories": [{"id": i, "name": n} for n, i in CATS.items()
                          if 1 <= i <= 3]}
    img_id = ann_id = 0
    for video_id, seq in enumerate(seqs, start=1):
        ret["videos"].append({"id": video_id, "file_name": seq})
        frames = sorted(os.listdir(os.path.join(img_root, seq)))
        calib_path = os.path.join(calib_root, f"{seq}.txt")
        calib = read_calib(calib_path) if os.path.exists(calib_path) else None

        frame_to_img = {}
        for fidx, fname in enumerate(frames):
            img_id += 1
            info = {
                "id": img_id,
                "file_name": f"{seq}/{fname}",
                "video_id": video_id,
                "frame_id": fidx + 1,
            }
            if calib is not None:
                info["calib"] = calib.tolist()
            ret["images"].append(info)
            frame_to_img[fidx] = img_id

        label_path = os.path.join(label_root, f"{seq}.txt")
        if not os.path.exists(label_path):
            continue
        with open(label_path) as f:
            for line in f:
                p = line.split()
                if len(p) < 17:
                    continue
                frame, tid, ctype = int(p[0]), int(p[1]), p[2]
                if frame not in frame_to_img:
                    continue
                cat_id = CATS.get(ctype, 9)
                truncated, occluded = float(p[3]), int(float(p[4]))
                alpha = float(p[5])
                bbox = [float(p[6]), float(p[7]), float(p[8]), float(p[9])]
                dim = [float(p[10]), float(p[11]), float(p[12])]  # h, w, l
                loc = [float(p[13]), float(p[14]), float(p[15])]
                rot_y = float(p[16])
                ann_id += 1
                amodel_center = (
                    project([loc[0], loc[1] - dim[0] / 2, loc[2]], calib)
                    if calib is not None else None
                )
                ann = {
                    "id": ann_id,
                    "image_id": frame_to_img[frame],
                    "category_id": cat_id,
                    "bbox": [bbox[0], bbox[1], bbox[2] - bbox[0],
                             bbox[3] - bbox[1]],
                    "area": (bbox[2] - bbox[0]) * (bbox[3] - bbox[1]),
                    "iscrowd": 0,
                    "track_id": tid + 1,
                    "alpha": alpha,
                    "dim": dim,
                    "location": loc,
                    "depth": loc[2],
                    "rotation_y": rot_y,
                    "truncated": truncated,
                    "occluded": occluded,
                }
                if amodel_center is not None:
                    ann["amodel_center"] = amodel_center
                ret["annotations"].append(ann)

    ann_dir = os.path.join(data_dir, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    name = {"train": "tracking_train", "test": "tracking_test"}[which]
    with open(os.path.join(ann_dir, f"{name}.json"), "w") as f:
        json.dump(ret, f)
    print(f"{name}: {len(ret['images'])} images, "
          f"{len(ret['annotations'])} annotations")

    if which == "train":
        # half-video protocol like MOT
        for part, sel in (("train_half", lambda fi, n: fi <= n // 2),
                          ("val_half", lambda fi, n: fi > n // 2)):
            frames_per_video = {}
            for im in ret["images"]:
                frames_per_video.setdefault(im["video_id"], 0)
                frames_per_video[im["video_id"]] = max(
                    frames_per_video[im["video_id"]], im["frame_id"])
            keep_imgs = {
                im["id"]
                for im in ret["images"]
                if sel(im["frame_id"], frames_per_video[im["video_id"]])
            }
            sub = {
                "images": [im for im in ret["images"] if im["id"] in keep_imgs],
                "annotations": [a for a in ret["annotations"]
                                if a["image_id"] in keep_imgs],
                "videos": ret["videos"],
                "categories": ret["categories"],
            }
            with open(os.path.join(ann_dir, f"tracking_{part}.json"), "w") as f:
                json.dump(sub, f)
            print(f"tracking_{part}: {len(sub['images'])} images")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/kitti_tracking")
    args = ap.parse_args(argv)
    convert(args.data_dir, "train")
    test_dir = os.path.join(args.data_dir, "data_tracking_image_2", "testing")
    if os.path.isdir(test_dir):
        convert(args.data_dir, "test")


if __name__ == "__main__":
    main()
