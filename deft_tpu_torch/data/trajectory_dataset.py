"""Trajectory dataset for the LSTM motion model's training, copied from
``deft_tpu/data/trajectory_dataset.py`` (the reference's
``trajectory_dataset.py``).

A sample picks a track visible across [index - max_dis, index +
max_dis_fut], builds its per-step motion features (11-d 2-D, 18-d 3-D in
the global frame, as the tracker's online features), drops about 10% of the
input frames at random (the reference's deliberate robustness noise), and
returns the future deltas as the target.  Its random draws are the JAX
package's, in the same order: ``random.randint`` for a new index and for
each frame's drop (skipped by short-circuit for the last two frames),
``np.random.choice`` for the track.  Windows run over consecutive image
ids, so a converted nuScenes file must list each camera's frames together.
"""

from __future__ import annotations

import os
from random import randint
from typing import Dict, List, Tuple

import numpy as np

from deft_tpu_torch.data.coco_index import CocoIndex
from deft_tpu_torch.data.datasets import (NUSCENES_TRACKING_CLASSES,
                                          get_dataset_info)
from deft_tpu_torch.inference.geometry import camera_box_to_global


class TrajectoryDataset:
    def __init__(self, cfg, split: str, ann_path=None, img_dir=None,
                 coco: CocoIndex = None):
        self.cfg = cfg
        self.split = split
        self.dataset = cfg.dataset
        info = get_dataset_info(cfg.dataset)
        self.cat_ids = dict(info.cat_ids)
        self.class_name = info.class_name
        if coco is not None:
            self.coco = coco
        else:
            if ann_path is None:
                ann_path, img_dir = default_paths(cfg, split)
            self.coco = CocoIndex(ann_path)
        self.images = self.coco.get_img_ids()
        self.video_to_images = self.coco.ensure_video_index()
        self.num_samples = len(self.images)

        if cfg.dataset == "nuscenes":
            self.max_dis, self.max_dis_fut = 10, 4
        else:
            self.max_dis, self.max_dis_fut = 10, 5

        self.gt_bboxes: Dict[int, List] = {}
        self.gt_track_ids: Dict[int, List] = {}
        self._valid_cache: Dict[int, List] = {}
        self._invalid = set()

    def __len__(self):
        return max(self.num_samples - self.max_dis_fut - 1, 1)

    # ---- per-frame GT boxes (trajectory_dataset.py:412-491) ------------------

    def _load_frame(self, index):
        img_id = self.images[index]
        info = self.coco.load_img(img_id)
        anns = self.coco.load_anns_for_img(img_id)
        return info, anns

    def _get_bboxes(self, anns, image_info):
        bboxes, track_ids = [], []
        if self.dataset == "nuscenes":
            for ann in anns:
                cls_id = int(self.cat_ids[ann["category_id"]])
                class_name = self.class_name[cls_id - 1]
                if class_name not in NUSCENES_TRACKING_CLASSES:
                    continue
                loc = ann["location"]
                wlh = ann["dim"]
                size = [float(wlh[1]), float(wlh[2]), float(wlh[0])]
                box = camera_box_to_global(
                    loc, size, ann["rotation_y"],
                    image_info["cs_record_rot"], image_info["cs_record_trans"],
                    image_info["pose_record_rot"], image_info["pose_record_trans"],
                )
                q = box.orientation
                angle = q.angle if q.axis[2] > 0 else -q.angle
                bboxes.append([size[2], size[0], size[1],
                               box.center[0], box.center[1], box.center[2],
                               angle])
                track_ids.append(ann["track_id"])
        else:
            for ann in anns:
                cls_id = int(self.cat_ids[ann["category_id"]])
                if (cls_id > self.cfg.num_classes or cls_id <= -99
                        or ann.get("iscrowd", 0) > 0):
                    continue
                b = ann["bbox"]
                bbox = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
                if bbox[3] - bbox[1] > 0 and bbox[2] - bbox[0] > 0:
                    bboxes.append(bbox)
                    track_ids.append(ann.get("track_id", -1))
        return bboxes, track_ids

    def _frame_gt(self, index):
        if index not in self.gt_bboxes:
            info, anns = self._load_frame(index)
            b, t = self._get_bboxes(anns, info)
            self.gt_bboxes[index] = b
            self.gt_track_ids[index] = t
        return self.gt_bboxes[index], self.gt_track_ids[index]

    def _index_valid(self, index) -> bool:
        """Whole window [index - max_dis, index + max_dis_fut] in one video."""
        info, _ = self._load_frame(index)
        frame_id = info["frame_id"]
        sensor = info.get("sensor_id", 1)
        frames = {
            ii["frame_id"] for ii in self.video_to_images[info["video_id"]]
            if "sensor_id" not in ii or ii["sensor_id"] == sensor
        }
        return (frame_id - self.max_dis in frames
                and frame_id + self.max_dis_fut in frames)

    def __getitem__(self, index) -> Tuple[np.ndarray, np.ndarray]:
        for _ in range(100):
            if (index < self.max_dis + 2 or index > len(self) - 2
                    or index in self._invalid):
                index = randint(self.max_dis + 2, max(len(self) - 2,
                                                      self.max_dis + 3))
                continue
            if index not in self._valid_cache:
                if not self._index_valid(index):
                    self._invalid.add(index)
                    continue
                common = None
                for ind in range(index - 2, index + self.max_dis_fut + 1):
                    _, tids = self._frame_gt(ind)
                    common = set(tids) if common is None else common & set(tids)
                self._valid_cache[index] = sorted(common) if common else []
            tracks = self._valid_cache[index]
            if not tracks:
                self._invalid.add(index)
                continue
            track_id = tracks[np.random.choice(len(tracks))]
            return self._build_pair(index, track_id)
        raise RuntimeError("could not find a valid trajectory sample")

    def _build_pair(self, index, track_id):
        if self.dataset == "nuscenes":
            return self._build_pair_3d(index, track_id)
        return self._build_pair_2d(index, track_id)

    def _build_pair_2d(self, index, track_id):
        last = None  # (t, cx, cy, h, w)
        traj = []
        t = -1
        for ind in range(index - self.max_dis, index + 1):
            t += 1
            bboxes, tids = self._frame_gt(ind)
            # keep the last two frames; drop ~10% of earlier ones
            if not (ind > index - 2 or randint(0, 10) < 9):
                continue
            if track_id not in tids:
                continue
            b = bboxes[tids.index(track_id)]
            c_x, c_y = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
            h, w = b[3] - b[1], b[2] - b[0]
            if last is None:
                d = [0.0] * 6
            else:
                lt, lcx, lcy, lh, lw = last
                dt = t - lt
                d = [(c_x - lcx) / dt, (c_y - lcy) / dt, h - lh, w - lw,
                     (c_x - lcx) / dt, (c_y - lcy) / dt]
            traj.append([c_x, c_y, d[0], d[1], h, w, w / h, d[2], d[3],
                         d[4], d[5]])
            last = (t, c_x, c_y, h, w)

        _, lcx, lcy, lh, lw = last
        out = []
        for ind in range(index + 1, index + self.max_dis_fut + 1):
            bboxes, tids = self._frame_gt(ind)
            b = bboxes[tids.index(track_id)]
            c_x, c_y = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
            h, w = b[3] - b[1], b[2] - b[0]
            out.append([c_x - lcx, c_y - lcy, h - lh, w - lw])
        return np.array(traj, np.float32), np.array(out, np.float32)

    def _build_pair_3d(self, index, track_id):
        last = None  # (t, box7)
        traj = []
        t = -1
        for ind in range(index - self.max_dis, index + 1):
            t += 1
            bboxes, tids = self._frame_gt(ind)
            if not (ind > index - 2 or randint(0, 10) < 9):
                continue
            if track_id not in tids:
                continue
            h, w, l, cx, cy, cz, rot = bboxes[tids.index(track_id)]
            if last is None:
                dh = dw = dl = vx = vy = vz = vr = dcx = dcy = dcz = dr = 0.0
            else:
                lt, (lh, lw, ll, lcx, lcy, lcz, lrot) = last
                dt = t - lt
                dh, dw, dl = h - lh, w - lw, l - ll
                vx, vy, vz = (cx - lcx) / dt, (cy - lcy) / dt, (cz - lcz) / dt
                vr = (rot - lrot) / dt
                dcx, dcy, dcz, dr = cx - lcx, cy - lcy, cz - lcz, rot - lrot
            traj.append([cx, cy, cz, dcx, dcy, dcz, h, w, l, dh, dw, dl,
                         vx, vy, vz, rot, dr, vr])
            last = (t, (h, w, l, cx, cy, cz, rot))

        _, (lh, lw, ll, lcx, lcy, lcz, lrot) = last
        out = []
        for ind in range(index + 1, index + self.max_dis_fut + 1):
            bboxes, tids = self._frame_gt(ind)
            h, w, l, cx, cy, cz, rot = bboxes[tids.index(track_id)]
            out.append([cx - lcx, cy - lcy, cz - lcz, rot - lrot])
        return np.array(traj, np.float32), np.array(out, np.float32)


def default_paths(cfg, split):
    info_name = cfg.dataset
    if info_name == "mot":
        year = int(cfg.dataset_version[:2]) if cfg.dataset_version else 17
        data_dir = os.path.join("data", f"mot{year}")
        ann = {"17halftrain": "train_half.json", "17halfval": "val_half.json"}.get(
            cfg.dataset_version, "train.json"
        )
        return os.path.join(data_dir, "annotations", ann), os.path.join(
            data_dir, "train"
        )
    if info_name == "kitti_tracking":
        data_dir = os.path.join("data", "kitti_tracking")
        ann_file = cfg.dataset_version or "train"
        return (
            os.path.join(data_dir, "annotations", f"tracking_{ann_file}.json"),
            os.path.join(data_dir, "data_tracking_image_2", "training", "image_02"),
        )
    if info_name == "nuscenes":
        data_dir = os.path.join("data", "nuscenes")
        return (
            os.path.join(data_dir, "annotations", f"{cfg.dataset_version}{split}.json"),
            os.path.join(data_dir, "v1.0-trainval"),
        )
    raise ValueError(f"no trajectory data for dataset {info_name}")
