"""COCO-format video dataset, the counterpart of
``deft_tpu/data/generic_dataset.py``: the index (``test.py`` reads it) and
the fixed-shape training samples (``__getitem__``, ``:183-481``).

A sample is what the JAX class assembles, key for key: random crop, scale
and flip; the affine warp of the frame and eigen-lighting colour
augmentation; the previous frame of the CenterTrack conditioning pair
(``pre_img``, with ``hm_disturb`` / ``lost_disturb`` / ``fp_disturb``
applied to its detections) and of the AFE appearance pair (``pre_image``,
shuffled centres, the [N+1, N+1] labels with the false row and column and
the validity masks); and the targets (gaussian heatmaps, ind/cat/mask,
wh/reg/tracking/ltrb/ltrb_amodal, rotation bins, depth, dimensions, amodal
offsets, nuScenes attributes and velocity).  Images are HWC float32, AFE
centres [max_object, 2] in [-1, 1].

Every random draw is the JAX class's, on the same generators in the same
order (``np.random``, ``random`` and ``self._data_rng``), so one seed gives
one sample in both packages.  Two things differ, because the port needs no
cv2 (the machine with the card has had it, but nothing may rely on it):
frames are read with ``data/image_io.imread`` (cv2 where it imports, else
PIL, else the standard library), and the warp is ``ops/warp.py::
warp_affine_uint8``, numpy in cv2's arithmetic (within one uint8 step of
``cv2.warpAffine``, any rotation).
"""

from __future__ import annotations

import math
import os
import random
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from deft_tpu_torch.data.coco_index import CocoIndex
from deft_tpu_torch.data.datasets import (EIG_VAL, EIG_VEC, MEAN,
                                          NUSCENES_ATT_RANGE, STD)
from deft_tpu_torch.data.image_io import imread
from deft_tpu_torch.ops.affine import affine_transform, get_affine_transform
from deft_tpu_torch.ops.gaussian import draw_gaussian, gaussian_radius
from deft_tpu_torch.ops.warp import warp_affine_uint8


# ---- color augmentation (image.py:222-258) --------------------------------

def _grayscale(image):
    return image[..., 0] * 0.114 + image[..., 1] * 0.587 + image[..., 2] * 0.299


def color_aug(data_rng: np.random.RandomState, image: np.ndarray):
    """In-place eigen-lighting + brightness/contrast/saturation jitter.

    Matches the reference's (CornerNet-derived) augmentation; `image` is
    float BGR in [0, 1].  All three jitters are affine in (image, gs,
    gs_mean) with gs fixed up front, so their shuffled composition is folded
    symbolically into ONE fused pass (same math, ~3x fewer full-image
    sweeps -- this runs per sample per frame in the input pipeline).
    """
    functions = ["brightness", "contrast", "saturation"]
    random.shuffle(functions)
    gs = _grayscale(image)
    gs_mean = gs.mean()
    # compose: image' = A*image + B*gs + C  (per shuffled application order)
    A, B, C = 1.0, 0.0, 0.0
    for f in functions:
        alpha = 1.0 + data_rng.uniform(low=-0.4, high=0.4)
        A *= alpha
        B *= alpha
        C *= alpha
        if f == "contrast":
            C += (1.0 - alpha) * gs_mean
        elif f == "saturation":
            B += 1.0 - alpha
    lighting = EIG_VEC @ (EIG_VAL * data_rng.normal(scale=0.1, size=(3,)))
    image *= A
    if B != 0.0:
        image += (np.float32(B) * gs)[:, :, None]
    image += (np.float32(C) + lighting.astype(np.float32))


class GenericDataset:
    """Iterable over fixed-shape sample dicts (see module docstring)."""

    # subclass contract (mirrors the reference class attributes)
    num_categories: int = 1
    default_resolution = (512, 512)
    class_name: Tuple[str, ...] = ("",)
    cat_ids: Dict[int, int] = {1: 1}
    max_objs: int = 128
    rest_focal_length = 1200

    def __init__(self, cfg, split: str, ann_path: Optional[str] = None,
                 img_dir: Optional[str] = None,
                 coco: Optional[CocoIndex] = None):
        self.cfg = cfg
        self.split = split
        self._data_rng = np.random.RandomState(123)
        self.img_dir = img_dir
        if coco is not None:
            self.coco = coco
        elif ann_path is not None:
            self.coco = CocoIndex(ann_path)
        else:
            self.coco = None
        if self.coco is not None:
            self.images = self.coco.get_img_ids()
            if cfg.tracking or cfg.afe:
                self.video_to_images = self.coco.ensure_video_index()
        self.max_object = cfg.max_object

    def __len__(self):
        return len(self.images)

    def __getstate__(self):
        """Picklable for spawned loader workers: the decoded-frame cache and
        its lock stay behind (each worker builds its own)."""
        state = self.__dict__.copy()
        for k in ("_frame_cache", "_frame_cache_lock", "_frame_cache_bytes"):
            state.pop(k, None)
        return state

    # ---- raw IO -------------------------------------------------------------

    # decoded-frame LRU: tracking samples re-read each frame ~3x (current,
    # pre-pair, AFE-pair, across neighboring samples); capped by byte budget
    _frame_cache_budget = 192 * 1024 * 1024

    def _load_image_anns(self, img_id):
        info = self.coco.load_img(img_id)
        img_path = os.path.join(self.img_dir, info["file_name"])
        anns = [dict(a) for a in self.coco.load_anns_for_img(img_id)]
        cache = getattr(self, "_frame_cache", None)
        if cache is None:
            cache = self._frame_cache = OrderedDict()
            self._frame_cache_bytes = 0
            self._frame_cache_lock = threading.Lock()
        with self._frame_cache_lock:
            img = cache.get(img_id)
            if img is not None:
                cache.move_to_end(img_id)
        if img is None:
            img = imread(img_path)
            if img is not None:
                with self._frame_cache_lock:
                    if img_id not in cache:
                        cache[img_id] = img
                        self._frame_cache_bytes += img.nbytes
                        while self._frame_cache_bytes > self._frame_cache_budget:
                            _, old = cache.popitem(last=False)
                            self._frame_cache_bytes -= old.nbytes
        return img, anns, info, img_path

    def _load_data(self, index):
        return self._load_image_anns(self.images[index])

    # ---- frame-pair sampling (generic_dataset.py:305-417) --------------------

    def _sample_related_frame(self, video_id, frame_id, sensor_id, max_dist,
                              signed: bool):
        infos = self.video_to_images[video_id]

        def ok_sensor(ii):
            return "sensor_id" not in ii or ii["sensor_id"] == sensor_id

        if "train" in self.split:
            if signed:  # strictly earlier (conditioning pair)
                cands = [ii for ii in infos
                         if 0 < frame_id - ii["frame_id"] < max_dist and ok_sensor(ii)]
            else:       # either direction (AFE pair)
                cands = [ii for ii in infos
                         if 0 < abs(ii["frame_id"] - frame_id) <= max_dist
                         and ok_sensor(ii)]
        else:
            cands = [ii for ii in infos
                     if ii["frame_id"] - frame_id == -1 and ok_sensor(ii)]
        if not cands:
            cands = [ii for ii in infos
                     if ii["frame_id"] == frame_id and ok_sensor(ii)]
        choice = cands[np.random.choice(len(cands))]
        img, anns, _, _ = self._load_image_anns(choice["id"])
        return img, anns, abs(frame_id - choice["frame_id"])

    # ---- augmentation params (generic_dataset.py:453-475) --------------------

    def _get_border(self, border, size):
        i = 1
        while size - border // i <= border // i:
            i *= 2
        return border // i

    def _get_aug_param(self, c, s, width, height, disturb=False):
        cfg = self.cfg
        c = c.copy()
        if (not cfg.not_rand_crop) and not disturb:
            aug_s = np.random.choice(np.arange(0.6, 1.4, 0.1))
            w_border = self._get_border(128, width)
            h_border = self._get_border(128, height)
            c[0] = np.random.randint(low=w_border, high=width - w_border)
            c[1] = np.random.randint(low=h_border, high=height - h_border)
        else:
            sf, cf = cfg.scale, cfg.shift
            c[0] += s * np.clip(np.random.randn() * cf, -2 * cf, 2 * cf)
            c[1] += s * np.clip(np.random.randn() * cf, -2 * cf, 2 * cf)
            aug_s = np.clip(np.random.randn() * sf + 1, 1 - sf, 1 + sf)
        rot = 0
        if np.random.random() < cfg.aug_rot:
            rf = cfg.rotate
            rot = np.clip(np.random.randn() * rf, -rf * 2, rf * 2)
        return c, aug_s, rot

    def _flip_anns(self, anns, width):
        for a in anns:
            bbox = a["bbox"]
            a["bbox"] = [width - bbox[0] - 1 - bbox[2], bbox[1], bbox[2], bbox[3]]
            if "rot" in self.cfg.heads and "alpha" in a:
                a["alpha"] = (np.pi - a["alpha"] if a["alpha"] > 0
                              else -np.pi - a["alpha"])
            if "amodel_offset" in self.cfg.heads and "amodel_center" in a:
                a["amodel_center"][0] = width - a["amodel_center"][0] - 1
            if self.cfg.velocity and "velocity" in a:
                a["velocity"] = [-10000, -10000, -10000]
        return anns

    # ---- input image (generic_dataset.py:565-578) ----------------------------

    def _get_input(self, img, trans_input):
        cfg = self.cfg
        inp = warp_affine_uint8(img, trans_input, cfg.input_w, cfg.input_h)
        inp_org = inp.copy()
        inp = inp.astype(np.float32) / 255.0
        if self.split == "train" and not cfg.no_color_aug:
            color_aug(self._data_rng, inp)
        inp = (inp - MEAN) / STD
        return inp, inp_org  # HWC

    # ---- previous-frame detections + disturb (generic_dataset.py:477-531) ----

    def _get_pre_dets(self, anns, trans_input):
        cfg = self.cfg
        hm_h, hm_w = cfg.input_h, cfg.input_w
        down = cfg.down_ratio
        pre_hm = np.zeros((hm_h, hm_w), np.float32) if cfg.pre_hm else None
        pre_cts, track_ids = [], []
        for ann in anns:
            cls_id = int(self.cat_ids[ann["category_id"]])
            if (cls_id > cfg.num_classes or cls_id <= -99
                    or ann.get("iscrowd", 0) > 0):
                continue
            bbox = self._coco_box_to_bbox(ann["bbox"])
            bbox[:2] = affine_transform(bbox[:2], trans_input)
            bbox[2:] = affine_transform(bbox[2:], trans_input)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, hm_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, hm_h - 1)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if h <= 0 or w <= 0:
                continue
            radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(w)))))
            ct0 = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                           np.float32)
            ct = ct0.copy()
            ct[0] += np.random.randn() * cfg.hm_disturb * w
            ct[1] += np.random.randn() * cfg.hm_disturb * h
            conf = 1 if np.random.random() > cfg.lost_disturb else 0
            pre_cts.append((ct if conf == 0 else ct0) / down)
            track_ids.append(ann.get("track_id", -1))
            if pre_hm is not None:
                draw_gaussian(pre_hm, ct.astype(np.int32), radius, k=conf)
                if np.random.random() < cfg.fp_disturb:
                    ct2 = ct0.copy()
                    ct2[0] += np.random.randn() * 0.05 * w
                    ct2[1] += np.random.randn() * 0.05 * h
                    draw_gaussian(pre_hm, ct2.astype(np.int32), radius, k=conf)
        return pre_hm, pre_cts, track_ids

    # ---- AFE pair boxes (generic_dataset.py:420-450 + image.py:305-378) ------

    def _get_afe_boxes(self, anns, trans_input):
        cfg = self.cfg
        hm_h, hm_w = cfg.input_h, cfg.input_w
        boxes, track_ids = [], []
        for ann in anns:
            cls_id = int(self.cat_ids[ann["category_id"]])
            if (cls_id > cfg.num_classes or cls_id <= -99
                    or ann.get("iscrowd", 0) > 0):
                continue
            bbox = self._coco_box_to_bbox(ann["bbox"])
            bbox[:2] = affine_transform(bbox[:2], trans_input)
            bbox[2:] = affine_transform(bbox[2:], trans_input)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, hm_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, hm_h - 1)
            if bbox[3] - bbox[1] > 0 and bbox[2] - bbox[0] > 0:
                boxes.append(bbox.copy())
                track_ids.append(ann.get("track_id", -1))
        return boxes, track_ids

    def _format_afe_pair(self, boxes_pre, ids_pre, boxes_next, ids_next):
        """Pairing labels + shuffled fixed-shape centers.

        Reproduces ToPercentCoordinates -> ResizeShuffleBoxes -> FormatBoxes:
        shuffle real boxes into max_object slots, pad with out-of-range 1.5
        centers, build the [N+1, N+1] label matrix with false row/col, and the
        [N+1] validity masks (last entry always true).
        """
        cfg = self.cfg
        n = self.max_object
        boxes_pre = np.asarray(boxes_pre, np.float32).reshape(-1, 4)
        boxes_next = np.asarray(boxes_next, np.float32).reshape(-1, 4)
        ids_pre = np.asarray(ids_pre).reshape(-1)
        ids_next = np.asarray(ids_next).reshape(-1)

        labels = (ids_pre[:, None] == ids_next[None, :]) if (
            len(ids_pre) and len(ids_next)
        ) else np.zeros((len(ids_pre), len(ids_next)), bool)
        labels = np.pad(
            labels,
            ((0, n - labels.shape[0]), (0, n - labels.shape[1])),
            constant_values=False,
        )

        def centers_of(boxes, count):
            out = np.full((n, 2), 1.5, np.float32)  # padded slots out of range
            if count:
                cx = (boxes[:, 0] + boxes[:, 2]) / cfg.input_w - 1.0
                cy = (boxes[:, 1] + boxes[:, 3]) / cfg.input_h - 1.0
                out[:count, 0] = cx
                out[:count, 1] = cy
            return out

        perm_pre = np.random.permutation(n)
        perm_next = np.random.permutation(n)
        c_pre = centers_of(boxes_pre, len(ids_pre))[perm_pre]
        c_next = centers_of(boxes_next, len(ids_next))[perm_next]
        labels = labels[perm_pre][:, perm_next]
        mask_pre = (perm_pre < len(ids_pre)).astype(np.float32)
        mask_next = (perm_next < len(ids_next)).astype(np.float32)

        false_pre = ((labels.sum(1) == 0) & (mask_pre > 0)).astype(np.float32)
        false_next = ((labels.sum(0) == 0) & (mask_next > 0)).astype(np.float32)
        labels = np.concatenate([labels.astype(np.float32),
                                 false_pre[:, None]], axis=1)
        labels = np.concatenate(
            [labels, np.append(false_next, 0.0)[None, :]], axis=0
        )
        mask_pre = np.append(mask_pre, 1.0).astype(np.float32)
        mask_next = np.append(mask_next, 1.0).astype(np.float32)
        return c_pre, c_next, labels, mask_pre, mask_next

    # ---- target assembly -----------------------------------------------------

    def _coco_box_to_bbox(self, box):
        return np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]],
                        np.float32)

    def _get_bbox_output(self, bbox, trans_output):
        cfg = self.cfg
        bbox = self._coco_box_to_bbox(bbox).copy()
        rect = np.array(
            [[bbox[0], bbox[1]], [bbox[0], bbox[3]],
             [bbox[2], bbox[3]], [bbox[2], bbox[1]]], np.float32,
        )
        for t in range(4):
            rect[t] = affine_transform(rect[t], trans_output)
        bbox[:2] = rect[:, 0].min(), rect[:, 1].min()
        bbox[2:] = rect[:, 0].max(), rect[:, 1].max()
        bbox_amodal = bbox.copy()
        bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, cfg.output_w - 1)
        bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, cfg.output_h - 1)
        return bbox, bbox_amodal

    def _init_ret(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        m = self.max_objs * cfg.dense_reg
        ret = {
            "hm": np.zeros((cfg.output_h, cfg.output_w, cfg.num_classes),
                           np.float32),
            "ind": np.zeros((m,), np.int32),
            "cat": np.zeros((m,), np.int32),
            "mask": np.zeros((m,), np.float32),
        }
        dims = {"reg": 2, "wh": 2, "tracking": 2, "ltrb": 4, "ltrb_amodal": 4,
                "nuscenes_att": 8, "velocity": 3, "dep": 1, "dim": 3,
                "amodel_offset": 2}
        for head, d in dims.items():
            if head in cfg.heads:
                ret[head] = np.zeros((m, d), np.float32)
                ret[f"{head}_mask"] = np.zeros((m, d), np.float32)
        if "rot" in cfg.heads:
            ret["rotbin"] = np.zeros((m, 2), np.int32)
            ret["rotres"] = np.zeros((m, 2), np.float32)
            ret["rot_mask"] = np.zeros((m,), np.float32)
        return ret

    def _get_calib(self, img_info, width, height):
        if "calib" in img_info:
            return np.array(img_info["calib"], np.float32)
        return np.array(
            [[self.rest_focal_length, 0, width / 2, 0],
             [0, self.rest_focal_length, height / 2, 0],
             [0, 0, 1, 0]], np.float32,
        )

    def _mask_ignore_or_crowd(self, ret, cls_id, bbox):
        sl = np.s_[int(bbox[1]): int(bbox[3]) + 1,
                   int(bbox[0]): int(bbox[2]) + 1]
        if cls_id == 0:
            np.maximum(ret["hm"][sl], 1.0, out=ret["hm"][sl])
        else:
            region = ret["hm"][sl + (abs(cls_id) - 1,)]
            np.maximum(region, 1.0, out=region)

    def _add_rot(self, ret, ann, k):
        if "alpha" not in ann:
            return
        ret["rot_mask"][k] = 1
        alpha = ann["alpha"]
        if alpha < np.pi / 6.0 or alpha > 5 * np.pi / 6.0:
            ret["rotbin"][k, 0] = 1
            ret["rotres"][k, 0] = alpha - (-0.5 * np.pi)
        if alpha > -np.pi / 6.0 or alpha < -5 * np.pi / 6.0:
            ret["rotbin"][k, 1] = 1
            ret["rotres"][k, 1] = alpha - (0.5 * np.pi)

    def _add_instance(self, ret, k, cls_id, bbox, bbox_amodal, ann,
                      trans_output, aug_s, pre_cts=None, track_ids=None):
        cfg = self.cfg
        h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if h <= 0 or w <= 0:
            return
        radius = max(0, int(gaussian_radius((math.ceil(h), math.ceil(w)))))
        ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                      np.float32)
        ct_int = ct.astype(np.int32)
        ret["cat"][k] = cls_id - 1
        ret["mask"][k] = 1
        if "wh" in ret:
            ret["wh"][k] = w, h
            ret["wh_mask"][k] = 1
        ret["ind"][k] = ct_int[1] * cfg.output_w + ct_int[0]
        ret["reg"][k] = ct - ct_int
        ret["reg_mask"][k] = 1
        draw_gaussian(ret["hm"][:, :, cls_id - 1], ct_int, radius)

        if "tracking" in cfg.heads and track_ids and ann.get("track_id") in track_ids:
            pre_ct = pre_cts[track_ids.index(ann["track_id"])]
            ret["tracking_mask"][k] = 1
            # the displacement head is intentionally trained to zero in DEFT
            # (generic_dataset.py:750; see SURVEY.md §2.5)
            ret["tracking"][k] = 0 * (pre_ct - ct_int)

        if "ltrb" in cfg.heads:
            ret["ltrb"][k] = (bbox[0] - ct_int[0], bbox[1] - ct_int[1],
                              bbox[2] - ct_int[0], bbox[3] - ct_int[1])
            ret["ltrb_mask"][k] = 1
        if "ltrb_amodal" in cfg.heads:
            ret["ltrb_amodal"][k] = (
                bbox_amodal[0] - ct_int[0], bbox_amodal[1] - ct_int[1],
                bbox_amodal[2] - ct_int[0], bbox_amodal[3] - ct_int[1])
            ret["ltrb_amodal_mask"][k] = 1
        if "nuscenes_att" in cfg.heads:
            if ann.get("attributes", 0) > 0:
                att = int(ann["attributes"] - 1)
                ret["nuscenes_att"][k][att] = 1
                ret["nuscenes_att_mask"][k][NUSCENES_ATT_RANGE[att]] = 1
        if "velocity" in cfg.heads:
            if "velocity" in ann and min(ann["velocity"]) > -1000:
                ret["velocity"][k] = np.array(ann["velocity"], np.float32)[:3]
                ret["velocity_mask"][k] = 1
        if "rot" in cfg.heads:
            self._add_rot(ret, ann, k)
        if "dep" in cfg.heads and "depth" in ann:
            ret["dep_mask"][k] = 1
            ret["dep"][k] = ann["depth"] * aug_s
        if "dim" in cfg.heads and "dim" in ann:
            ret["dim_mask"][k] = 1
            ret["dim"][k] = ann["dim"]
        if "amodel_offset" in cfg.heads and "amodel_center" in ann:
            amodel_center = affine_transform(ann["amodel_center"], trans_output)
            ret["amodel_offset_mask"][k] = 1
            ret["amodel_offset"][k] = amodel_center - ct_int

    # ---- main entry ----------------------------------------------------------

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img, anns, img_info, _ = self._load_data(index)
        height, width = img.shape[0], img.shape[1]
        c = np.array([width / 2.0, height / 2.0], np.float32)
        s = max(height, width) * 1.0 if not cfg.not_max_crop else np.array(
            [width, height], np.float32
        )
        aug_s, rot, flipped = 1, 0, 0
        if self.split == "train":
            c, aug_s, rot = self._get_aug_param(c, s, width, height)
            s = s * aug_s
            if np.random.random() < cfg.flip:
                flipped = 1
                img = img[:, ::-1, :]
                anns = self._flip_anns(anns, width)

        trans_input = get_affine_transform(c, s, rot, [cfg.input_w, cfg.input_h])
        trans_output = get_affine_transform(c, s, rot, [cfg.output_w, cfg.output_h])
        inp, _ = self._get_input(img, trans_input)
        ret: Dict[str, np.ndarray] = {"image": inp}

        sensor_id = img_info.get("sensor_id", 1)
        pre_cts, track_ids = None, None
        if cfg.tracking:
            pre_image, pre_anns, frame_dist = self._sample_related_frame(
                img_info["video_id"], img_info["frame_id"], sensor_id,
                cfg.max_frame_dist, signed=True,
            )
            if flipped:
                pre_image = pre_image[:, ::-1, :].copy()
                pre_anns = self._flip_anns(pre_anns, width)
            if cfg.same_aug_pre and frame_dist != 0:
                trans_input_pre = trans_input
            else:
                c_pre, aug_s_pre, _ = self._get_aug_param(
                    c, s, width, height, disturb=True
                )
                trans_input_pre = get_affine_transform(
                    c_pre, s * aug_s_pre, rot, [cfg.input_w, cfg.input_h]
                )
            pre_img, _ = self._get_input(pre_image, trans_input_pre)
            pre_hm, pre_cts, track_ids = self._get_pre_dets(
                pre_anns, trans_input_pre
            )
            ret["pre_img"] = pre_img
            if cfg.pre_hm:
                ret["pre_hm"] = pre_hm[..., None]

        if cfg.afe:
            afe_image, afe_anns, _ = self._sample_related_frame(
                img_info["video_id"], img_info["frame_id"], sensor_id,
                cfg.max_frame_dist_afe, signed=False,
            )
            if flipped:
                afe_image = afe_image[:, ::-1, :].copy()
                afe_anns = self._flip_anns(afe_anns, width)
            pre_image_afe, _ = self._get_input(afe_image, trans_input)
            boxes_pre, ids_pre = self._get_afe_boxes(afe_anns, trans_input)
            boxes_next, ids_next = self._get_afe_boxes(anns, trans_input)
            c_pre, c_next, labels, mask_pre, mask_next = self._format_afe_pair(
                boxes_pre, ids_pre, boxes_next, ids_next
            )
            ret["pre_image"] = pre_image_afe
            ret["centers_pre"] = c_pre
            ret["centers_next"] = c_next
            ret["labels"] = labels
            ret["mask_pre"] = mask_pre
            ret["mask_next"] = mask_next

        targets = self._init_ret()
        ret.update(targets)
        calib = self._get_calib(img_info, width, height)

        num_objs = min(len(anns), self.max_objs)
        for k in range(num_objs):
            ann = anns[k]
            cls_id = int(self.cat_ids[ann["category_id"]])
            if cls_id > cfg.num_classes or cls_id <= -999:
                continue
            bbox, bbox_amodal = self._get_bbox_output(ann["bbox"], trans_output)
            if cls_id <= 0 or ann.get("iscrowd", 0) > 0:
                self._mask_ignore_or_crowd(ret, cls_id, bbox)
                continue
            self._add_instance(ret, k, cls_id, bbox, bbox_amodal, ann,
                               trans_output, aug_s, pre_cts, track_ids)
        return ret
