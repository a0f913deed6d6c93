"""Per-frame inference runtime, copied from ``deft_tpu/inference/detector.py``
(MOT and nuScenes).

One frame: ``pre_process`` warps and normalizes it on the detector's device
(the separable two-matmul warp of ``ops/warp.py`` in place of the JAX
package's host ``cv2.warpAffine``; the port does not use cv2), ``process``
runs ``DEFTNet.detect`` (trunk with its DCNv2 kernels, heads, decode, AFE
embeddings), ``post_process`` maps the detections back to image pixels (and,
with the 3-D heads, to camera-frame boxes) on the host, and the tracker
evaluates the window similarity against its on-device ring and runs the
association cascade.  Embeddings stay on the device from ``detect`` to the
ring.

nuScenes runs one tracker per tracking class, all drawing ids from one
``IdAllocator`` and stepping one LSTM motion model, and ``run_multi`` takes
the six cameras of a sample through one batched ``detect``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deft_tpu_torch.config import Config
from deft_tpu_torch.data.datasets import (
    NUSCENES_TRACKING_CLASSES,
    get_dataset_info,
)
from deft_tpu_torch.inference.ddd import nms_greedy
from deft_tpu_torch.inference.geometry import camera_box_to_global
from deft_tpu_torch.inference.post_process import generic_post_process
from deft_tpu_torch.models.factory import create_model, resolve_device
from deft_tpu_torch.ops.affine import get_affine_transform
from deft_tpu_torch.ops.warp import separable_inverse_tf, warp_affine_separable
from deft_tpu_torch.tracking.basetrack import IdAllocator
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion
from deft_tpu_torch.tracking.tracker import STrack, Tracker

MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)

_LATER = "is not ported yet (ROADMAP.md, queue A)"


class Detector:
    """``state_dict``: the network's weights (else seeded ones);
    ``motion_state_dict``: the LSTM motion model's, where ``cfg.lstm``."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device="cuda", motion_state_dict: Optional[dict] = None):
        if cfg.dataset not in ("mot", "nuscenes"):
            raise NotImplementedError(f"dataset {cfg.dataset!r} {_LATER}")
        for flag in ("public_det", "debug", "embed_parity", "flip_test",
                     "load_model", "load_model_traj", "keep_res"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} {_LATER}")
        if cfg.fix_short > 0:
            raise NotImplementedError(f"fix_short {_LATER}")
        self.cfg = cfg
        self.dataset = cfg.dataset
        self.device = resolve_device(device)
        self.model = create_model(cfg.arch, cfg, self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.embed_dim = self.model.embed_dim
        self.info = get_dataset_info(cfg.test_dataset or cfg.dataset)
        self.rest_focal_length = (self.info.focal_length
                                  if cfg.test_focal_length < 0
                                  else cfg.test_focal_length)
        self.motion = (LSTMMotion(cfg.dataset, motion_state_dict,
                                  device=self.device) if cfg.lstm else None)
        self._mean = torch.as_tensor(MEAN, device=self.device)
        self._std = torch.as_tensor(STD, device=self.device)
        self.ids = IdAllocator()
        self.reset_tracking()

    # ---- lifecycle -----------------------------------------------------------

    def _make_tracker(self) -> Tracker:
        return Tracker(
            self.dataset, self.cfg.max_object, self.embed_dim,
            similarity_fn=self.model.window_similarity,
            use_lstm=self.cfg.lstm, motion=self.motion, ids=self.ids,
            track_buffer=self.cfg.track_buffer, device=self.device,
        )

    def reset_tracking(self):
        """Fresh trackers (and rings) for a new sequence: one per tracking
        class on nuScenes."""
        if self.dataset == "nuscenes":
            self.tracker = {c: self._make_tracker()
                            for c in NUSCENES_TRACKING_CLASSES}
        else:
            self.tracker = self._make_tracker()

    # ---- preprocessing (reference detector.py:346-422) ------------------------

    def _transform_scale(self, image, scale: float = 1.0):
        """Frame geometry under fix_res (reference detector.py:346-376; the
        only preprocessing this port runs): (image, c, s, inp_w, inp_h,
        height, width) with the frame's centre, its longer side and the
        config's input size."""
        if scale != 1.0:
            raise NotImplementedError(f"test scales != 1 {_LATER}")
        height, width = image.shape[:2]
        c = np.array([width / 2.0, height / 2.0], np.float32)
        s = max(height, width) * 1.0
        return (image, c, s, self.cfg.input_w, self.cfg.input_h, height,
                width)

    def _default_calib(self, width, height) -> np.ndarray:
        return np.array(
            [[self.rest_focal_length, 0, width / 2, 0],
             [0, self.rest_focal_length, height / 2, 0],
             [0, 0, 1, 0]], np.float32)

    def pre_process(self, image, input_meta: Optional[dict] = None):
        """image: [H, W, 3] uint8 frame (numpy or tensor) -> (normalized
        [1, inp_h, inp_w, 3] float32 on the device, meta).  ``input_meta``
        may hold the camera's [3, 4] ``calib``."""
        _, c, s, inp_w, inp_h, height, width = self._transform_scale(image)
        trans_input = get_affine_transform(c, s, 0, [inp_w, inp_h])
        frame = torch.as_tensor(image, device=self.device)[None]
        warped = warp_affine_separable(
            frame, separable_inverse_tf(c, s, inp_w, inp_h), inp_h, inp_w)
        images = (warped / 255.0 - self._mean) / self._std
        meta = {
            "calib": (np.array(input_meta["calib"], np.float32)
                      if input_meta and "calib" in input_meta
                      else self._default_calib(width, height)),
            "c": c, "s": s, "height": height, "width": width,
            "out_height": inp_h // self.cfg.down_ratio,
            "out_width": inp_w // self.cfg.down_ratio,
            "inp_height": inp_h, "inp_width": inp_w,
            "trans_input": trans_input,
        }
        return images, meta

    # ---- the per-frame program -----------------------------------------------

    @torch.no_grad()
    def process(self, images):
        """Device step over a batch [B, H, W, 3]: (dets dict of numpy
        [B, K, ...], embeddings [B, K, E] on the device)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        dets, emb = self.model.detect(images, k=self.cfg.K)
        return {k: v.cpu().numpy() for k, v in dets.items()}, emb

    def post_process(self, dets, meta):
        return generic_post_process(
            dets, [meta["c"]], [meta["s"]], meta["out_height"],
            meta["out_width"], self.cfg.out_thresh, [meta["calib"]],
        )[0]

    def _track(self, results, emb, image_info) -> List[STrack]:
        if self.dataset == "nuscenes":
            return self._update_nuscenes(results, emb, image_info)
        return self.tracker.update(results, emb)

    def run(self, image_or_frame, meta: Optional[dict] = None,
            image_info: Optional[dict] = None) -> List[STrack]:
        """Full frame step -> list of online tracks (reference
        detector.py:112-344).

        ``image_or_frame`` is a decoded [H, W, 3] uint8 frame, or the JAX
        ``run``'s prefetched form ``{"images": [1, H, W, 3] normalized,
        "meta": {...}}``; ``meta`` may hold the camera's ``calib``; nuScenes
        needs the frame's ``image_info`` (its camera and ego-pose records).
        """
        return self.run_multi([image_or_frame], [meta], [image_info])[0]

    def run_multi(self, images_or_frames, metas=None, image_infos=None,
                  materialize=None):
        """Same-shape frames (the six cameras of a nuScenes sample; each as
        ``run`` takes it) through ONE batched ``detect``, then the host
        branch per camera in order: the tracks of N sequential ``run``
        calls, one list per camera (``deft_tpu/inference/detector.py:
        326-370``).

        ``materialize``: applied to each camera's online list right after
        that camera's tracker update.  Track objects are live and later
        cameras' updates mutate them, so a caller that serializes tracks
        must do it through this hook, not after the return."""
        n = len(images_or_frames)
        metas = metas or [None] * n
        image_infos = image_infos or [None] * n
        batch, b_metas = [], []
        for img, meta in zip(images_or_frames, metas):
            if isinstance(img, str):
                raise NotImplementedError(
                    "reading image files needs an image decoder; pass the "
                    "decoded frame")
            if isinstance(img, dict):
                images, meta = img["images"], img["meta"]
            else:
                images, meta = self.pre_process(img, meta)
            batch.append(torch.as_tensor(images, dtype=torch.float32,
                                         device=self.device))
            b_metas.append(meta)
        dets, emb = self.process(torch.cat(batch))

        online_per_cam = []
        for b in range(n):
            dets_b = {k: v[b: b + 1] for k, v in dets.items()}
            results = self.post_process(dets_b, b_metas[b])
            online = self._track(results, emb[b][: len(results)],
                                 image_infos[b])
            online_per_cam.append(materialize(online) if materialize
                                  else online)
        return online_per_cam

    # ---- nuScenes per-class branch (reference detector.py:200-341) -----------

    def _update_nuscenes(self, results, emb, image_info) -> List[STrack]:
        """One camera's detections -> the per-class trackers: the tracking
        classes above a 0.3 score (0.35 for pedestrians), each box taken to
        the global frame through the camera's and the ego pose's records,
        per-class greedy NMS under ``cfg.nms``; ``emb`` is [n, E] on the
        device."""
        trans_matrix = np.array(image_info["trans_matrix"], np.float64)
        by_class: Dict[str, dict] = {
            c: {"dets": [], "emb": [], "ddd": [], "depth": [], "org": [],
                "sub": []}
            for c in NUSCENES_TRACKING_CLASSES
        }
        class_names = self.info.class_name
        for i, det in enumerate(results):
            cname = class_names[det["class"] - 1]
            if cname not in NUSCENES_TRACKING_CLASSES:
                continue
            if det["score"] < 0.3 or (cname == "pedestrian"
                                      and det["score"] < 0.35):
                continue
            size = [float(det["dim"][1]), float(det["dim"][2]),
                    float(det["dim"][0])]
            translation1 = trans_matrix @ np.array(
                [det["loc"][0], det["loc"][1] - size[2], det["loc"][2], 1],
                np.float64)
            box = camera_box_to_global(
                det["loc"], size, det["rot_y"],
                image_info["cs_record_rot"], image_info["cs_record_trans"],
                image_info["pose_record_rot"], image_info["pose_record_trans"])
            q = box.orientation
            rotation = [float(q.w), float(q.x), float(q.y), float(q.z)]
            angle = q.angle if q.axis[2] > 0 else -q.angle

            slot = by_class[cname]
            slot["dets"].append({"bbox": det["bbox"], "score": det["score"]})
            slot["emb"].append(i)
            slot["ddd"].append([size[2], size[0], size[1], box.center[0],
                                box.center[1], box.center[2], angle])
            slot["depth"].append([float(det["loc"][2])])
            slot["org"].append([float(d) for d in det["dim"]]
                               + list(det["loc"]) + [det["rot_y"]])
            slot["sub"].append([float(v) for v in translation1[:3]] + size
                               + rotation)

        online = []
        for cname in NUSCENES_TRACKING_CLASSES:
            slot = by_class[cname]
            if slot["dets"] and self.cfg.nms:
                boxes = np.array([d["bbox"] for d in slot["dets"]])
                scores = np.array([d["score"] for d in slot["dets"]])
                ovr = 0.7 if cname in ("bus", "truck") else 0.8
                keep, _ = nms_greedy(boxes, scores, overlap=ovr)
                keep = sorted(set(keep.tolist()))
                for key in slot:
                    slot[key] = [slot[key][i] for i in keep]
            rows = torch.as_tensor(slot["emb"], dtype=torch.long,
                                   device=emb.device)
            online += self.tracker[cname].update(
                slot["dets"], emb.index_select(0, rows),
                ddd_boxes=slot["ddd"], depths=slot["depth"],
                ddd_org_boxes=slot["org"], submission=slot["sub"],
                classe=cname)
        return online
