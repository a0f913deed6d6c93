"""Per-frame inference runtime, copied from ``deft_tpu/inference/detector.py``
(MOT, KITTI tracking, nuScenes, and COCO-format datasets, which track as
MOT does).

One frame: ``pre_process`` warps and normalizes it on the detector's device
(the separable two-matmul warp of ``ops/warp.py`` in place of the JAX
package's host ``cv2.warpAffine``; the port does not use cv2), ``process``
runs ``DEFTNet.detect`` (trunk with its DCNv2 kernels, heads, decode, AFE
embeddings), ``post_process`` maps the detections back to image pixels (and,
with the 3-D heads, to camera-frame boxes) on the host, and the tracker
evaluates the window similarity against its on-device ring and runs the
association cascade.  Embeddings stay on the device from ``detect`` to the
ring.

The test-time geometry is the JAX package's (``_transform_scale``): fix_res
by default, ``cfg.keep_res`` (the frame padded to a multiple of 32) or
``cfg.fix_short`` (the short side fixed); each frame's meta carries its own
input size, centre and scale into the decode's ``post_process``.  Under
``cfg.flip_test`` the trunk also runs on the mirrored frames and the heads
are averaged (``DEFTNet.detect``).

KITTI tracks cars only: ``run`` hands the tracker the Car detections and
their embeddings.  nuScenes runs one tracker per tracking class, all drawing
ids from one ``IdAllocator`` and stepping one LSTM motion model, and
``run_multi`` takes the six cameras of a sample through one batched
``detect``.

Public detections (``cfg.public_det``, MOTChallenge's public-detection
protocol): a frame whose meta carries ``cur_dets`` (boxes from a det file,
``data/public_dets.py``) skips the model's heads and decode; ``run`` embeds
the frame at those boxes' centres (``DEFTNet.embed_image``) and hands the
tracker the public boxes.  ``cfg.embed_parity`` normalizes embedding
centres by the original frame's dims, as the reference does, on both the
model path (``detect``'s ``parity_tf``) and the public one.

``cfg.load_model`` names a reference ``.pth`` that overlays the seeded
network tolerantly, ``cfg.load_model_traj`` a reference ``DecoderRNN``
``.pth`` that the LSTM motion model loads strictly (``checkpoint.py``).

``cfg.debug`` >= 1 saves a debug board per frame of ``run``
(``show_debug``, ``deft_tpu/inference/detector.py:374-417``) to
``<save_dir>/debug/<n:05d>_{generic,previous}.png``: the frame with its
detections, track ids and any motion arrows, and the frame before it; at
``debug`` >= 2 also ``pred_hm``, the per-class colormap of the raw
heatmap (a second forward of the network at batch 1 on the detector's
device, through the same DCN route as ``detect``) over the warped input.
The boards are drawn in numpy (``utils/visualize.py``).  The public branch
and ``run_multi`` save none, as in the JAX package.

``timers`` (a ``utils/spans.py`` recorder) keeps the JAX ``run``'s host
stages (pre, net, post, track, tot; ``timers.mean_ms()``, ``timers.count``),
and under a profiler marks them in its trace.  On the card a stage ends when
the host moves on: device work queued in one stage may be waited for in a
later one.  ``run_multi`` records ``pre`` (the rig's frames brought in),
``net``, ``post`` and ``track``, counts ``cameras``, and inside ``track``
the rig's ``rig.ddd`` (the camera -> global boxes and the per-class NMS);
the nuScenes trackers record their stages into ``timers`` too
(``tracker.*``, among them ``tracker.iou3d`` and ``tracker.lstm``, and the
counters ``iou3d_pairs`` and ``lstm_rows``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from deft_tpu_torch.checkpoint import load_model, load_torch_state_dict
from deft_tpu_torch.config import Config
from deft_tpu_torch.data.datasets import (
    NUSCENES_TRACKING_CLASSES,
    get_dataset_info,
)
from deft_tpu_torch.inference.ddd import nms_greedy
from deft_tpu_torch.inference.geometry import camera_box_to_global
from deft_tpu_torch.inference.post_process import generic_post_process
from deft_tpu_torch.data.image_io import imread
from deft_tpu_torch.models.factory import (create_model, require_deft_arch,
                                           resolve_device)
from deft_tpu_torch.ops.affine import get_affine_transform
from deft_tpu_torch.ops.warp import (resize_linear, separable_inverse_tf,
                                     warp_affine_separable)
from deft_tpu_torch.tracking.basetrack import IdAllocator
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion
from deft_tpu_torch.tracking.tracker import STrack, Tracker
from deft_tpu_torch.utils.spans import Spans

MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)


def public_det_centers(cur_dets, meta, max_object: int,
                       embed_parity: bool = False):
    """Normalized AFE sample centres of public detections (``deft_tpu/
    inference/detector.py:48-75``): each box centre in original pixels
    through the input warp ``meta["trans_input"]``, normalized by the input
    dims; under ``embed_parity`` normalized by the original dims instead, as
    the reference does (tracker.py:818).  Returns ([max_object, 2] float32
    centres in [-1, 1], zero-padded; the number of boxes kept)."""
    n = min(len(cur_dets), max_object)
    centers = np.zeros((max_object, 2), np.float32)
    for i in range(n):
        b = np.asarray(cur_dets[i]["bbox"], np.float64)
        cx, cy = (b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0
        if embed_parity:
            centers[i] = (2.0 * cx / meta["width"] - 1.0,
                          2.0 * cy / meta["height"] - 1.0)
        else:
            pt = meta["trans_input"] @ np.array([cx, cy, 1.0])
            centers[i] = (2.0 * pt[0] / meta["inp_width"] - 1.0,
                          2.0 * pt[1] / meta["inp_height"] - 1.0)
    return centers, n


def parity_tf(meta) -> np.ndarray:
    """``detect``'s [8] float32 ``parity_tf`` of a frame: the rows of its
    inverse input warp, then its original width and height
    (``deft_tpu/inference/detector.py:240-247``)."""
    inv = get_affine_transform(meta["c"], meta["s"], 0,
                               [meta["inp_width"], meta["inp_height"]],
                               inv=True)
    return np.concatenate([
        np.asarray(inv, np.float32).reshape(-1),
        np.asarray([meta["width"], meta["height"]], np.float32)])


class Detector:
    """``state_dict``: the network's weights, loaded strictly (else
    ``cfg.load_model``'s file overlaid tolerantly, else seeded ones);
    ``motion_state_dict``: the LSTM motion model's where ``cfg.lstm`` (else
    ``cfg.load_model_traj``'s file, else seeded ones).  ``load_report``
    lists the keys of ``cfg.load_model`` that loaded, kept the seeded value
    and were dropped (None without the file)."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device="cuda", motion_state_dict: Optional[dict] = None):
        require_deft_arch(cfg.arch, "Detector")
        self.cfg = cfg
        self.dataset = cfg.dataset
        self.device = resolve_device(device)
        self.model = create_model(cfg.arch, cfg, self.device)
        self.load_report = None
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif cfg.load_model:
            self.load_report = load_model(self.model, cfg.load_model)
        if cfg.lstm and motion_state_dict is None and cfg.load_model_traj:
            motion_state_dict = load_torch_state_dict(cfg.load_model_traj)
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
        self.timers = Spans(("pre", "net", "post", "track", "tot"))
        self.debugger = None
        self._debug_cnt = 0
        self._pre_image_ori = None
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
        class on nuScenes, each recording its stages into ``timers``."""
        if self.dataset == "nuscenes":
            self.tracker = {c: self._make_tracker()
                            for c in NUSCENES_TRACKING_CLASSES}
            for tracker in self.tracker.values():
                tracker.spans = self.timers
        else:
            self.tracker = self._make_tracker()

    # ---- preprocessing (reference detector.py:346-422) ------------------------

    def _transform_scale(self, image, scale: float = 1.0):
        """Frame geometry (reference detector.py:346-376, ``deft_tpu/
        inference/detector.py:170-197``): (the frame, at ``scale``; its
        centre ``c`` and scale ``s``; the input width and height; the
        original height and width).

        * ``fix_short``: the short side becomes ``cfg.fix_short``, the long
          one keeps the aspect and rounds up to a multiple of 64; ``s`` is
          the frame's [w, h];
        * fix_res (the default): the config's input size, ``s`` the longer
          original side;
        * ``keep_res``: the scaled frame padded to ``(size | cfg.pad) + 1``
          around its centre ``size // 2``; ``s`` is the [inp_w, inp_h].

        A scale other than 1 resizes the frame on the host first
        (``ops/warp.py::resize_linear``, cv2's INTER_LINEAR)."""
        cfg = self.cfg
        height, width = image.shape[:2]
        new_height = int(height * scale)
        new_width = int(width * scale)
        if cfg.fix_short > 0:
            if height < width:
                inp_h = cfg.fix_short
                inp_w = (int(width / height * inp_h) + 63) // 64 * 64
            else:
                inp_w = cfg.fix_short
                inp_h = (int(height / width * inp_w) + 63) // 64 * 64
            c = np.array([width / 2, height / 2], np.float32)
            s = np.array([width, height], np.float32)
        elif not cfg.keep_res:
            inp_h, inp_w = cfg.input_h, cfg.input_w
            c = np.array([new_width / 2.0, new_height / 2.0], np.float32)
            s = max(height, width) * 1.0
        else:
            inp_h = (new_height | cfg.pad) + 1
            inp_w = (new_width | cfg.pad) + 1
            c = np.array([new_width // 2, new_height // 2], np.float32)
            s = np.array([inp_w, inp_h], np.float32)
        if new_width != width or new_height != height:
            image = resize_linear(np.asarray(image), new_width, new_height)
        return image, c, s, inp_w, inp_h, height, width

    def _default_calib(self, width, height) -> np.ndarray:
        return np.array(
            [[self.rest_focal_length, 0, width / 2, 0],
             [0, self.rest_focal_length, height / 2, 0],
             [0, 0, 1, 0]], np.float32)

    def pre_process(self, image, input_meta: Optional[dict] = None,
                    scale: float = 1.0):
        """image: [H, W, 3] uint8 frame (numpy or tensor) -> (normalized
        [1, inp_h, inp_w, 3] float32 on the device, meta: the frame's own
        geometry, ``_transform_scale``'s).  ``input_meta`` may hold the
        camera's [3, 4] ``calib``, and the frame's public detections
        ``cur_dets`` and ``pre_dets``, which pass into meta."""
        resized, c, s, inp_w, inp_h, height, width = self._transform_scale(
            image, scale)
        trans_input = get_affine_transform(c, s, 0, [inp_w, inp_h])
        frame = torch.as_tensor(resized, device=self.device)[None]
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
        for key in ("pre_dets", "cur_dets"):
            if input_meta and key in input_meta:
                meta[key] = input_meta[key]
        return images, meta

    @staticmethod
    def _read(path: str) -> np.ndarray:
        image = imread(path)
        if image is None:
            raise FileNotFoundError(f"cannot read image {path}")
        return image

    def _prepare(self, image_or_frame, meta):
        """A frame as ``run`` takes it -> (normalized [1, H, W, 3] on the
        device, meta).  A path is read with ``image_io.imread`` (BGR, as
        the JAX ``run`` reads it with ``cv2.imread``); the prefetched form
        keeps its own meta; public detections given in ``meta`` pass into
        it."""
        if isinstance(image_or_frame, str):
            return self.pre_process(self._read(image_or_frame), meta)
        if not isinstance(image_or_frame, dict):
            return self.pre_process(image_or_frame, meta)
        images, frame_meta = image_or_frame["images"], image_or_frame["meta"]
        extra = {k: meta[k] for k in ("pre_dets", "cur_dets")
                 if meta and k in meta}
        if extra:
            frame_meta = {**frame_meta, **extra}
        return (torch.as_tensor(images, dtype=torch.float32,
                                device=self.device), frame_meta)

    # ---- the per-frame program -----------------------------------------------

    @torch.no_grad()
    def process(self, images, meta: Optional[dict] = None):
        """Device step over a batch [B, H, W, 3]: (dets dict of numpy
        [B, K, ...], embeddings [B, K, E] on the device).  Under
        ``cfg.embed_parity`` the embeddings are sampled at centres
        normalized by the original dims of ``meta``'s frame: one geometry
        for the batch, whose frames share their size (each geometry is a
        function of the frame's size).  Under ``cfg.flip_test`` the trunk
        runs at batch 2B (``DEFTNet.detect``)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        ptf = parity_tf(meta) if self.cfg.embed_parity else None
        dets, emb = self.model.detect(images, k=self.cfg.K, parity_tf=ptf,
                                      flip_test=self.cfg.flip_test)
        return {k: v.cpu().numpy() for k, v in dets.items()}, emb

    def post_process(self, dets, meta):
        return generic_post_process(
            dets, [meta["c"]], [meta["s"]], meta["out_height"],
            meta["out_width"], self.cfg.out_thresh, [meta["calib"]],
        )[0]

    def _track(self, results, emb, image_info) -> List[STrack]:
        if self.dataset == "nuscenes":
            return self._update_nuscenes(results, emb, image_info)
        if self.dataset == "kitti_tracking":
            # cars only, with their embeddings (reference detector.py:313-317)
            keep = [i for i, d in enumerate(results) if d["class"] == 2]
            rows = torch.as_tensor(keep, dtype=torch.long, device=emb.device)
            return self.tracker.update([results[i] for i in keep],
                                       emb.index_select(0, rows))
        return self.tracker.update(results, emb)

    def run(self, image_or_frame, meta: Optional[dict] = None,
            image_info: Optional[dict] = None) -> List[STrack]:
        """Full frame step -> list of online tracks (reference
        detector.py:112-344).

        ``image_or_frame`` is a decoded [H, W, 3] uint8 frame, an image
        file's path, or the JAX
        ``run``'s prefetched form ``{"images": [1, H, W, 3] normalized,
        "meta": {...}}``; ``meta`` may hold the camera's ``calib`` and the
        frame's public detections ``cur_dets``; nuScenes needs the frame's
        ``image_info`` (its camera and ego-pose records).

        Under ``cfg.public_det`` a frame with ``cur_dets`` takes the public
        branch (``deft_tpu/inference/detector.py:280-298``): its first
        max_object boxes, embedded at their centres, go to the tracker; a
        frame without them takes the model path.
        """
        with self.timers.span("tot"):
            with self.timers.span("pre"):
                image = image_or_frame
                if isinstance(image_or_frame, str):
                    image = self._read(image_or_frame)
                images, meta = self._prepare(image, meta)
            if self.cfg.public_det and "cur_dets" in meta:
                online = self._run_public(images, meta)
            else:
                (online,), (results,) = self._detect_and_track(
                    [{"images": images, "meta": meta}], None, [image_info])
                if self.cfg.debug >= 1:
                    self.show_debug(None if isinstance(image, dict)
                                    else image, images, results, online)
        return online

    @torch.no_grad()
    def embed_public(self, images, meta):
        """The public branch's device step: (the frame's first max_object
        public detections, their embeddings [n, E] on the device)."""
        results = list(meta["cur_dets"])[: self.cfg.max_object]
        centers, n = public_det_centers(results, meta, self.cfg.max_object,
                                        self.cfg.embed_parity)
        emb = self.model.embed_image(
            images, torch.as_tensor(centers[None], device=self.device))
        return results, emb[0][:n]

    def _run_public(self, images, meta) -> List[STrack]:
        with self.timers.span("net"):
            results, emb = self.embed_public(images, meta)
        with self.timers.span("track"):
            return self.tracker.update(results, emb)

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
        self.timers.add("cameras", len(images_or_frames))
        with self.timers.span("pre"):
            frames = [dict(zip(("images", "meta"), self._prepare(img, meta)))
                      for img, meta in zip(images_or_frames,
                                           metas or [None] * len(
                                               images_or_frames))]
        return self._detect_and_track(frames, None, image_infos,
                                      materialize)[0]

    def _detect_and_track(self, images_or_frames, metas=None,
                          image_infos=None, materialize=None):
        """``run_multi``'s step: (the online lists, each camera's
        post-processed detections)."""
        n = len(images_or_frames)
        metas = metas or [None] * n
        image_infos = image_infos or [None] * n
        batch, b_metas = zip(*[self._prepare(img, meta) for img, meta
                               in zip(images_or_frames, metas)])
        with self.timers.span("net"):
            dets, emb = self.process(torch.cat(batch), b_metas[0])

        online_per_cam, results_per_cam = [], []
        for b in range(n):
            with self.timers.span("post"):
                dets_b = {k: v[b: b + 1] for k, v in dets.items()}
                results = self.post_process(dets_b, b_metas[b])
            with self.timers.span("track"):
                online = self._track(results, emb[b][: len(results)],
                                     image_infos[b])
            online_per_cam.append(materialize(online) if materialize
                                  else online)
            results_per_cam.append(results)
        return online_per_cam, results_per_cam

    # ---- --debug board (deft_tpu/inference/detector.py:374-417) -------------

    @torch.no_grad()
    def debug_heatmap(self, images) -> np.ndarray:
        """The sigmoid of the network's raw ``hm`` for a batch-1 input
        [1, H, W, 3]: [H/4, W/4, C] float32 on the host (the JAX
        ``_debug_hm``, ``detector.py:137-143``)."""
        outputs, _ = self.model(torch.as_tensor(images, dtype=torch.float32,
                                                device=self.device))
        return torch.sigmoid(outputs["hm"])[0].cpu().numpy()

    def show_debug(self, image, images, results, online):
        """Build and save the debug board of one frame (module docstring).
        ``image`` is the original uint8 frame (numpy or tensor), or None
        for a prefetched one (then the normalized input, denormalized,
        stands in)."""
        from deft_tpu_torch.utils.visualize import Debugger

        if self.debugger is None:
            self.debugger = Debugger(self.cfg, self.info)
        dbg = self.debugger
        dbg.clear()
        warped = None
        if image is None or self.cfg.debug >= 2:
            warped = np.clip((torch.as_tensor(images)[0].float().cpu().numpy()
                              * STD + MEAN) * 255.0, 0, 255).astype(np.uint8)
        if image is None:
            image = warped
        image = (image.cpu().numpy() if torch.is_tensor(image)
                 else np.asarray(image))
        dbg.add_img(image, "generic")
        dbg.add_img(self._pre_image_ori if self._pre_image_ori is not None
                    else image, "previous")
        self._pre_image_ori = image
        for item in results:
            if item.get("score", 0.0) < self.cfg.vis_thresh:
                continue
            if "bbox" in item:
                dbg.add_coco_bbox(item["bbox"], item["class"] - 1,
                                  item.get("score", 0.0), img_id="generic")
            if "tracking" in item and "ct" in item:
                ct = np.asarray(item["ct"], np.float64)
                dbg.add_arrow(ct, ct + np.asarray(item["tracking"]),
                              img_id="generic")
            if "hps" in item:
                dbg.add_coco_hp(item["hps"], img_id="generic")
        for t in online:
            tl = t.tlwh
            dbg.add_tracking_id((tl[0] + tl[2] / 2, tl[1] + tl[3] / 2),
                                t.track_id, img_id="generic")
        if self.cfg.debug >= 2:
            dbg.add_blend_img(warped, dbg.gen_colormap(
                self.debug_heatmap(images)), "pred_hm")
        self._debug_cnt += 1
        dbg.save_all_imgs(os.path.join(self.cfg.save_dir, "debug"),
                          prefix=f"{self._debug_cnt:05d}_")

    # ---- nuScenes per-class branch (reference detector.py:200-341) -----------

    def _update_nuscenes(self, results, emb, image_info) -> List[STrack]:
        """One camera's detections -> the per-class trackers: the tracking
        classes above a 0.3 score (0.35 for pedestrians), each box taken to
        the global frame through the camera's and the ego pose's records,
        per-class greedy NMS under ``cfg.nms``; ``emb`` is [n, E] on the
        device."""
        with self.timers.span("rig.ddd"):
            by_class = self._route_nuscenes(results, image_info)
        online = []
        for cname in NUSCENES_TRACKING_CLASSES:
            slot = by_class[cname]
            rows = torch.as_tensor(slot["emb"], dtype=torch.long,
                                   device=emb.device)
            online += self.tracker[cname].update(
                slot["dets"], emb.index_select(0, rows),
                ddd_boxes=slot["ddd"], depths=slot["depth"],
                ddd_org_boxes=slot["org"], submission=slot["sub"],
                classe=cname)
        return online

    def _route_nuscenes(self, results, image_info) -> Dict[str, dict]:
        """``_update_nuscenes``' host geometry: each tracking class's
        detections with their global boxes, after the per-class NMS."""
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
        return by_class
