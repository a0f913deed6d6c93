"""Per-frame inference runtime, copied from ``deft_tpu/inference/detector.py``
(MOT branch).

One frame: ``pre_process`` warps and normalizes it on the detector's device
(the separable two-matmul warp of ``ops/warp.py`` in place of the JAX
package's host ``cv2.warpAffine``; the port does not use cv2), ``process``
runs ``DEFTNet.detect`` (trunk with its DCNv2 kernels, heads, decode, AFE
embeddings), ``post_process`` maps the detections back to image pixels on
the host, and the tracker evaluates the window similarity against its
on-device ring and runs the association cascade.  Embeddings stay on the
device from ``detect`` to the ring.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deft_tpu_torch.config import Config
from deft_tpu_torch.inference.post_process import generic_post_process
from deft_tpu_torch.models.factory import create_model, resolve_device
from deft_tpu_torch.ops.affine import get_affine_transform
from deft_tpu_torch.ops.warp import separable_inverse_tf, warp_affine_separable
from deft_tpu_torch.tracking.basetrack import IdAllocator
from deft_tpu_torch.tracking.tracker import STrack, Tracker

MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)

_LATER = "is not ported yet (ROADMAP.md, queue A)"


class Detector:
    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device="cuda"):
        if cfg.dataset != "mot":
            raise NotImplementedError(f"dataset {cfg.dataset!r} {_LATER}")
        for flag in ("public_det", "debug", "embed_parity", "flip_test",
                     "lstm", "load_model", "keep_res"):
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
        self._mean = torch.as_tensor(MEAN, device=self.device)
        self._std = torch.as_tensor(STD, device=self.device)
        self.ids = IdAllocator()
        self.reset_tracking()

    # ---- lifecycle -----------------------------------------------------------

    def reset_tracking(self):
        """A fresh tracker (and ring) for a new sequence."""
        self.tracker = Tracker(
            self.dataset, self.cfg.max_object, self.embed_dim,
            similarity_fn=self.model.window_similarity, ids=self.ids,
            track_buffer=self.cfg.track_buffer, device=self.device,
        )

    # ---- preprocessing (reference detector.py:346-422) ------------------------

    def pre_process(self, image):
        """image: [H, W, 3] uint8 frame (numpy or tensor) -> (normalized
        [1, inp_h, inp_w, 3] float32 on the device, meta)."""
        height, width = image.shape[:2]
        # fix_res geometry: the frame's centre, its longer side, the config's
        # input size
        c = np.array([width / 2.0, height / 2.0], np.float32)
        s = max(height, width) * 1.0
        inp_h, inp_w = self.cfg.input_h, self.cfg.input_w
        trans_input = get_affine_transform(c, s, 0, [inp_w, inp_h])
        frame = torch.as_tensor(image, device=self.device)[None]
        warped = warp_affine_separable(
            frame, separable_inverse_tf(c, s, inp_w, inp_h), inp_h, inp_w)
        images = (warped / 255.0 - self._mean) / self._std
        meta = {
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
        """Device step: (dets dict of numpy [1, K, ...], embeddings [1, K, E]
        on the device)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        dets, emb = self.model.detect(images, k=self.cfg.K)
        return {k: v.cpu().numpy() for k, v in dets.items()}, emb

    def post_process(self, dets, meta):
        return generic_post_process(
            dets, [meta["c"]], [meta["s"]], meta["out_height"],
            meta["out_width"], self.cfg.out_thresh,
        )[0]

    def run(self, image_or_frame) -> List[STrack]:
        """Full frame step -> list of online tracks (reference
        detector.py:112-344).

        ``image_or_frame`` is a decoded [H, W, 3] uint8 frame, or the JAX
        ``run``'s prefetched form ``{"images": [1, H, W, 3] normalized,
        "meta": {...}}``.
        """
        if isinstance(image_or_frame, str):
            raise NotImplementedError(
                "reading image files needs an image decoder; pass the "
                "decoded frame")
        if isinstance(image_or_frame, dict):
            images = image_or_frame["images"]
            meta = image_or_frame["meta"]
        else:
            images, meta = self.pre_process(image_or_frame)
        dets, emb = self.process(images)
        results = self.post_process(dets, meta)
        return self.tracker.update(results, emb[0][: len(results)])
