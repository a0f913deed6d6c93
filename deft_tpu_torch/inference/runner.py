"""Pipelined sequence runner, the counterpart of
``deft_tpu/inference/runner.py``: the production tracking loop of
``test.py`` (``PipelinedRunner(detector)``) and ``bench.py`` (``chunk=4``).

Per frame, one fused device program (``DEFTNet.frame_step``, or
``frame_chunk`` / ``frame_chunk_batched`` for a chunk of frames: device warp
-> detect -> embed -> similarity against the ring -> ring write) plus host
work (the inverse affine of the detections and the association cascade).
The runner overlaps them:

  main thread: copy frame t+d into a pinned slab, upload, queue its program
  device:      programs of frames t+1 .. t+d, each ending in one copy out
  worker:      wait for frame t's copy, post-process, cascade (frame order)

* Frames travel raw (uint8, no cv2 on the host) from a pinned [chunk, H, W,
  3] slab with ``non_blocking=True`` and are warped on the device, the JAX
  runner's ``device_warp`` route.  A slab is reused only after the event
  recorded behind its upload has passed.  Under ``cfg.keep_res`` or
  ``cfg.fix_short`` the input size follows the frame's, and the runner
  warps on the host as the JAX one does there (``runner.py:141-157``): each
  frame goes through ``ops/warp.py::warp_affine_uint8`` (cv2's bilinear
  warp in numpy) with its own transform, and the warped uint8 frames are
  copied into a slab at dispatch and normalized on the device.
* Each dispatch's packed detections (float32) and similarities (float16, or
  uint8 under ``sims_quant``) are joined on the device into one byte buffer
  and come back in ONE ``non_blocking`` copy into a pinned buffer, followed
  by a CUDA event.  The buffer returns to its pool only after the cascade
  has read it.
* ONE cascade worker waits on that event, then runs ``post_process`` and the
  tracker, in dispatch order; the main thread blocks on it only when more
  than CASCADE_DEPTH cascades are outstanding.
* A partial final chunk is padded by repeating its last frame and the pad's
  outputs are dropped (the device ring then holds pad entries: ``reset()``
  before the next sequence).
* Under ``cfg.public_det`` the chunk is 1, and a frame whose meta carries
  ``cur_dets`` runs ``frame_step_embed`` at those boxes' centres (uploaded
  from a pinned buffer) on the frame warped as the others are: no heads,
  no decode, only the similarity comes back, and the tracker gets the
  public boxes.  (The JAX runner warps such frames on the host; the port
  warps them on the device under fix_res.)  ``cfg.embed_parity`` feeds every frame program its frame's
  ``parity_tf``; a chunk's frames share its first frame's, which is exact
  only under fix_res, so ``embed_parity`` with a chunk above 1 under
  ``keep_res`` or ``fix_short`` raises a ``ValueError``, as in the JAX
  runner.  ``cfg.flip_test`` passes into every frame program.

On a CPU device (the tests) the same code runs synchronously, without pinned
memory or events.  Not ported yet (ROADMAP.md, queue A): YUV and delta
uploads, ``auto_tune`` and the upload modes it chooses between.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional

import numpy as np
import torch

from deft_tpu_torch.inference.detector import parity_tf, public_det_centers
from deft_tpu_torch.models.deft import new_ring, unpack_dets
from deft_tpu_torch.ops.affine import get_affine_transform
from deft_tpu_torch.ops.warp import separable_inverse_tf, warp_affine_uint8
from deft_tpu_torch.tracking.tracker import freshness_window

RING_SLOTS = 50
CASCADE_DEPTH = 1      # cascades left outstanding before the main thread waits
_LATER = "is not ported yet (ROADMAP.md, queue A)"
# feature width of every packable decode output (runner.py:241-244)
DET_DIMS = {"scores": 1, "clses": 1, "cts": 2, "bboxes": 4, "bboxes_amodal": 4,
            "tracking": 2, "dep": 1, "rot": 8, "dim": 3, "amodel_offset": 2,
            "nuscenes_att": 8, "velocity": 3}


class _Ready:
    """Future-shaped wrapper for a value computed synchronously."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class TrackView:
    """Frozen per-frame snapshot of a track: the cascade worker keeps
    mutating live tracks while the caller holds frame t's results."""

    __slots__ = ("track_id", "score", "is_activated", "tlwh", "frame_id",
                 "start_frame")
    ddd_submission = None           # the runner tracks 2-D datasets only

    def __init__(self, t):
        self.track_id = t.track_id
        self.score = t.score
        self.is_activated = t.is_activated
        self.tlwh = t.tlwh                      # the property copies
        self.frame_id = t.frame_id
        self.start_frame = t.start_frame

    @property
    def tlbr(self):
        ret = self.tlwh.copy()
        ret[2:] += ret[:2]
        return ret

    @property
    def end_frame(self):
        return self.frame_id


class _HostBuffers:
    """A pool of host tensors (pinned when ``pinned``).  A buffer handed
    back with an event is handed out again only after the event passed."""

    def __init__(self, pinned: bool, keep: int = 8):
        self.pinned = pinned
        self.keep = keep
        self._free: List[tuple] = []
        self._lock = threading.Lock()

    def take(self, shape, dtype) -> torch.Tensor:
        with self._lock:
            for i, (buf, event) in enumerate(self._free):
                if buf.shape == shape and buf.dtype == dtype:
                    del self._free[i]
                    break
            else:
                buf = event = None
        if buf is None:
            return torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
        if event is not None:
            event.synchronize()
        return buf

    def give(self, buf: torch.Tensor, event=None):
        with self._lock:
            if len(self._free) < self.keep:
                self._free.append((buf, event))


class PipelinedRunner:
    """Single-sequence tracking loop for MOT/KITTI (2-D datasets)."""

    def __init__(self, detector, depth: int = 3, chunk: int = 1):
        cfg = detector.cfg
        if cfg.dataset == "nuscenes":
            raise ValueError("nuScenes samples go through Detector.run_multi "
                             "(track.py::track_nuscenes), as in test.py")
        for flag in ("yuv_upload", "delta_upload"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} {_LATER}")
        self.det = detector
        self.cfg = cfg
        self.depth = depth
        # public frames interleave their centres' uploads with the ring
        # state: one frame per dispatch (runner.py:117-119)
        self.chunk = 1 if cfg.public_det else max(1, chunk)
        # the input geometry follows each frame's size: warp on the host
        self.host_warp = cfg.keep_res or cfg.fix_short > 0
        if cfg.embed_parity and self.chunk > 1 and self.host_warp:
            # a chunk's program takes its first frame's inverse transform,
            # exact only under fix_res (runner.py:121-129)
            raise ValueError(
                "--embed_parity with chunked dispatch requires fix_res "
                "preprocessing (constant per-frame transform); use chunk=1 "
                "with keep_res/fix_short")
        self.device = detector.device
        self.sim_window = (freshness_window(cfg.dataset) + 2
                           if cfg.sim_window < 0 else cfg.sim_window)
        self.class_filter = 1 if cfg.dataset == "kitti_tracking" else -1
        # the cascade runs on ONE worker, in dispatch order, overlapping the
        # main thread's uploads and dispatches of later frames
        self.cascade_async = True
        self._casc_pool = ThreadPoolExecutor(max_workers=1)
        on_card = self.device.type == "cuda"
        self._slabs = _HostBuffers(pinned=on_card)
        self._fetch_bufs = _HostBuffers(pinned=on_card)
        self._center_bufs = _HostBuffers(pinned=on_card)
        self._t_lock = threading.Lock()
        self.buckets: Dict[str, float] = {}
        self._frames_done = 0

        present = {"scores", "clses", "cts"}
        if {"wh", "ltrb", "ltrb_amodal"} & set(cfg.heads):
            present.add("bboxes")
        if "ltrb_amodal" in cfg.heads:
            present.add("bboxes_amodal")
        present |= {h for h in DET_DIMS if h in cfg.heads}
        self._layout = [(key, DET_DIMS[key]) for key in sorted(present)]
        self.reset()

    # ---- options of the JAX runner that this port does not have --------------

    @property
    def upload_parallel(self) -> bool:
        return False

    @upload_parallel.setter
    def upload_parallel(self, value: bool):
        if value:
            raise NotImplementedError(f"upload_parallel {_LATER}")

    def auto_tune(self, frames, metas=None, verbose: bool = False) -> dict:
        raise NotImplementedError(f"auto_tune {_LATER}")

    # ---- bookkeeping ---------------------------------------------------------

    def _acc(self, key: str, dt_s: float):
        with self._t_lock:
            self.buckets[key] = self.buckets.get(key, 0.0) + dt_s * 1000.0

    def timings(self) -> Dict[str, float]:
        """ms/frame per bucket since the last reset.  ``main_keys()`` are
        charged to the main thread (their sum approximates the wall time per
        frame); fetch_wait and cascade (split into casc_post, casc_desims,
        casc_track) run on the cascade worker and overlap it."""
        n = max(self._frames_done, 1)
        with self._t_lock:
            return {k: v / n for k, v in sorted(self.buckets.items())}

    def main_keys(self) -> tuple:
        base = ("warp", "upload", "dispatch", "casc_wait")
        if not self.cascade_async:
            base = base + ("fetch_wait", "cascade")
        return base

    def reset(self):
        """A fresh ring and tracker for a new sequence."""
        wait([fut for fut in getattr(self, "_casc_futs", [])])
        for item in getattr(self, "_pending", []):
            if item["event"] is not None:
                item["event"].synchronize()
        with self._t_lock:
            self.buckets = {}
            self._frames_done = 0
        self.state = new_ring(RING_SLOTS, self.cfg.max_object,
                              self.det.embed_dim, self.device)
        self._pending: List[dict] = []
        self._casc_futs: List = []
        self._chunk_buf: List = []
        self._cur_stack: Optional[torch.Tensor] = None
        self._ring_dirty = False
        self.det.reset_tracking()

    # ---- the pipeline --------------------------------------------------------

    def warp(self, image_bgr: np.ndarray, meta: Optional[dict] = None,
             dst: Optional[np.ndarray] = None):
        """Host half of preprocessing (runner.py:730-776): the frame
        geometry and, under fix_res (device_warp), the [6] inverse
        transform with the frame itself raw, copied into ``dst`` (a pinned
        slab slot) when its shape fits; under ``host_warp`` the frame
        warped to its input size (uint8) and no transform."""
        frame, c, s, inp_w, inp_h, height, width = self.det._transform_scale(
            image_bgr)
        frame = np.asarray(frame)
        trans_input = get_affine_transform(c, s, 0, [inp_w, inp_h])
        warp_tf = None
        if self.host_warp:
            frame = warp_affine_uint8(frame, trans_input, inp_w, inp_h)
        else:
            warp_tf = separable_inverse_tf(c, s, inp_w, inp_h)
        if dst is not None and dst.shape == frame.shape:
            np.copyto(dst, frame)
            frame = dst
        frame_meta = {
            "warp_tf": warp_tf,
            "c": c, "s": s,
            "out_height": inp_h // self.cfg.down_ratio,
            "out_width": inp_w // self.cfg.down_ratio,
            "inp_height": inp_h, "inp_width": inp_w,
            "height": height, "width": width,
            "trans_input": trans_input,
            "calib": (np.array(meta["calib"], np.float32)
                      if meta and "calib" in meta
                      else self.det._default_calib(width, height)),
        }
        for key in ("pre_dets", "cur_dets"):
            if meta and key in meta:
                frame_meta[key] = meta[key]
        return frame, frame_meta

    def submit(self, image_bgr: np.ndarray, meta: Optional[dict] = None):
        """Feed one raw frame; returns completed frames' tracks (a list of
        per-frame lists when chunked, one frame's list otherwise) once the
        pipeline is full, else None."""
        t0 = time.perf_counter()
        dst = None
        if not self._chunk_buf and not self.host_warp:
            # the pooled slab of raw frames (a warped frame's size is
            # known only after its warp: those are copied at dispatch)
            self._cur_stack = self._slabs.take(
                (self.chunk,) + tuple(image_bgr.shape), torch.uint8)
        # a chunk begun by submit_warped() has no slab: its frames are
        # copied into one at dispatch (the JAX runner indexes None here,
        # runner.py:546)
        if self._cur_stack is not None:
            dst = self._cur_stack[len(self._chunk_buf)].numpy()
        frame, frame_meta = self.warp(image_bgr, meta, dst=dst)
        self._acc("warp", time.perf_counter() - t0)
        return self.submit_warped(frame, frame_meta)

    def submit_warped(self, frame: np.ndarray, frame_meta: dict):
        """Feed a frame already through ``warp``."""
        if self._ring_dirty:
            raise RuntimeError(
                "a padded partial chunk was flushed (the device ring holds pad "
                "entries); call reset() before submitting more frames")
        self._chunk_buf.append((frame, frame_meta))
        if len(self._chunk_buf) >= self.chunk:
            self._dispatch_chunk()
        while len(self._pending) > self.depth:
            self._enqueue_finish(self._pending.pop(0))
        out: List = []
        self._pop_ready(out)
        if self.chunk > 1:
            return out or None
        return out[0] if out else None

    def flush(self) -> List[List]:
        """Run what is queued, padding a partial chunk; returns the
        remaining frames' track lists in order."""
        self._dispatch_chunk()
        for item in self._pending:
            self._enqueue_finish(item)
        self._pending = []
        out: List = []
        self._pop_ready(out, drain=True)
        return out

    def track_sequence(self, frames, metas=None) -> List[List]:
        """Run a whole sequence; returns per-frame track lists."""
        results: List = []
        for i, frame in enumerate(frames):
            done = self.submit(frame, metas[i] if metas else None)
            if done is not None:
                if self.chunk > 1:
                    results.extend(done)
                else:
                    results.append(done)
        results.extend(self.flush())
        return results

    def _dispatch_chunk(self):
        if not self._chunk_buf:
            return
        frames = [f for f, _ in self._chunk_buf]
        metas = [m for _, m in self._chunk_buf]
        self._chunk_buf = []
        n_real = len(frames)
        t0 = time.perf_counter()
        slab, self._cur_stack = self._cur_stack, None
        if slab is None or not all(np.shares_memory(f, slab.numpy())
                                   for f in frames):
            slab = self._slabs.take((self.chunk,) + frames[0].shape,
                                    torch.uint8)
            for i, f in enumerate(frames):
                np.copyto(slab[i].numpy(), f)
        if n_real < self.chunk:
            # pad to the chunk length by repeating the last frame
            # (runner.py:614-622); the pad's outputs are dropped below
            self._ring_dirty = True
            slab[n_real:] = slab[n_real - 1]
        images = slab.to(self.device, non_blocking=True)
        self._slabs.give(slab, self._record_event())
        self._acc("upload", time.perf_counter() - t0)

        t0 = time.perf_counter()
        if self.cfg.public_det and "cur_dets" in metas[0]:
            self._pending.append(self._dispatch_public(images, metas[0]))
            self._acc("dispatch", time.perf_counter() - t0)
            return
        model = self.det.model
        kw = dict(k=self.cfg.K, class_filter=self.class_filter,
                  sims_quant=self.cfg.sims_quant, sim_window=self.sim_window,
                  parity_tf=self._parity_tf(metas[0]),
                  warp_tf=metas[0]["warp_tf"],
                  warp_out=(metas[0]["inp_height"], metas[0]["inp_width"]),
                  flip_test=self.cfg.flip_test)
        if self.chunk == 1:
            packed, sims = model.frame_step(images, self.state,
                                            self.cfg.out_thresh, **kw)
            packed, sims = packed[None], sims[None]
        else:
            program = (model.frame_chunk_batched if self.cfg.chunk_batched
                       else model.frame_chunk)
            packed, sims = program(images, self.state, self.cfg.out_thresh,
                                   **kw)
        item = self._fetch(sims[:n_real], packed[:n_real])
        item["metas"] = metas
        self._pending.append(item)
        self._acc("dispatch", time.perf_counter() - t0)

    def _parity_tf(self, frame_meta: dict):
        """The frame programs' ``parity_tf`` under ``cfg.embed_parity``
        (runner.py:391-406), else None."""
        return parity_tf(frame_meta) if self.cfg.embed_parity else None

    def _dispatch_public(self, images: torch.Tensor, frame_meta: dict) -> dict:
        """One public frame (runner.py:427-444): its first max_object
        boxes' centres go up from a pinned buffer, ``frame_step_embed``
        embeds the device-warped frame there and writes the ring, and only
        the similarity comes back."""
        cur_dets = list(frame_meta["cur_dets"])[: self.cfg.max_object]
        centers, n = public_det_centers(cur_dets, frame_meta,
                                        self.cfg.max_object,
                                        self.cfg.embed_parity)
        host = self._center_bufs.take(centers.shape, torch.float32)
        np.copyto(host.numpy(), centers)
        dev_centers = host.to(self.device, non_blocking=True)
        self._center_bufs.give(host, self._record_event())
        sims = self.det.model.frame_step_embed(
            images, dev_centers, n, self.state,
            sims_quant=self.cfg.sims_quant, sim_window=self.sim_window,
            warp_tf=frame_meta["warp_tf"],
            warp_out=(frame_meta["inp_height"], frame_meta["inp_width"]))
        item = self._fetch(sims[None])
        item["public"] = cur_dets
        return item

    def _record_event(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _fetch(self, sims: torch.Tensor,
               packed: Optional[torch.Tensor] = None) -> dict:
        """One copy of a dispatch's outputs to the host: packed [T, L]
        float32 (none for a public frame) and sims [T, ...] joined as bytes
        on the device."""
        if packed is None:
            packed = sims.new_zeros((0,), dtype=torch.float32)
        blob = torch.cat([packed.reshape(-1).view(torch.uint8),
                          sims.reshape(-1).view(torch.uint8)])
        host = self._fetch_bufs.take((blob.numel(),), torch.uint8)
        host.copy_(blob, non_blocking=True)
        return {"host": host, "event": self._record_event(),
                "packed_shape": tuple(packed.shape),
                "sims_shape": tuple(sims.shape),
                "sims_dtype": (np.uint8 if sims.dtype == torch.uint8
                               else np.float16)}

    # ---- the cascade worker --------------------------------------------------

    def _enqueue_finish(self, item: dict):
        if self.cascade_async:
            self._casc_futs.append(self._casc_pool.submit(self._finish, item))
        else:
            self._casc_futs.append(_Ready(self._finish(item)))

    def _pop_ready(self, out: List, drain: bool = False):
        """Block on cascades beyond CASCADE_DEPTH (in steady state already
        done) and append their frames' track lists to ``out``."""
        while self._casc_futs and (drain
                                   or len(self._casc_futs) > CASCADE_DEPTH):
            fut = self._casc_futs.pop(0)
            t0 = time.perf_counter()
            res = fut.result()
            self._acc("casc_wait", time.perf_counter() - t0)
            out.extend(res)

    def _finish(self, item: dict) -> List[List]:
        """Wait for a dispatch's copy, then post-process and track each of
        its frames in order."""
        t0 = time.perf_counter()
        if item["event"] is not None:
            item["event"].synchronize()
        self._acc("fetch_wait", time.perf_counter() - t0)
        raw = item["host"].numpy()
        n_packed = int(np.prod(item["packed_shape"])) * 4
        packed = raw[:n_packed].view(np.float32).reshape(item["packed_shape"])
        sims = raw[n_packed:].view(item["sims_dtype"]).reshape(
            item["sims_shape"])
        try:
            if "public" in item:
                return [self._finish_frame(None, sims[0], None,
                                           item["public"])]
            return [self._finish_frame(packed[t], sims[t], meta)
                    for t, meta in enumerate(item["metas"])]
        finally:
            self._fetch_bufs.give(item["host"])

    def _finish_frame(self, packed: Optional[np.ndarray], sims: np.ndarray,
                      meta: Optional[dict], public=None) -> List:
        """Post-process one frame's packed detections, or take its public
        ones (runner.py:480-492), then run the tracker on its sims."""
        t0 = time.perf_counter()
        if public is not None:
            results = public
        else:
            dets, n_valid = unpack_dets(packed, self._layout, self.cfg.K)
            results = self.det.post_process(dets, meta)
            if self.cfg.dataset == "kitti_tracking":
                results = [d for d in results if d["class"] == 2]
            results = results[:n_valid]
        t1 = time.perf_counter()
        self._acc("casc_post", t1 - t0)
        sims = (sims.astype(np.float32) / 255.0 if sims.dtype == np.uint8
                else sims.astype(np.float32))
        t2 = time.perf_counter()
        self._acc("casc_desims", t2 - t1)
        out = self.det.tracker.update(results, None, sims=sims)
        if self.cascade_async:
            out = [TrackView(t) for t in out]
        t3 = time.perf_counter()
        self._acc("casc_track", t3 - t2)
        self._acc("cascade", t3 - t0)
        with self._t_lock:
            self._frames_done += 1
        return out
