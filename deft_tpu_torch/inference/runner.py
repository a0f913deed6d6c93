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
* The wire encodings (``runner.py:140-157, :561-575``) carry warped frames,
  so they too warp on the host: ``cfg.yuv_upload`` packs each warped frame
  as planar YUV 4:2:0 (``pack_yuv420``, half the bytes; the frame program
  decodes it), ``cfg.delta_upload`` sends its uint8 difference from the
  previous warped frame (the ring state keeps ``prev_frame`` and the frame
  program adds it back, bit for bit).  They exclude each other and
  ``cfg.device_warp``; ``public_det`` and ``keep_res`` turn them off.
* Staging, on a card (``runner.py:198-224``): ``stacked`` (the default for a
  chunk above 1, ``cfg.stacked_upload``) copies a chunk in one upload from
  its slab at dispatch; otherwise each frame is copied as it is submitted.
  ``force_resident`` makes the host wait on an upload's event before the
  program is queued; ``upload_parallel`` issues each chunk's copy from a
  3-worker pool, each worker on its own CUDA stream, and the compute stream
  waits on the copy's event, so programs run in submission order.
  ``auto_tune`` times the four modes on real frames and keeps the fastest.
  ``track_sequence(lookahead=n)`` runs the host half (``warp``) of n
  frames ahead on worker threads (``runner.py:778-813``).
* Each dispatch's packed detections (float32) and similarities (float16, or
  uint8 under ``sims_quant``) are joined on the device into one byte buffer
  and come back in ONE ``non_blocking`` copy into a pinned buffer, followed
  by a CUDA event.  The buffer returns to its pool only after the cascade
  has read it.
* ONE cascade worker waits on that event, then runs ``post_process`` and the
  tracker, in dispatch order; the main thread blocks on it only when more
  than CASCADE_DEPTH cascades are outstanding.  ``cap`` > 0 keeps at most
  that many detections per frame (``runner.py:425, :504-505``).
* A partial final chunk is padded by repeating its last frame and the pad's
  outputs are dropped (the device ring then holds pad entries: ``reset()``
  before the next sequence).
* On a card the frame program of a dispatch is replayed as one CUDA graph
  (``run_program``): the host queues a slab copy and one graph launch in
  place of some 1,500-2,000 small kernels a chunk.  A graph is captured
  per program key, the first time the key comes since ``reset()`` (which
  builds a new ring, so it drops the graphs) after an eager dispatch of it
  in the runner's life has built what the program builds lazily.  A graph
  captures the model as bound at its capture, so a method rebound before
  a sequence's first dispatch is part of it.  Graphs need a program whose
  state is all updated in place: delta uploads (which rebind the ring's
  ``prev_frame``) and public detections (which upload centres per frame)
  stay eager, as does every CPU run.
* ``spans`` (``utils/spans.py``) times each stage of both threads, the
  frame programs' (``program.*``) and the tracker's (``tracker.*``), and
  counts the cascade's load and the dispatches that ran eager, captured a
  graph or replayed one; ``timings()`` reads it.  Its spans carry the
  frame's id (submission order) or the chunk's (dispatch order), which
  count on across resets.
* Under ``cfg.public_det`` the chunk is 1, and a frame whose meta carries
  ``cur_dets`` runs ``frame_step_embed`` at those boxes' centres (uploaded
  from a pinned buffer) on the frame warped as the others are: no heads,
  no decode, only the similarity comes back, and the tracker gets the
  public boxes.  (The JAX runner warps such frames on the host; the port
  warps them on the device under fix_res.)  ``cfg.embed_parity`` feeds
  every frame program its frame's ``parity_tf``; a chunk's frames share its
  first frame's, which is exact only under fix_res, so ``embed_parity``
  with a chunk above 1 under ``keep_res`` or ``fix_short`` raises a
  ``ValueError``, as in the JAX runner.  ``cfg.flip_test`` passes into
  every frame program.

On a CPU device (the tests) the same code runs synchronously, without pinned
memory, streams or events; an upload there is a copy.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional

import numpy as np
import torch

from deft_tpu_torch.inference.detector import parity_tf, public_det_centers
from deft_tpu_torch.models.deft import new_ring, unpack_dets
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.ops.affine import get_affine_transform
from deft_tpu_torch.ops.warp import separable_inverse_tf, warp_affine_uint8
from deft_tpu_torch.tracking.tracker import freshness_window
from deft_tpu_torch.utils.spans import NO_SPANS, Spans

RING_SLOTS = 50
CASCADE_DEPTH = 1      # cascades left outstanding before the main thread waits
UPLOAD_WORKERS = 3     # upload_parallel's pool (runner.py:206)
# auto_tune's modes: (name, stacked, force_resident, upload_parallel)
STAGING_MODES = (("stacked+lazy", True, False, False),
                 ("stacked+forced", True, True, False),
                 ("stacked+parallel", True, False, True),
                 ("perframe", False, False, False))
# feature width of every packable decode output (runner.py:241-244)
DET_DIMS = {"scores": 1, "clses": 1, "cts": 2, "bboxes": 4, "bboxes_amodal": 4,
            "tracking": 2, "dep": 1, "rot": 8, "dim": 3, "amodel_offset": 2,
            "nuscenes_att": 8, "velocity": 3}


def pack_yuv420(bgr: np.ndarray) -> np.ndarray:
    """The host half of ``cfg.yuv_upload`` (``runner.py:81-100``): BGR uint8
    [H, W, 3] -> planar YUV 4:2:0 packed [H*3/2, W] uint8, the Y plane on
    top and the bottom H/2 rows holding U | V side by side, each [H/2, W/2]
    averaged over 2x2 blocks.  BT.601 full range;
    ``DEFTNet._decode_input`` is the device's inverse."""
    h, w = bgr.shape[:2]
    b = bgr[..., 0].astype(np.float32)
    g = bgr[..., 1].astype(np.float32)
    r = bgr[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    u2 = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v2 = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = np.clip(np.round(y), 0, 255).astype(np.uint8)
    out[h:, : w // 2] = np.clip(np.round(u2), 0, 255).astype(np.uint8)
    out[h:, w // 2:] = np.clip(np.round(v2), 0, 255).astype(np.uint8)
    return out


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
    back with an event is handed out again only after the event passed;
    a wait for one is the span ``runner.slab_wait`` and the counter
    ``slab_waits`` of ``spans``."""

    def __init__(self, pinned: bool, keep: int = 8, spans=NO_SPANS):
        self.pinned = pinned
        self.keep = keep
        self.spans = spans
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
        if event is not None and not event.query():
            with self.spans.span("runner.slab_wait"):
                event.synchronize()
            self.spans.add("slab_waits")
        return buf

    def give(self, buf: torch.Tensor, event=None):
        with self._lock:
            if len(self._free) < self.keep:
                self._free.append((buf, event))


class _FrameGraph:
    """A frame program captured as one CUDA graph: the static input it
    reads (``images``), the outputs each replay overwrites and the DCN
    kernel launches it holds.  ``call`` maps images to the program's
    outputs; ``images`` are a dispatch's, copied into the static input.
    ``held`` keeps alive the tensors the graph reads that otherwise only
    a cache of the model holds (``run_program``).

    The capture runs on a side stream, its errors confined to this
    thread's CUDA calls: the cascade worker goes on synchronizing on its
    own thread.  A capture launches nothing, so the launch counters it
    moved are taken back, and each replay adds them."""

    def __init__(self, call, images: torch.Tensor):
        self.images = images.clone()
        self.held = ()
        self.graph = torch.cuda.CUDAGraph()
        before = cuda_dcn.launch_counts()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = call(self.images)
        self.launches = {k: n - before[k]
                         for k, n in cuda_dcn.launch_counts().items()}
        cuda_dcn.add_launches({k: -n for k, n in self.launches.items()})

    def replay(self, images: torch.Tensor):
        """Run the program on ``images``, copied into the static input, on
        the current stream; returns the static outputs."""
        self.images.copy_(images)
        self.graph.replay()
        cuda_dcn.add_launches(self.launches)
        return self.outputs


class PipelinedRunner:
    """Single-sequence tracking loop for MOT/KITTI (2-D datasets)."""

    cap = 0     # > 0: detections per frame fed to the cascade at most

    def __init__(self, detector, depth: int = 3, chunk: int = 1):
        cfg = detector.cfg
        if cfg.dataset == "nuscenes":
            raise ValueError("nuScenes samples go through Detector.run_multi "
                             "(track.py::track_nuscenes), as in test.py")
        self.det = detector
        self.cfg = cfg
        self.depth = depth
        # public frames interleave their centres' uploads with the ring
        # state: one frame per dispatch (runner.py:117-119)
        self.chunk = 1 if cfg.public_det else max(1, chunk)
        # the wire encodings (runner.py:140-153, :351-352)
        self._yuv_mode = (cfg.yuv_upload and not cfg.public_det
                          and not cfg.keep_res and cfg.input_h > 0
                          and cfg.input_h % 2 == 0 and cfg.input_w % 2 == 0)
        if cfg.yuv_upload and cfg.delta_upload:
            raise ValueError("--yuv_upload and --delta_upload are mutually "
                             "exclusive (pick one wire encoding)")
        device_warp = (cfg.device_warp and not cfg.public_det
                       and not cfg.keep_res and cfg.fix_short <= 0
                       and cfg.input_h > 0)
        if device_warp and (cfg.yuv_upload or cfg.delta_upload):
            raise ValueError("--device_warp is exclusive with "
                             "--yuv_upload/--delta_upload (the device warp "
                             "consumes RAW frames)")
        self._delta_mode = (cfg.delta_upload and not cfg.public_det
                            and not cfg.keep_res and cfg.input_h > 0)
        # the input geometry follows each frame's size, or the wire carries
        # warped frames: warp on the host
        self.host_warp = (cfg.keep_res or cfg.fix_short > 0
                          or self._yuv_mode or self._delta_mode)
        # staging (runner.py:206-224); auto_tune() measures and picks
        self.stacked = bool(cfg.stacked_upload) and self.chunk > 1
        self.force_resident = False
        self.upload_parallel = False
        self._upload_pool = ThreadPoolExecutor(max_workers=UPLOAD_WORKERS)
        self._upload_streams = threading.local()
        # track_sequence(lookahead=...)'s host warps
        self._warp_pool = ThreadPoolExecutor(max_workers=max(depth, 2))
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
        # the spans and counters of the loop (timings()), shared with the
        # frame programs and the tracker; frame and chunk ids count on
        # across resets
        self.spans = Spans()
        detector.model.spans = self.spans
        self._n_frames = self._n_chunks = 0
        on_card = self.device.type == "cuda"
        self._slabs = _HostBuffers(pinned=on_card, spans=self.spans)
        self._fetch_bufs = _HostBuffers(pinned=on_card)
        self._center_bufs = _HostBuffers(pinned=on_card)
        # the frame programs' CUDA graphs (run_program): the keys dispatched
        # eager once in the runner's life, and the graphs since the reset
        self._graphs_on = self._graphs_engage()
        self._warm: set = set()
        self._graphs: Dict[tuple, _FrameGraph] = {}

        present = {"scores", "clses", "cts"}
        if {"wh", "ltrb", "ltrb_amodal"} & set(cfg.heads):
            present.add("bboxes")
        if "ltrb_amodal" in cfg.heads:
            present.add("bboxes_amodal")
        present |= {h for h in DET_DIMS if h in cfg.heads}
        self._layout = [(key, DET_DIMS[key]) for key in sorted(present)]
        self.reset()

    def auto_tune(self, frames, metas=None, verbose: bool = False) -> dict:
        """Time the staging modes of ``STAGING_MODES`` over ``frames`` (two
        chunks or more; the programs should be warm), keep the fastest and
        reset (``runner.py:278-318``).  Returns {mode: frames per second};
        {} at chunk 1 and under public detections, which have one mode."""
        if self.chunk <= 1 or self.cfg.public_det:
            return {}
        scores = {}
        for name, stacked, forced, parallel in STAGING_MODES:
            self.reset()
            self.stacked, self.force_resident = stacked, forced
            self.upload_parallel = parallel
            t0 = time.perf_counter()
            self.track_sequence(frames, metas)
            scores[name] = len(frames) / (time.perf_counter() - t0)
            if verbose:
                print(f"# auto_tune {name}: {scores[name]:.2f} fps",
                      file=sys.stderr)
        best = max(scores, key=scores.get)
        _, self.stacked, self.force_resident, self.upload_parallel = next(
            mode for mode in STAGING_MODES if mode[0] == best)
        self.reset()
        return scores

    # ---- bookkeeping ---------------------------------------------------------

    def timings(self) -> Dict[str, float]:
        """Per tracked frame since the last reset: the wall ms of each span
        (``<span>``), its thread's CPU ms (``<span>.cpu``) and each counter
        (``n.<counter>``).  ``main_keys()`` are charged to the main thread
        (their sum approximates the wall time per frame; ``program.*`` and
        ``runner.fetch`` nest in ``dispatch``, ``runner.slab_wait`` in
        ``warp``); fetch_wait and cascade (split into casc_post,
        casc_desims, casc_track, which holds the ``tracker.*`` stages) run
        on the cascade worker and overlap it."""
        return self.spans.per_frame(self.spans.count.get("cascade", 0))

    def main_keys(self) -> tuple:
        base = ("warp", "host_prep", "upload", "stage_wait", "dispatch",
                "casc_wait")
        if not self.cascade_async:
            base = base + ("fetch_wait", "cascade")
        return base

    def reset(self):
        """A fresh ring and tracker for a new sequence."""
        wait([fut for _, fut in getattr(self, "_casc_futs", [])])
        for item in getattr(self, "_pending", []):
            if item["event"] is not None:
                item["event"].synchronize()
        if self._graphs and self.device.type == "cuda":
            # a graph goes, with its memory, once its replays have run
            torch.cuda.synchronize(self.device)
        self._graphs = {}               # they hold the old ring
        self.spans.reset()
        self.state = new_ring(RING_SLOTS, self.cfg.max_object,
                              self.det.embed_dim, self.device)
        if self._delta_mode:
            shape = (self.cfg.input_h, self.cfg.input_w, 3)
            self.state["prev_frame"] = torch.zeros(
                (1,) + shape, dtype=torch.uint8, device=self.device)
            self._prev_warped = np.zeros(shape, np.uint8)
        self._pending: List[dict] = []
        self._casc_futs: List = []
        self._chunk_buf: List = []
        self._cur_stack: Optional[torch.Tensor] = None
        self._ring_dirty = False
        self.det.reset_tracking()
        self.det.tracker.spans = self.spans

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
        with self.spans.span("warp", frame=self._n_frames):
            dst = None
            if not self.host_warp:
                # the raw frame goes straight into a pooled slab: the
                # chunk's under stacked staging, its own otherwise (a warped
                # frame's size is known only after its warp: those are
                # copied later)
                if not self.stacked:
                    self._cur_stack = self._slabs.take(
                        (1,) + tuple(image_bgr.shape), torch.uint8)
                elif not self._chunk_buf:
                    self._cur_stack = self._slabs.take(
                        (self.chunk,) + tuple(image_bgr.shape), torch.uint8)
            # a chunk begun by submit_warped() has no slab: its frames are
            # copied into one at dispatch (the JAX runner indexes None here,
            # runner.py:546)
            if self._cur_stack is not None:
                slot = len(self._chunk_buf) if self.stacked else 0
                dst = self._cur_stack[slot].numpy()
            frame, frame_meta = self.warp(image_bgr, meta, dst=dst)
        return self.submit_warped(frame, frame_meta)

    def submit_warped(self, frame: np.ndarray, frame_meta: dict):
        """Feed a frame already through ``warp``."""
        if self._ring_dirty:
            raise RuntimeError(
                "a padded partial chunk was flushed (the device ring holds pad "
                "entries); call reset() before submitting more frames")
        fid = self._n_frames
        self._n_frames += 1
        with self.spans.span("host_prep", frame=fid):
            if self._delta_mode:
                payload = frame - self._prev_warped     # uint8 wraps mod 256
                self._prev_warped = frame
                frame = payload
            if self._yuv_mode:
                frame = pack_yuv420(frame)
        if not self.stacked:
            # per-frame staging: this frame's copy starts now
            with self.spans.span("upload", frame=fid):
                frame = self._upload(self._fill_slab([frame], 1))
        self._chunk_buf.append((frame, frame_meta, fid))
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

    def track_sequence(self, frames, metas=None,
                       lookahead: int = 0) -> List[List]:
        """Run a whole sequence; returns per-frame track lists.
        ``lookahead`` > 0 runs the host half of that many frames ahead on
        worker threads (``runner.py:778-813``)."""
        results: List = []

        def collect(done):
            if done is not None:
                if self.chunk > 1:
                    results.extend(done)
                else:
                    results.append(done)

        if lookahead <= 0:
            for i, frame in enumerate(frames):
                collect(self.submit(frame, metas[i] if metas else None))
            results.extend(self.flush())
            return results
        n = len(frames)

        def warp_ahead(i):
            return self._warp_pool.submit(self.warp, frames[i],
                                          metas[i] if metas else None)

        futs = [warp_ahead(i) for i in range(min(lookahead, n))]
        for i in range(n):
            if i + lookahead < n:
                futs.append(warp_ahead(i + lookahead))
            with self.spans.span("warp", frame=self._n_frames):
                frame, frame_meta = futs[i].result()
            collect(self.submit_warped(frame, frame_meta))
        results.extend(self.flush())
        return results

    # ---- staging ------------------------------------------------------------

    def _fill_slab(self, frames: List[np.ndarray],
                   length: int) -> torch.Tensor:
        """The host slab [length, ...] holding ``frames`` in order: the
        current slab where they were warped into it (a padded chunk's
        repeats are copied in), else a pooled one they are copied into."""
        slab, self._cur_stack = self._cur_stack, None
        if slab is None or not (
                slab.shape[0] == length
                and all(np.shares_memory(f, slab.numpy()) for f in frames)):
            if slab is not None:
                self._slabs.give(slab)
            slab = self._slabs.take((length,) + frames[0].shape, torch.uint8)
        for i, f in enumerate(frames):
            slot = slab[i].numpy()
            if not np.shares_memory(f, slot):
                np.copyto(slot, f)
        return slab

    def _copy(self, slab: torch.Tensor):
        """One copy of ``slab`` to the device on the calling thread's
        current stream -> (device tensor, event behind the copy); on the
        CPU a plain copy and no event."""
        if self.device.type != "cuda":
            return slab.clone(), None
        images = slab.to(self.device, non_blocking=True)
        return images, self._record_event()

    def _copy_on_own_stream(self, slab: torch.Tensor):
        """``_copy`` on the upload worker's own CUDA stream."""
        if self.device.type != "cuda":
            return self._copy(slab)
        stream = getattr(self._upload_streams, "stream", None)
        if stream is None:
            stream = self._upload_streams.stream = torch.cuda.Stream(
                self.device)
        with torch.cuda.stream(stream):
            return self._copy(slab)

    def _upload(self, slab: torch.Tensor) -> torch.Tensor:
        """Send a filled slab to the device in the staging mode set; the
        slab returns to its pool behind the copy's event."""
        if self.upload_parallel:
            images, event = self._upload_pool.submit(
                self._copy_on_own_stream, slab).result()
            if event is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(event)
                # the copy's memory is in use on the compute stream too
                images.record_stream(compute)
        else:
            images, event = self._copy(slab)
        self._slabs.give(slab, event)
        if self.force_resident and event is not None:
            with self.spans.span("stage_wait"):
                event.synchronize()
        return images

    def _dispatch_chunk(self):
        if not self._chunk_buf:
            return
        frames = [f for f, _, _ in self._chunk_buf]
        metas = [m for _, m, _ in self._chunk_buf]
        fids = [i for _, _, i in self._chunk_buf]
        self._chunk_buf = []
        cid = self._n_chunks
        self._n_chunks += 1
        n_real = len(frames)
        if n_real < self.chunk:
            # pad to the chunk length by repeating the last frame
            # (runner.py:614-622); the pad's outputs are dropped below
            self._ring_dirty = True
            frames += [frames[-1]] * (self.chunk - n_real)
        with self.spans.span("upload", chunk=cid):
            if self.stacked:
                images = self._upload(self._fill_slab(frames, self.chunk))
            else:
                # per-frame staging: the frames are on the device already
                images = frames[0] if self.chunk == 1 else torch.cat(frames)

        with self.spans.span("dispatch", chunk=cid):
            if self.cfg.public_det and "cur_dets" in metas[0]:
                item = self._dispatch_public(images, metas[0])
            else:
                packed, sims = self.run_program(images, metas[0])
                item = self._fetch(sims[:n_real], packed[:n_real])
                item["metas"] = metas
            item["chunk"], item["frames"] = cid, fids
            self._pending.append(item)

    def run_program(self, images: torch.Tensor, frame_meta: dict):
        """Queue the frame program of one dispatch on the device: images
        [chunk, ...] as uploaded, ``frame_meta`` the first frame's ->
        (packed [chunk, L], sims [chunk, ...]); the ring is updated in
        place.  The bench times it alone.

        Where graphs engage (``_graphs_engage``), the first dispatch of a
        key (``_graph_key``) in the runner's life runs eager: it builds the
        kernels, cuDNN's plans and the device warp's matrices, none of
        which a capture may do.  The first of the key since ``reset()``
        captures the program (span ``program.capture``) and replays it;
        each later one copies its images into the graph's static input
        and replays (``program.replay``), returning the graph's outputs,
        which the next replay overwrites.  A dispatch counts in
        ``eager_programs``, ``graph_captures`` or ``graph_replays``."""
        kw = self._program_kw(frame_meta)
        key = (self._graph_key(images.shape, images.dtype, kw)
               if self._graphs_on else None)
        graph = self._graphs.get(key)
        if graph is not None:
            self.spans.add("graph_replays")
            with self.spans.span("program.replay"):
                return graph.replay(images)
        call = self._program(images.shape[0], kw)
        if key is None or key not in self._warm:
            if key is not None:
                self._warm.add(key)
            self.spans.add("eager_programs")
            return call(images)
        self.spans.add("graph_captures")
        with self.spans.span("program.capture"):
            graph = self._graphs[key] = _FrameGraph(call, images)
            # the device warp's matrices the capture read: the model's
            # cache of them may drop them while the graph lives
            graph.held = tuple(self.det.model._hats.values())
            return graph.replay(images)

    def _graphs_engage(self) -> bool:
        """Whether the frame programs run as CUDA graphs: on a card, where
        every state the program updates is updated in place (not under
        delta uploads, which rebind the ring's ``prev_frame``, nor under
        public detections, whose centres go up per frame)."""
        return (self.device.type == "cuda" and not self._delta_mode
                and not self.cfg.public_det)

    def _program_kw(self, frame_meta: dict) -> dict:
        """The frame program's keyword arguments for a dispatch whose
        first frame has ``frame_meta``."""
        return dict(k=self.cfg.K, class_filter=self.class_filter,
                    sims_quant=self.cfg.sims_quant,
                    sim_window=self.sim_window,
                    parity_tf=self._parity_tf(frame_meta),
                    warp_tf=frame_meta["warp_tf"],
                    warp_out=(frame_meta["inp_height"],
                              frame_meta["inp_width"]),
                    flip_test=self.cfg.flip_test, yuv_in=self._yuv_mode)

    def _program_name(self, n: int) -> str:
        if n == 1:
            return "frame_step"
        return ("frame_chunk_batched" if self.cfg.chunk_batched
                else "frame_chunk")

    def _program(self, n: int, kw: dict):
        """The frame program of a dispatch of ``n`` frames as a function
        of its images -> (packed [n, L], sims [n, ...]), writing the
        ring."""
        program = getattr(self.det.model, self._program_name(n))
        state, thresh = self.state, self.cfg.out_thresh
        if n > 1:
            return lambda images: program(images, state, thresh, **kw)

        def step(images):
            packed, sims = program(images, state, thresh, **kw)
            return packed[None], sims[None]

        return step

    def _graph_key(self, shape, dtype, kw: dict) -> tuple:
        """Everything on the host that a frame program bakes in: the
        program, its input's shape and dtype, its arguments (the
        transforms as float32 values) and ``out_thresh``."""
        def values(tf):
            return (None if tf is None else tuple(
                float(v) for v in np.asarray(tf, np.float32).ravel()))

        return (self._program_name(shape[0]), tuple(shape), dtype,
                values(kw["warp_tf"]), tuple(kw["warp_out"]),
                values(kw["parity_tf"]), kw["k"], kw["class_filter"],
                kw["sims_quant"], kw["sim_window"], kw["flip_test"],
                kw["yuv_in"], float(self.cfg.out_thresh))

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
        self.spans.add("eager_programs")
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
        with self.spans.span("runner.fetch"):
            if packed is None:
                packed = sims.new_zeros((0,), dtype=torch.float32)
            blob = torch.cat([packed.reshape(-1).view(torch.uint8),
                              sims.reshape(-1).view(torch.uint8)])
            host = self._fetch_bufs.take((blob.numel(),), torch.uint8)
            host.copy_(blob, non_blocking=True)
            event = self._record_event()
        return {"host": host, "event": event,
                "packed_shape": tuple(packed.shape),
                "sims_shape": tuple(sims.shape),
                "sims_dtype": (np.uint8 if sims.dtype == torch.uint8
                               else np.float16)}

    # ---- the cascade worker --------------------------------------------------

    def _enqueue_finish(self, item: dict):
        if self.cascade_async:
            fut = self._casc_pool.submit(self._finish, item)
        else:
            fut = _Ready(self._finish(item))
        self._casc_futs.append((item["chunk"], fut))

    def _pop_ready(self, out: List, drain: bool = False):
        """Block on cascades beyond CASCADE_DEPTH (in steady state already
        done) and append their frames' track lists to ``out``."""
        while self._casc_futs and (drain
                                   or len(self._casc_futs) > CASCADE_DEPTH):
            cid, fut = self._casc_futs.pop(0)
            with self.spans.span("casc_wait", chunk=cid):
                res = fut.result()
            out.extend(res)

    def _finish(self, item: dict) -> List[List]:
        """Wait for a dispatch's copy, then post-process and track each of
        its frames in order."""
        cid, fids = item["chunk"], item["frames"]
        with self.spans.span("fetch_wait", chunk=cid):
            if item["event"] is not None:
                item["event"].synchronize()
        raw = item["host"].numpy()
        n_packed = int(np.prod(item["packed_shape"])) * 4
        packed = raw[:n_packed].view(np.float32).reshape(item["packed_shape"])
        sims = raw[n_packed:].view(item["sims_dtype"]).reshape(
            item["sims_shape"])
        try:
            if "public" in item:
                return [self._finish_frame(None, sims[0], None, cid, fids[0],
                                           item["public"])]
            return [self._finish_frame(packed[t], sims[t], meta, cid,
                                       fids[t])
                    for t, meta in enumerate(item["metas"])]
        finally:
            self._fetch_bufs.give(item["host"])

    def _finish_frame(self, packed: Optional[np.ndarray], sims: np.ndarray,
                      meta: Optional[dict], chunk: int, frame: int,
                      public=None) -> List:
        """Post-process one frame's packed detections, or take its public
        ones (runner.py:480-492), then run the tracker on its sims."""
        spans = self.spans
        with spans.span("cascade", chunk=chunk, frame=frame):
            with spans.span("casc_post"):
                if public is not None:
                    results = public
                else:
                    dets, n_valid = unpack_dets(packed, self._layout,
                                                self.cfg.K)
                    if self.cap:
                        n_valid = min(n_valid, self.cap)
                    results = self.det.post_process(dets, meta)
                    if self.cfg.dataset == "kitti_tracking":
                        results = [d for d in results if d["class"] == 2]
                    results = results[:n_valid]
            with spans.span("casc_desims"):
                sims = (sims.astype(np.float32) / 255.0
                        if sims.dtype == np.uint8
                        else sims.astype(np.float32))
            with spans.span("casc_track"):
                out = self.det.tracker.update(results, None, sims=sims)
                if self.cascade_async:
                    out = [TrackView(t) for t in out]
        return out
