"""Rig cells: a nuScenes-like scene played through the program's six-camera
rig, one ``Detector.run_multi`` per sample, as ``track.py::
track_nuscenes`` and ``test.py`` drive it.

Set-up (all of it in ``setup_s``): the program's ``Detector`` as the
configuration's recipe test line builds it (``deft_tpu_torch.cli.
parse_config``), with the seeded LSTM (``rig_program.lstm_state_dict``);
the scene's frames and image infos made on the device from the seed
(``benchmarks/rig_scenes.py``) and copied to host memory, where the
cameras' decoders would leave them; weights made on the device from the
seed and calibrated on ``calibration_samples`` of the scene's samples and
the program's logits of them (``rig_program.make_rig_weights``);
``warmup_samples`` samples, then fresh trackers (ids go on).

The window: a closed loop over the scene's samples played forward and
backward, one ``run_multi`` after another, each camera with its ``calib``
and image info, for ``--seconds``; each run from one end of the scene to
the other is a scene of its own, on fresh trackers (ids go on), as an
offline evaluation runs scene after scene (``rig_scenes.new_scene``,
``deft_tpu_torch/track.py``); ``track_fps`` counts the camera frames
(six a sample) whose tracks came back inside the window.  What each
camera hands on, every LSTM step and every 3-D IoU matrix are recorded
(``rig_compare.py``), and at the window's end the LSTM state each track
carries.  After the window the peak memory is read and the
program freed; blocks of samples drawn from the seed are judged by the
reference, and every camera of the window by the plain 3-D cascade.

With ``--trace 1`` the loop goes on for ``trace_seconds`` more under the
profiler, each sample inside the span ``sample``.  The host's per-layer
numbers come from the window (the detector's spans and counters, per
sample), the device's from the traced stretch.
"""

from __future__ import annotations

import gc
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmarks import counts, rig_compare, rig_scenes
from benchmarks.cells.track import cpu_seconds
from benchmarks.compare import Geometry, TrackJudge
from benchmarks.program import calibration_indices, launches, program_config
from benchmarks.reference.cascade3d import CLASS_NAMES
from benchmarks.reference.deft_ref import Reference, dla34_spec
from benchmarks.rig_program import (class_cut, lstm_state_dict,
                                    make_rig_weights)
from benchmarks.rig_scenes import new_scene
from benchmarks.scenes import pingpong
from benchmarks.trace import DeviceTrace, top


class RigRecorder:
    """Keeps what each camera of the rig hands on (module docstring of
    ``rig_compare.py``), by wrapping the detector's post-processing, each
    class tracker's ring ingest and LSTM step, and the 3-D IoU."""

    def __init__(self, det, matching):
        self.cameras = []
        self.lstm = {}           # (camera index, id) -> (h', deltas)
        self.iou = []            # (a boxes, b boxes, matrix)
        self._matching = matching
        self._iou3d = matching.pairwise_iou3d
        post = det.post_process

        def post_process(dets, meta):
            results = post(dets, meta)
            self.cameras.append(rig_compare.CameraRecord.of(dets, results))
            return results

        det.post_process = post_process
        self._wrap_trackers(det)

        def pairwise_iou3d(a, b):
            out = self._iou3d(a, b)
            if len(a) and len(b):
                self.iou.append((np.array(a, np.float64),
                                 np.array(b, np.float64), out))
            return out

        matching.pairwise_iou3d = pairwise_iou3d

    def new_scene(self, det):
        """Fresh trackers for a new scene (``Detector.reset_tracking``),
        recorded as the old ones were."""
        det.reset_tracking()
        self._wrap_trackers(det)

    def _wrap_trackers(self, det):
        for name, tracker in det.tracker.items():
            self._wrap(name, tracker)

    def _wrap(self, name, tracker):
        ring = tracker.recorder
        ingest = ring.ingest

        def record_ingest(frame_index, sims, n):
            if n and frame_index not in ring.slot_of:
                self.cameras[-1].updates[name] = (
                    n, np.array(sims[:, :, : n + 1], np.float32))
            return ingest(frame_index, sims, n)

        ring.ingest = record_ingest
        flush = tracker._flush_lstm

        def record_flush(tracks):
            staged = {}
            for t in tracks:
                if t._pending_feat is not None and id(t) not in staged:
                    f = t._pending_feat.astype(np.float64)
                    staged[id(t)] = (t, np.array([f[0], f[1], f[2], f[15]]))
            flush(tracks)
            g = len(self.cameras) - 1
            for t, base in staged.values():
                preds = np.stack([t.future_predictions[k]
                                  for k in sorted(t.future_predictions)])
                self.lstm[(g, int(t.track_id))] = (
                    np.array(t.hn[0], np.float32), preds[:, 3:7] - base)

        tracker._flush_lstm = record_flush

    def emit(self, tracks):
        """``run_multi``'s ``materialize``: a camera's emitted tracks."""
        self.cameras[-1].emitted = rig_compare.emitted_of(tracks)
        return tracks

    def held_state(self, det) -> dict:
        """The LSTM state every track of the class trackers carries: id ->
        (h, c)."""
        return {int(t.track_id): (np.array(t.hn), np.array(t.cn))
                for tracker in det.tracker.values()
                for t in tracker.tracked_stracks + tracker.lost_stracks}

    def stop(self):
        self._matching.pairwise_iou3d = self._iou3d


def run(ctx) -> dict:
    args, config, traffic, dev = ctx.args, ctx.config, ctx.traffic, ctx.device
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.tracking import matching

    cfg = program_config(config, "test_line")
    spec = dla34_spec(config)
    frames, infos = rig_scenes.make_rig(traffic["scene"], args.seed, dev)
    n_src, n_cams = frames.shape[:2]
    calib = frames[calibration_indices(n_src, traffic["calibration_samples"])]
    lstm_sd = lstm_state_dict(args.seed, dev)
    det = Detector(cfg, device=dev, motion_state_dict=lstm_sd)
    sd = make_rig_weights(det, config, spec, calib.flatten(0, 1), args.seed,
                          dev, ctx.log)
    # the frames wait in host memory, as the cameras' decoders leave them,
    # the reference's weights too: the device holds the program's state
    # alone from here to the window's end
    host = frames.contiguous().cpu().numpy()
    frame_hw = tuple(frames.shape[2:4])
    sd = {k: v.cpu() for k, v in sd.items()}
    lstm_sd = {k: v.cpu() for k, v in lstm_sd.items()}
    del frames, calib
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    metas = [[{"calib": info["calib"]} for info in row] for row in infos]

    def sample(i, materialize=None):
        s = pingpong(i, n_src)
        return det.run_multi(list(host[s]), metas[s], infos[s],
                             materialize=materialize)

    def timed_sample(i):
        if new_scene(i, n_src):
            rec.new_scene(det)
        return sample(i, rec.emit)

    for i in range(traffic["warmup_samples"]):
        sample(i)
    det.reset_tracking()
    det.timers.reset()
    if ctx.fault is not None:
        ctx.fault(det)
    rec = RigRecorder(det, matching)
    setup_s = time.perf_counter() - ctx.t_start

    seconds = args.seconds
    submitted = done = 0
    cpu0 = cpu_seconds()
    t0 = time.perf_counter()
    end = t0 + seconds
    stamps = []
    while time.perf_counter() < end:
        out = timed_sample(submitted)
        submitted += 1
        stamps.append(time.perf_counter() - t0)
        if stamps[-1] <= seconds:
            done += len(out)
    cpu_s = cpu_seconds() - cpu0
    attempted = submitted * n_cams
    held = rec.held_state(det)
    n_window = len(rec.cameras)
    window = {"seconds": seconds, "frames": done, "samples": submitted,
              "timings": det.timers.per_frame(submitted),
              "counts": det.timers.count}

    trace = trace_launches = None
    if args.trace:
        n0 = launches()
        with DeviceTrace() as tr:
            t1 = time.perf_counter() + traffic["trace_seconds"]
            while time.perf_counter() < t1:
                with torch.profiler.record_function("sample"):
                    timed_sample(submitted)
                submitted += 1
        n1 = launches()
        trace = tr.summary()
        trace_launches = {k: n1[k] - n0[k] for k in n0}
    rec.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    n_done = done // n_cams
    records = rec.cameras[: done]
    window_records = rec.cameras[: n_window]
    n_recorded = len(rec.cameras)
    n_dets = [len(r) for r in rec.cameras] or [0]
    ctx.log(f"# samples: {n_done} in the window ({submitted} submitted), "
            f"detections per camera {np.mean(n_dets):.2f} (min "
            f"{min(n_dets)}, max {max(n_dets)}), tracks emitted per camera "
            f"{np.mean([len(r.emitted) for r in rec.cameras] or [0]):.2f}, "
            f"peak {peak} bytes, setup {setup_s:.2f} s")
    per_class, at_cut = {}, {}
    for r in records:
        for c, (n, _) in r.updates.items():
            per_class[c] = per_class.get(c, 0) + n
        for c, score in zip(r.res["cls"] - 1, r.res["score"]):
            if score >= class_cut(c):
                at_cut[CLASS_NAMES[c]] = at_cut.get(CLASS_NAMES[c], 0) + 1
    n_rec = max(len(records), 1)
    ctx.log(f"# class updates with detections per sample "
            f"{sum(len(r.updates) for r in records) / max(n_done, 1):.2f}; "
            "detections per camera by class " + json.dumps(
                {c: round(n / n_rec, 3) for c, n in per_class.items()})
            + ", before the NMS " + json.dumps(
                {c: round(n / n_rec, 3) for c, n in at_cut.items()}))
    ctx.log(f"# host: {cpu_s:.2f} CPU seconds in the {seconds:g} s window; "
            "samples done by quarter of the window: " + ", ".join(
                str(sum(q * seconds / 4 < t <= (q + 1) * seconds / 4
                        for t in stamps)) for q in range(4)))
    ctx.log("# ms/sample: " + ", ".join(
        f"{k} {v:.3f}" for k, v in window["timings"].items()))

    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in det.model.state_dict().items()}
    max_object = cfg.max_object
    del det, rec.cameras
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # every camera of the window, the last sample's too when it came back
    # after the window's end: the carried state is read after it
    cam_infos = [infos[pingpong(j, n_src)][k] for j in range(n_window
                                                              // n_cams)
                 for k in range(n_cams)]
    geom = Geometry.of(config, *frame_hw)
    frames = torch.from_numpy(host).to(dev)
    sd = {k: v.to(dev) for k, v in sd.items()}
    judge = rig_compare.RigJudge(TrackJudge(Reference(sd, spec), config,
                                            geom), n_cams)
    order = [pingpong(j, n_src) for j in range(n_done)]
    starts = {j * n_cams for j in range(n_window // n_cams)
              if new_scene(j, n_src)}
    cmp = traffic["compare"]
    blocks = rig_compare.choose_blocks(n_done, cmp["block_samples"],
                                       cmp["blocks"], args.seed)
    t_ref = time.perf_counter()
    readings = judge.judge(frames, order, records, cam_infos, blocks, starts)
    t_casc = time.perf_counter()
    readings["id_misses"], readings["lstm_rel"], load = \
        rig_compare.cascade_check(window_records, cam_infos, rec.lstm,
                                  lstm_sd, max_object, held=held,
                                  starts=starts)
    readings["iou3d_gap"] = rig_compare.iou3d_gap(rec.iou)
    ctx.log(f"# reference: {readings['frames']} cameras, "
            f"{readings['detections']} detections, "
            f"{readings['sim_updates']} similarity updates in "
            f"{t_casc - t_ref:.2f} s, blocks {blocks}; the cascade over "
            f"{len(window_records)} cameras in "
            f"{time.perf_counter() - t_casc:.2f} "
            f"s, per camera {load['tracks_held']:.2f} tracks held, "
            f"{load['births']:.2f} born, {load['iou3d_pairs']:.2f} 3-D IoU "
            f"pairs; {len(rec.iou)} IoU matrices")
    ctx.log("# readings: " + json.dumps(readings))
    checks = {k: readings[k] for k in ctx.limits}

    layer = SimpleNamespace(window=window, trace=trace,
                            launches=trace_launches, dtype=cfg.compute_dtype)
    breakdown = None
    if args.trace:
        h, w = config["input_h"], config["input_w"]
        flops, layers = counts.frame_flops(shapes, spec, h, w, 0)
        layer.flops_per_frame = flops
        layer.dcn_layers = layers
        breakdown = {"device_ops": top(trace["kernels"]),
                     "idle_gaps": top(trace["idle"])}
        ctx.log(f"# frame FLOPs {flops:.6g}; traced "
                f"{trace['window_s']:.3f} s, busy {trace['busy_s']:.3f} s, "
                f"launches {trace_launches}")
    return {"end_to_end": {"track_fps": done / seconds, "setup_s": setup_s},
            "layer": layer, "checks": checks, "attempted": attempted,
            # cameras that never came back; a run that judged none, or none
            # with a detection where the reference has peaks due, fails
            "failed": max(attempted - min(n_recorded, attempted),
                          int(readings["frames"] == 0),
                          int(readings["detections"] == 0
                              and readings["due"] > 0)),
            "memory_peak_bytes": int(peak),
            "trace": trace, "breakdown": breakdown}
