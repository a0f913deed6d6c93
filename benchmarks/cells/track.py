"""Track cells: a video played through the program's tracking loop.

Set-up (all of it in ``setup_s``): the program's ``Detector`` and
``PipelinedRunner`` as the configuration's recipe test line builds them
(``deft_tpu_torch.cli.parse_config``), the runner's chunk, depth and
staging fixed by the traffic; weights made on the device from the seed and
calibrated by the reference (``benchmarks/weights.py``); the scene's frames
made on the device from the seed (``benchmarks/scenes.py``) and copied to
host memory, where a camera's decoder would leave them; a warm-up of
``warmup_chunks`` chunks, then a reset.

The window: a closed loop over the frames played forward and backward,
one ``submit`` after another for ``--seconds``; ``track_fps`` counts the
frames whose tracks came back inside the window.  Every frame's
detections, similarity and emitted tracks, as the runner hands them to and
takes them from its cascade, are recorded.  After the window the queue is
flushed, the peak memory read, the program freed; blocks of frames drawn
from the seed are judged by the reference, and every frame of the window
by the plain cascade (``benchmarks/compare.py``).

With ``--trace 1`` the loop goes on for ``trace_seconds`` more under the
profiler, with the pipeline full as in the window, and stops at a whole
chunk; the queue is flushed after the trace.  The host's per-layer numbers
come from the window, the device's from the traced stretch.

The process's CPU seconds over the window go to standard error: the
window's rate is the host's, and they say how many cores it kept busy.
"""

from __future__ import annotations

import gc
import json
import resource
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmarks import compare, counts, scenes, weights
from benchmarks.program import (calibration_indices, launches,
                                make_weights, program_config)
from benchmarks.reference.deft_ref import Reference, dla34_spec
from benchmarks.trace import DeviceTrace, top


class Recorder:
    """Wraps the tracker's ``update``: keeps what the runner's cascade
    receives and returns for every frame."""

    def __init__(self, det):
        self.records = []
        tracker = det.tracker
        inner = tracker.update

        def update(results, embeddings, sims=None, **kw):
            out = inner(results, embeddings, sims=sims, **kw)
            tracks = (np.array([t.track_id for t in out], np.int64),
                      np.array([t.tlbr for t in out],
                               np.float64).reshape(-1, 4),
                      np.array([t.score for t in out], np.float64))
            self.records.append(compare.Record.of(results, sims, tracks))
            return out

        tracker.update = update


def cpu_seconds() -> float:
    """This process's CPU seconds so far, all its threads."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def run(ctx) -> dict:
    args, config, traffic, dev = ctx.args, ctx.config, ctx.traffic, ctx.device
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.inference.runner import PipelinedRunner

    runner_params = traffic["runner"]
    cfg = program_config(config, "test_line",
                         ["--chunk_batched"] if runner_params[
                             "chunk_batched"] else [])
    spec = dla34_spec(config)
    det = Detector(cfg, device=dev)
    frames, _ = scenes.make_scene(traffic["scene"], args.seed, dev)
    n_src = frames.shape[0]
    sd = make_weights(det.model, config, spec, frames[calibration_indices(
        n_src, traffic["calibration_frames"])], args.seed, dev, ctx.log)
    det.model.load_state_dict(sd)
    # the frames wait in host memory, each a contiguous [H, W, 3] image as
    # a camera's decoder leaves it, the reference's weights too: the device
    # holds the program's state alone from here to the window's end
    host = frames.contiguous().cpu().numpy()
    frame_hw = tuple(frames.shape[1:3])
    sd = {k: v.cpu() for k, v in sd.items()}
    del frames
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    runner = PipelinedRunner(det, depth=runner_params["depth"],
                             chunk=runner_params["chunk"])
    runner.stacked = runner_params["staging"] == "stacked"
    runner.force_resident = False
    runner.upload_parallel = False

    def frame(i):
        return host[scenes.pingpong(i, n_src)]

    warm = runner_params["chunk"] * traffic["warmup_chunks"]
    runner.track_sequence([frame(i) for i in range(warm)])
    runner.reset()
    if ctx.fault is not None:
        ctx.fault(runner)
    rec = Recorder(det)
    setup_s = time.perf_counter() - ctx.t_start

    seconds = args.seconds
    submitted = done = 0
    cpu0 = cpu_seconds()
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        out = runner.submit(frame(submitted))
        submitted += 1
        if out and time.perf_counter() <= end:
            done += len(out)
    cpu_s = cpu_seconds() - cpu0
    window = {"seconds": seconds, "frames": done,
              "timings": runner.timings()}
    in_window = submitted

    trace = trace_launches = None
    if args.trace:
        # the loop goes on into the traced stretch with the pipeline full,
        # as in the window, up to a whole chunk (a flush inside would pad a
        # partial one and drain the queue)
        chunk = runner_params["chunk"]
        n0 = launches()
        with DeviceTrace() as tr:
            t1 = time.perf_counter() + traffic["trace_seconds"]
            while time.perf_counter() < t1 or submitted % chunk:
                with torch.profiler.record_function("submit"):
                    runner.submit(frame(submitted))
                submitted += 1
        n1 = launches()
        trace = tr.summary()
        trace_launches = {k: n1[k] - n0[k] for k in n0}
    runner.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    records = rec.records[:done]
    n_recorded = len(rec.records)
    n_dets = [len(r) for r in rec.records]
    ctx.log(f"# frames: {done} in the window ({submitted} submitted), "
            f"detections per frame {np.mean(n_dets):.2f} (min "
            f"{min(n_dets)}, max {max(n_dets)}), tracks per frame "
            f"{np.mean([len(r.tracks[0]) for r in rec.records]):.2f}, "
            f"peak {peak} bytes, setup {setup_s:.2f} s")
    ctx.log(f"# host: {cpu_s:.2f} CPU seconds in the {seconds:g} s window")
    ctx.log("# runner ms/frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in window["timings"].items()))

    shapes = weights.state_shapes(det.model)
    del runner, det, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    geom = compare.Geometry.of(config, *frame_hw)
    frames = torch.from_numpy(host).to(dev)
    sd = {k: v.to(dev) for k, v in sd.items()}
    judge = compare.TrackJudge(Reference(sd, spec), config, geom)
    order = [scenes.pingpong(j, n_src) for j in range(len(records))]
    cmp = traffic["compare"]
    blocks = compare.choose_blocks(
        len(records), config["sim_window"] + cmp["sim_frames"],
        cmp["blocks"], args.seed)
    t_ref = time.perf_counter()
    readings = judge.judge(frames, order, records, blocks)
    t_casc = time.perf_counter()
    readings["id_misses"], load = compare.cascade_misses(records, config)
    ctx.log(f"# reference: {readings['frames']} frames, "
            f"{readings['detections']} detections, "
            f"{readings['sim_frames']} similarity frames in "
            f"{t_casc - t_ref:.2f} s, blocks {blocks}; the cascade over "
            f"{len(records)} frames in {time.perf_counter() - t_casc:.2f} s, "
            f"per frame {load['tracks_held']:.2f} tracks held, "
            f"{load['births']:.2f} born")
    ctx.log("# readings: " + json.dumps(readings))
    checks = {k: readings[k] for k in ctx.limits}

    layer = SimpleNamespace(window=window, trace=trace,
                            launches=trace_launches, dtype=cfg.compute_dtype)
    breakdown = None
    if args.trace:
        flops, layers = counts.frame_flops(
            shapes, spec, config["input_h"], config["input_w"],
            config["sim_window"])
        layer.flops_per_frame = flops
        layer.dcn_layers = layers
        breakdown = {"device_ops": top(trace["kernels"]),
                     "idle_gaps": top(trace["idle"])}
        ctx.log(f"# frame FLOPs {flops:.6g}; traced {trace['window_s']:.3f}"
                f" s, busy {trace['busy_s']:.3f} s, launches "
                f"{trace_launches}")
    return {"end_to_end": {"track_fps": done / seconds, "setup_s": setup_s},
            "layer": layer, "checks": checks, "attempted": in_window,
            # frames that never came back; a run that judged none, or none
            # with a detection where the reference has peaks due, fails
            "failed": max(in_window - min(n_recorded, in_window),
                          int(readings["frames"] == 0),
                          int(readings["detections"] == 0
                              and readings["due"] > 0)),
            "memory_peak_bytes": int(peak),
            "trace": trace, "breakdown": breakdown}
