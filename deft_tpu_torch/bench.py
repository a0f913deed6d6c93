"""End-to-end tracking benchmark of the port, the counterpart of the root
``bench.py`` with the same flags, phases and JSON line:

    python -m deft_tpu_torch.bench [--smoke] [--frames N] [--fp32] ...

MOT17 tracking through ``PipelinedRunner`` (chunk 4, depth 2 by default) at
``mot_config(track_thresh=1e-3, sims_quant=True)``: DLA-34, the hybrid
DCN, 544x960, K=100, on synthetic 1080x1920 frames (``make_synthetic_frame``,
``bench.py:27-36``).  The threshold is dropped so that, with seeded random
weights, all K=100 candidates flow through the cascade: a max-load number
(MOT17 frames average ~30 detections; ``--max-dets 32`` caps them).

Phases, as in ``bench.py``: a warm-up sequence, ``auto_tune`` of the
staging modes at chunk > 1, three timed passes (their median is the
number), the wire probe and the FLOPs of one frame program.  ONE JSON line
goes to stdout, ``#`` lines to stderr:

* ``value``: frames per second of the median pass; ``e2e_ms_per_frame``,
  and ``t_<bucket>_ms`` per frame from ``runner.timings()``, the
  main-thread buckets of ``runner.main_keys()`` first;
  ``unattributed_ms_per_frame`` is what they leave of the wall time;
  ``t_dispatch_wait_ms``, the part of ``dispatch`` its thread spent off the
  CPU (the interpreter lock, the host's scheduler), and ``n_<counter>``,
  the cascade's load per frame (``n_dets``, ``n_matched``, ``n_births``,
  ``n_tracks_held``, ``n_tracks_removed``; ``n_slab_waits``, uploads
  waited for);
* ``wire_rtt_ms``: a tiny host-to-device copy, an add and the copy back;
  ``wire_frame_up_ms`` / ``_mbps`` and ``wire_chunk_up_*``: one copy from
  pinned memory, timed by CUDA events, of what the runner uploads per frame
  and per chunk in its mode (the raw frame under the device warp, the
  packed or delta warped frame under ``--yuv`` or ``--delta``);
* with ``--profile DIR`` only: ``device_busy_ms_per_frame``, the union of
  the card's kernel, copy and memset intervals in the trace of the timed
  passes (``tools/trace_device_ms.device_busy``) over their frames, and
  ``mfu``: the FLOPs of one frame program (``FlopCounterMode``, each DCN
  layer's product counted as 2*H*W*9*Cin*Cout whatever computes it) over
  that busy time and the card's dense peak for the compute dtype
  (``PEAKS``); a card not in the table, or a trace with no device time,
  gets no ``mfu``.  The FLOPs are also on a ``#`` line.

There is no ``vs_baseline``: the root bench's 60 fps target was set for a
TPU.  ``--smoke`` runs on the CPU at 128x160 with ``dla_node="conv"`` and 12
frames; otherwise the card is used and its absence raises.  ``--profile
DIR`` writes a ``torch.profiler`` chrome trace of the timed passes to
``DIR/trace.json`` (``tools/trace_device_ms.py`` reads it) and the runner's
spans of those passes, with their chunk and frame ids on the trace's clock,
to ``DIR/spans.jsonl`` (``utils/spans.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

METRIC = "e2e_mot17_tracking_fps_per_chip"
# dense peak FLOP/s by torch.cuda.get_device_name() and compute dtype: bf16
# tensor cores, and float32 without TF32 (the port's parity mode)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 67e12}}
# the cascade worker's buckets, reported beside the main thread's
WORKER_KEYS = ("fetch_wait", "cascade", "casc_post", "casc_desims",
               "casc_track")
# kernel (chip_smoke.py's names) -> its launch counter in ops/cuda_dcn.py
LAUNCH_COUNTERS = {"dcn_sample": "LAUNCHES", "dcn_sample_tap": "LAUNCHES_TAP",
                   "dcn_fused": "LAUNCHES_FUSED",
                   "dcn_sample_onehot": "LAUNCHES_ONEHOT",
                   "dcn_backward": "LAUNCHES_BACKWARD",
                   "dcn_backward_entry": "LAUNCHES_BACKWARD_ENTRY"}


def make_synthetic_frame(t, h, w, n_obj=12, seed=0):
    """Frame t of the bench's scene (``bench.py:27-36``): coloured
    rectangles moving right over a grey background."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 40, np.uint8)
    for i in range(n_obj):
        speed = 1.0 + 3.0 * rng.rand()
        y = int(rng.rand() * (h - 120))
        x = int((30 + speed * 4 * t + i * w / n_obj) % (w - 80))
        color = tuple(int(c) for c in rng.randint(60, 255, 3))
        img[y: y + 100, x: x + 50] = color
    return img


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU for a fast correctness check")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--warmup", type=int, default=15)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--chunk", type=int, default=4,
                    help="frames per dispatch")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipeline depth (dispatches in flight)")
    ap.add_argument("--delta", action="store_true",
                    help="upload uint8 differences of the warped frames "
                         "(bit-exact)")
    ap.add_argument("--max-dets", type=int, default=0,
                    help="cap detections/frame fed to the cascade (0 = all "
                         "K=100; 32 emulates a trained detector's load)")
    ap.add_argument("--profile", type=str, default="",
                    help="directory for a torch.profiler chrome trace of the "
                         "timed passes")
    ap.add_argument("--chunk-batched", action="store_true",
                    help="batch the model forward over each chunk "
                         "(frame_chunk_batched)")
    ap.add_argument("--device-warp", action="store_true",
                    help="cfg.device_warp (the port warps fix_res frames on "
                         "the card whatever this says; with --yuv or --delta "
                         "it raises, as in the JAX runner)")
    ap.add_argument("--dcn-layer-radii", type=str, default="",
                    help="per-layer DCN clamp radii (JSON path-substring -> "
                         "radius, as tools.measure_dcn_offsets prints)")
    ap.add_argument("--yuv", action="store_true",
                    help="upload planar YUV 4:2:0 warped frames (half the "
                         "bytes; the frame program decodes them)")
    return ap.parse_args(argv)


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def launch_counts() -> dict:
    from deft_tpu_torch.ops import cuda_dcn

    return {name: getattr(cuda_dcn, attr)
            for name, attr in LAUNCH_COUNTERS.items()}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device) -> float:
    """ms of ``fn()`` between two CUDA events recorded around it (on the
    CPU the wall time): the wire probe's copies."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1000.0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def wire_payloads(runner, seq):
    """What the runner uploads for one chunk of ``seq``, one uint8 array per
    frame (``bench.py:187-193``), and the first frame's meta."""
    from deft_tpu_torch.inference.runner import pack_yuv420

    warps, meta = [], None
    for i in range(runner.chunk):
        frame, m = runner.warp(seq[i % len(seq)])
        warps.append(np.array(frame))
        meta = meta or m
    if runner._yuv_mode:
        warps = [pack_yuv420(w) for w in warps]
    if runner._delta_mode:
        warps = [warps[0]] + [warps[i] - warps[i - 1]
                              for i in range(1, len(warps))]
    return warps, meta


def probe_upload(host_arr: np.ndarray, device, reps: int):
    """(ms, MB/s) of one copy of ``host_arr`` to the device from pinned
    memory, the median of ``reps``."""
    on_card = device.type == "cuda"
    host = torch.empty(host_arr.shape, dtype=torch.uint8, pin_memory=on_card)
    host.numpy()[...] = host_arr
    dev = torch.empty_like(host, device=device)
    ts = [timed_ms(lambda: dev.copy_(host, non_blocking=True), device)
          for _ in range(reps + 1)][1:]
    t = _median(ts)
    return t, host_arr.nbytes / 1e6 / (t / 1000.0)


def probe_rtt(device, reps: int) -> float:
    """Median ms of a tiny copy up, an add and the copy back."""
    tiny = torch.zeros(8)
    ts = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        d = tiny.to(device)
        d += 1
        d.cpu()
        ts.append((time.perf_counter() - t0) * 1000.0)
    return _median(ts[1:])


def count_flops(runner, images, meta) -> float:
    """FLOPs of one frame program on ``images``: ``FlopCounterMode``'s
    count with each DCNv2 layer's work, whatever it is computed by, replaced
    by its product 2*H*W*9*Cin*Cout per sample (T4 computes it inside its
    kernel, where the counter cannot see it; a plain version's sampling
    products would count as work).  Its offset conv stays counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from deft_tpu_torch.models.dcn import DCNv2

    counter = FlopCounterMode(display=False)
    marks, fix = [], [0.0]

    def pre(mod, inp):
        marks.append(counter.get_total_flops())

    def post_offset(mod, inp, out):
        marks.append(counter.get_total_flops() - marks.pop())

    def post_dcn(mod, inp, out):
        offset = marks.pop()
        seen = counter.get_total_flops() - marks.pop() - offset
        b, cin, h, w = inp[0].shape
        fix[0] += 2.0 * b * h * w * 9 * cin * mod.weight.shape[0] - seen

    handles = []
    for mod in runner.det.model.modules():
        if isinstance(mod, DCNv2):
            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post_dcn),
                        mod.conv_offset_mask.register_forward_pre_hook(pre),
                        mod.conv_offset_mask.register_forward_hook(
                            post_offset)]
    try:
        with counter:
            runner.run_program(images, meta)
    finally:
        for h in handles:
            h.remove()
    return float(counter.get_total_flops()) + fix[0]


def build(args):
    """(runner, config, device, frame size, frames, warm-up frames)."""
    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.inference.runner import PipelinedRunner

    if args.smoke:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card and "
                           "torch.cuda.is_available() is False; --smoke runs "
                           "it on the CPU")
    else:
        device = torch.device("cuda")
    dtype = "float32" if args.fp32 else "bfloat16"
    flags = dict(track_thresh=1e-3, compute_dtype=dtype, sims_quant=True,
                 delta_upload=args.delta, chunk_batched=args.chunk_batched,
                 yuv_upload=args.yuv, device_warp=args.device_warp,
                 dcn_layer_radii=args.dcn_layer_radii)
    if args.smoke:
        cfg = mot_config(input_h=128, input_w=160, dla_node="conv", **flags)
        frames, warmup, size = 12, 4, (270, 480)
    else:
        cfg = mot_config(**flags)
        frames, warmup, size = args.frames, args.warmup, (1080, 1920)
    det = Detector(cfg, device=device)
    runner = PipelinedRunner(det, depth=1 if args.no_pipeline else args.depth,
                             chunk=args.chunk)
    if args.max_dets > 0:
        runner.cap = args.max_dets
    return runner, cfg, device, size, frames, warmup


def main(argv=None) -> dict:
    args = parse_args(argv)
    t_phase = time.perf_counter()
    seconds = {}

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = round(now - t_phase, 2)
        t_phase = now

    runner, cfg, device, (fh, fw), frames, warmup = build(args)
    dtype = cfg.compute_dtype
    lap("build")
    runner.track_sequence([make_synthetic_frame(t, fh, fw)
                           for t in range(warmup)])
    runner.reset()
    lap("warmup")

    # the staging modes on real frames; the runner keeps the fastest
    tune_scores = {}
    if runner.chunk > 1 and not args.smoke:
        tune_frames = [make_synthetic_frame(t, fh, fw)
                       for t in range(3 * runner.chunk)]
        tune_scores = runner.auto_tune(tune_frames, verbose=True)
        _log(f"# auto_tune picked stacked={runner.stacked} "
             f"force_resident={runner.force_resident} "
             f"upload_parallel={runner.upload_parallel}")
    lap("auto_tune")

    seq = [make_synthetic_frame(t, fh, fw) for t in range(frames)]
    n_rep = 1 if args.smoke else 3
    prof = contextlib.nullcontext()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    fps_runs, run_timings = [], []
    n_tracks = 0.0
    from deft_tpu_torch import native

    runner.spans.keep = bool(args.profile)
    launches0, lapjv0 = launch_counts(), native.LAPJV_CALLS
    with prof:
        for _ in range(n_rep):
            runner.reset()
            _sync(device)
            t0 = time.perf_counter()
            results = runner.track_sequence(seq)
            _sync(device)
            fps_runs.append(frames / (time.perf_counter() - t0))
            run_timings.append(runner.timings())
            n_tracks = sum(len(r) for r in results) / max(len(results), 1)
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    lapjv_calls = native.LAPJV_CALLS - lapjv0
    lap("timed")
    busy = None
    if args.profile:
        from deft_tpu_torch.tools.trace_device_ms import (device_busy,
                                                          load_trace)

        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        trace = load_trace(args.profile)
        busy = device_busy(trace, n_rep * frames)
        kept = runner.spans.export(args.profile, trace)
        runner.spans.keep = False
        _log(f"# spans.jsonl: {kept['spans']} spans, trace clock offset "
             f"{kept['offset_us']} us; device busy: {json.dumps(busy)}")
        lap("trace_export")
    med = sorted(range(n_rep), key=lambda i: fps_runs[i])[n_rep // 2]
    fps = fps_runs[med]
    buckets = run_timings[med]
    elapsed = frames / fps

    # ---- the wire probe ----
    runner.reset()
    n_dev = 3 if args.smoke else 6
    wire_rtt = probe_rtt(device, n_dev)
    warps, meta = wire_payloads(runner, seq)
    frame_ms, frame_mbps = probe_upload(warps[0], device, n_dev)
    chunk_ms = chunk_mbps = None
    if runner.chunk > 1:
        chunk_ms, chunk_mbps = probe_upload(np.stack(warps), device, 3)
    lap("wire_probe")

    single = torch.from_numpy(warps[0][None]).to(device)
    flops = count_flops(runner, single, meta)
    lap("flops")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    peak = PEAKS.get(name, {}).get(dtype)
    if peak is None:
        _log(f"# no mfu: no {dtype} peak for device {name or 'cpu'!r} in "
             f"bench.PEAKS")
    runner.reset()

    e2e_ms = elapsed / frames * 1000.0
    main_keys = runner.main_keys()
    attributed = sum(buckets.get(k, 0.0) for k in main_keys)
    unattributed = e2e_ms - attributed
    out = {
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": "fps",
        "wire_rtt_ms": round(wire_rtt, 3),
        "wire_frame_up_ms": round(frame_ms, 3),
        "wire_frame_up_mbps": round(frame_mbps, 1),
        "e2e_ms_per_frame": round(e2e_ms, 2),
        "unattributed_ms_per_frame": round(unattributed, 2),
    }
    if chunk_mbps is not None:
        out["wire_chunk_up_ms"] = round(chunk_ms, 3)
        out["wire_chunk_up_mbps"] = round(chunk_mbps, 1)
    if busy is not None:
        busy_ms = busy["device_busy_ms_total"] / (n_rep * frames)
        out["device_busy_ms_per_frame"] = round(busy_ms, 3)
        if peak is not None and busy_ms > 0:
            out["mfu"] = round(flops / (busy_ms / 1000.0) / peak, 4)
    for k in main_keys:
        if buckets.get(k):
            out[f"t_{k}_ms"] = round(buckets[k], 2)
    for k in WORKER_KEYS:
        if k not in main_keys and buckets.get(k):
            out[f"t_{k}_ms"] = round(buckets[k], 2)
    if "dispatch" in buckets:
        out["t_dispatch_wait_ms"] = round(
            buckets["dispatch"] - buckets["dispatch.cpu"], 2)
    for k, v in buckets.items():
        if k.startswith("n."):
            out[f"n_{k[2:]}"] = round(v, 2)
    print(json.dumps(out), flush=True)

    _log(f"# frames={frames} elapsed={elapsed:.2f}s "
         f"tracks/frame={n_tracks:.1f} dtype={dtype} device={device.type} "
         f"{name} pipeline_depth={runner.depth} chunk={runner.chunk} "
         f"sim_window={runner.sim_window} stacked={runner.stacked} "
         f"force_resident={runner.force_resident} "
         f"upload_parallel={runner.upload_parallel} cap={runner.cap} "
         f"flops_per_frame={flops:.4g} "
         f"runs_fps={[round(f, 2) for f in fps_runs]}")
    _log(f"# launches over the timed passes ({n_rep * frames} frames): "
         + json.dumps(launches))
    _log(f"# native lapjv calls over the timed passes: {lapjv_calls} "
         f"(DEFT_USE_NATIVE={os.environ.get('DEFT_USE_NATIVE', '0')})")
    _log("# seconds: " + json.dumps(seconds))
    if tune_scores:
        _log("# auto_tune fps: " + ", ".join(
            f"{k}={v:.2f}" for k, v in tune_scores.items()))
    bstr = " + ".join(f"{k} {buckets[k]:.2f}" for k in main_keys
                      if buckets.get(k))
    ostr = ", ".join(f"{k} {buckets[k]:.2f}" for k in WORKER_KEYS
                     if k not in main_keys and buckets.get(k))
    _log(f"# e2e attribution (median run, main-thread wall): {bstr} "
         f"= {attributed:.2f} of {e2e_ms:.2f} ms/frame (unattributed "
         f"{unattributed:.2f}); cascade worker: {ostr} ms/frame; wire "
         f"probe: rtt {wire_rtt:.3f} ms, frame {frame_mbps:.1f} MB/s"
         + (f", chunk {chunk_mbps:.1f} MB/s" if chunk_mbps else ""))
    return out


if __name__ == "__main__":
    main()
