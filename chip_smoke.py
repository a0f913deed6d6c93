#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deft_tpu_torch/csrc`` into
``build/kernels/``, holds every kernel against its plain PyTorch version at
the shapes the main path gives it (and times kernel, plain version and a
library yardstick), then drives the main path -- MOT17 tracking through
``Detector.run`` at full width (DLA-34 with DCNv2 neck, 544x960 input, K=100,
max_object=100, 50-slot ring) on 30 synthetic 1080x1920 frames with seeded
random weights -- and shows that every DCNv2 layer of every frame went through
the kernel.  It imports nothing of JAX.

Output: one JSON line per measurement, then the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failure exits non-zero before
that last line; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

import deft_tpu_torch
from deft_tpu_torch.config import mot_config
from deft_tpu_torch.csrc.build import build_all
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.models.dcn import DCNv2
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.ops import cuda_dcn

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
RADIUS = 4                     # mot_config's dcn_offset_range
FRAMES = 30
# DLA-34 DCNv2 layers at 544x960 input: (H, W, Cin, Cout, layers per frame),
# checked against the model in the slice phase
LAYERS = [
    (136, 240, 64, 64, 5),
    (68, 120, 128, 64, 4),
    (68, 120, 128, 128, 2),
    (34, 60, 256, 128, 2),
    (34, 60, 256, 256, 1),
    (34, 60, 256, 64, 1),
    (17, 30, 512, 256, 1),
]
KERNEL_SOURCE = "deft_tpu_torch/csrc/dcn_sample.cu"
KERNEL_REPLACES = "deft_tpu/ops/pallas_dcn.py:585"   # _cm_kernel


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, warmup: int = 3, reps: int = 21) -> float:
    """Median milliseconds of one ``fn()`` call, host launch overhead
    included: each call timed with its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_times(fn, per_graph: int = 20, reps: int = 7) -> float:
    """Median device milliseconds of one ``fn()`` call with no host launch
    overhead: ``per_graph`` calls captured back to back in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    del graph
    return statistics.median(times)


# ---- the kernel against its plain version ----------------------------------

def make_offsets(rng, h, w, regime: str) -> np.ndarray:
    """'trained': N(0, 0.5) noise on a smooth ramp, clipped to +-2 px (the
    regime tools/bench_dcn.py measures for trained checkpoints);
    'uniform6': U(-6, 6), which reaches past the +-4 clamp everywhere."""
    if regime == "trained":
        yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None, None, None]
        xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :, None, None]
        ramp = np.concatenate([yy + 0 * xx, xx + 0 * yy], axis=-1)
        noise = rng.normal(0.0, 0.5, (h, w, 9, 2)).astype(np.float32)
        return np.clip(noise + 0.7 * ramp, -2.0, 2.0)
    return rng.uniform(-6.0, 6.0, (h, w, 9, 2)).astype(np.float32)


def bound_times(h, w, c, elem_bytes):
    """Least time for deformable im2col, as (bytes_ms, operations_ms): the
    inputs read once and the patches written once over the memory rate; 8
    flops per patch element plus ~40 per (pixel, tap) over the float32
    rate.  The bound is the larger of the two."""
    nbytes = (h * w * c * elem_bytes + h * w * 9 * 2 * 4 + h * w * 9 * 4
              + h * w * 9 * c * elem_bytes)
    flops = h * w * 9 * (8 * c + 40)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3


def grid_sample_yardstick(x, offsets, mask, radius):
    """The same function through one library call: ``grid_sample`` of the
    9-tap grid (zeros padding, corner-aligned), times the mask.  Returns the
    timed closure; the grid is built once outside it."""
    h, w, c = x.shape
    dev = x.device
    off = offsets.clamp(-radius, radius)
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    yy = (torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
          + ky.reshape(1, 1, 9) + off[..., 0])
    xx = (torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
          + kx.reshape(1, 1, 9) + off[..., 1])
    grid = torch.stack([2.0 * xx / (w - 1) - 1.0, 2.0 * yy / (h - 1) - 1.0],
                       dim=-1).permute(2, 0, 1, 3).reshape(1, 9, h * w, 2)
    x_nchw = x.permute(2, 0, 1)[None].contiguous().float()
    m = mask.permute(2, 0, 1).reshape(1, 1, 9, h * w)

    def run():
        s = torch.nn.functional.grid_sample(
            x_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)                              # [1, C, 9, HW]
        return s * m

    return run


def kernel_phase():
    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    rows = []
    worst = 0.0
    cases = [(shape, "trained", torch.float32) for shape in LAYERS]
    cases += [(shape, "uniform6", torch.float32) for shape in LAYERS]
    cases += [(LAYERS[0], "trained", torch.bfloat16)]
    for (h, w, c, cout, count), regime, dtype in cases:
        x = torch.from_numpy(rng.normal(0, 1, (h, w, c)).astype(np.float32)
                             ).to(dev, dtype)
        offsets = torch.from_numpy(make_offsets(rng, h, w, regime)).to(dev)
        mask = torch.from_numpy(rng.uniform(0, 1, (h, w, 9)).astype(
            np.float32)).to(dev)
        got = cuda_dcn.deform_sample(x, offsets, mask, RADIUS)
        torch.cuda.synchronize()
        ref = cuda_dcn.deform_sample_reference(x, offsets, mask, RADIUS)
        err = (got.float() - ref.float()).abs().max().item()
        tol_rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        tol = tol_rel * x.abs().max().item()
        if not err <= tol:
            raise AssertionError(
                f"dcn_sample disagrees with its plain version at "
                f"{(h, w, c)} {regime} {dtype}: {err} > {tol}")
        worst = max(worst, err)
        k_ms = graph_times(lambda: cuda_dcn.deform_sample(x, offsets, mask,
                                                          RADIUS))
        k_call_ms = cuda_times(lambda: cuda_dcn.deform_sample(
            x, offsets, mask, RADIUS))
        p_ms = graph_times(lambda: cuda_dcn.deform_sample_reference(
            x, offsets, mask, RADIUS), per_graph=5)
        lib_ms = graph_times(grid_sample_yardstick(x, offsets, mask, RADIUS))
        t_bytes, t_ops = bound_times(h, w, c, x.element_size())
        row = {"phase": "kernel", "kernel": "dcn_sample", "H": h, "W": w,
               "C": c, "Cout": cout, "count": count, "regime": regime,
               "dtype": str(dtype).replace("torch.", ""), "radius": RADIUS,
               "kernel_ms": k_ms, "kernel_call_ms": k_call_ms,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
               "max_abs_err": err,
               "tolerance": tol}
        emit(row)
        rows.append(row)
    return rows, worst


# ---- the main path ----------------------------------------------------------

def synthetic_frames(n: int, h: int = 1080, w: int = 1920):
    """Moving coloured rectangles on a noisy background, uint8 BGR."""
    rng = np.random.RandomState(SEED + 1)
    n_obj = 40
    size = (rng.uniform([0.07, 0.02], [0.28, 0.08], (n_obj, 2))
            * [h, w]).astype(int) + 1
    pos = rng.uniform(0, 1, (n_obj, 2)) * ([h, w] - size)
    vel = rng.uniform(-0.006, 0.006, (n_obj, 2)) * [h, w]
    colours = rng.randint(0, 256, (n_obj, 3))
    base = rng.randint(0, 48, (h, w, 3)).astype(np.uint8)
    for f in range(n):
        img = base.copy()
        for (y, x), (vy, vx), (bh, bw), col in zip(pos, vel, size, colours):
            y0 = int(np.clip(y + vy * f, 0, h - bh))
            x0 = int(np.clip(x + vx * f, 0, w - bw))
            img[y0: y0 + bh, x0: x0 + bw] = col
        yield img


@torch.no_grad()
def randomize_offsets(model, image, gen):
    """Seeded random offset/mask convs, scaled per layer on this image so
    that each conv part has a std of 1 px, plus a U(-1, 1) bias: offsets
    spread over about +-2 px, as a trained DCN's do.  Returns the offsets'
    1st/50th/99th percentiles of |offset| and the layer shapes seen."""
    shapes = Counter()
    stats = []

    def pre_hook(mod, args):
        x = args[0]
        conv = mod.conv_offset_mask
        w = torch.randn(conv.weight.shape, generator=gen).to(x.device)
        conv.weight.copy_(w)
        conv.bias.zero_()
        raw = conv(x)[:, :18]
        conv.weight.mul_(1.0 / raw.std().clamp(min=1e-6))
        conv.bias.copy_((torch.rand(conv.bias.shape, generator=gen) * 2 - 1
                         ).to(x.device))
        off = conv(x)[:, :18].abs().flatten()
        stats.append(off)
        shapes[(x.shape[2], x.shape[3], x.shape[1],
                mod.weight.shape[0])] += 1

    hooks = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
             if isinstance(m, DCNv2)]
    try:
        model(image)
    finally:
        for hk in hooks:
            hk.remove()
    allo = torch.cat(stats)
    sample = allo[torch.randint(0, allo.numel(), (1_000_000,),
                                generator=gen).to(allo.device)]
    q = torch.quantile(sample, torch.tensor([0.01, 0.5, 0.99],
                                            device=allo.device))
    return [float(v) for v in q], shapes


@torch.no_grad()
def raise_heatmap(model, image, top_fraction=0.01):
    """Random weights give a flat heatmap far below track_thresh: rescale
    the heatmap head so ~1% of this image's pixels score above 0.5."""
    outputs, _ = model(image)
    z = outputs["hm"].flatten()
    gain = 2.0 / z.std().item()
    thr = torch.quantile(z, 1.0 - top_fraction).item()
    out = model.hm[-1]
    out.weight.mul_(gain)
    out.bias.copy_((out.bias - thr) * gain)


@torch.no_grad()
def reference_check(det, cfg):
    """The card's forward vs the same weights on the CPU at a small input:
    every head map and feature map within 1e-3 * its max (cuDNN and the CPU
    sum convolutions in other orders; TF32 is off)."""
    cpu = create_model(cfg.arch, cfg, "cpu")
    cpu.load_state_dict(det.model.state_dict())
    rng = np.random.RandomState(SEED + 2)
    x = torch.from_numpy(rng.normal(0, 1, (1, 128, 256, 3)).astype(np.float32))
    g_out, g_maps = det.model(x.to(det.device))
    c_out, c_maps = cpu(x)
    worst = 0.0
    for name, g, c in ([(f"head {h}", g_out[h], c_out[h]) for h in c_out]
                       + [(f"map {i}", g, c) for i, (g, c)
                          in enumerate(zip(g_maps, c_maps))]):
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad shape or non-finite values")
        rel = ((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-12)).item()
        worst = max(worst, rel)
        if rel > 1e-3:
            raise AssertionError(f"{name}: card vs CPU relative error {rel}")
    return worst


def slice_phase(cfg, device="cuda", frame_hw=(1080, 1920), layers=LAYERS,
                min_dets=20):
    """Drive ``Detector.run`` over FRAMES synthetic frames and check that
    every DCNv2 layer of every frame launched the kernel.  The arguments
    other than ``cfg`` exist for a rehearsal at a tiny size on the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    det = Detector(cfg, device=device)
    model = det.model
    n_dcn = sum(isinstance(m, DCNv2) for m in model.modules())
    frames = list(synthetic_frames(FRAMES, *frame_hw))
    sync = torch.cuda.synchronize if det.device.type == "cuda" else lambda: None

    first, _ = det.pre_process(frames[0])
    offset_q, shapes = randomize_offsets(model, first, gen)
    expected = Counter({l[:4]: l[4] for l in layers})
    if shapes != expected or n_dcn != sum(expected.values()):
        raise AssertionError(f"DCN layer shapes {dict(shapes)} != {dict(expected)}")
    raise_heatmap(model, first)
    ref_rel = reference_check(det, cfg)
    det.reset_tracking()

    sync()
    if det.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_dcn.LAUNCHES = 0
    times, n_dets, n_tracks = [], [], []
    for frame in frames:
        t0 = time.perf_counter()
        online = det.run(frame)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        n_dets.append(len(online))
        n_tracks.append(len(det.tracker.tracked_stracks))
        for t in online:
            if not np.isfinite(t.tlbr).all():
                raise AssertionError("non-finite track box")
    launches = cuda_dcn.LAUNCHES
    peak = (torch.cuda.max_memory_allocated() if det.device.type == "cuda"
            else None)
    expected_launches = n_dcn * FRAMES if det.device.type == "cuda" else 0
    if launches != expected_launches:
        raise AssertionError(
            f"{launches} dcn_sample launches, expected {expected_launches}")
    if not torch.isfinite(det.tracker.recorder.embeds).all():
        raise AssertionError("non-finite embeddings in the ring")
    if min(n_dets) < min_dets:
        raise AssertionError(f"too few detections per frame: {n_dets}")

    # where a steady frame's time goes, each stage ended by a synchronize
    stages = {"pre_process": [], "detect": [], "post_process": [],
              "track": []}
    for frame in frames[:5]:
        t = [time.perf_counter()]
        images, meta = det.pre_process(frame)
        sync()
        t.append(time.perf_counter())
        dets, emb = det.process(images)
        sync()
        t.append(time.perf_counter())
        results = det.post_process(dets, meta)
        t.append(time.perf_counter())
        det.tracker.update(results, emb[0][: len(results)])
        sync()
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t[:-1], t[1:]):
            stages[name].append((b - a) * 1e3)

    row = {"phase": "slice", "device": str(det.device),
           "config": f"mot_config dla_34 {cfg.dla_node} "
                     f"{cfg.input_h}x{cfg.input_w} K={cfg.K} "
                     f"max_object={cfg.max_object}",
           "frames": FRAMES, "frame_size": list(frame_hw),
           "ms_per_frame_median": statistics.median(times[1:]),
           "ms_first_frame": times[0],
           "dets_per_frame_median": statistics.median(n_dets),
           "tracks_per_frame_median": statistics.median(n_tracks),
           "dcn_layers": n_dcn, "dcn_launches": launches,
           "peak_memory_bytes": peak, "offset_abs_q01_q50_q99": offset_q,
           "card_vs_cpu_max_rel_err": ref_rel,
           "stage_ms_median": {k: statistics.median(v)
                               for k, v in stages.items()}}
    emit(row)
    return launches, det, frames, row["ms_per_frame_median"]


@torch.no_grad()
def profile_phase(det, frames, ms_per_frame):
    """Where a frame's device time goes: CUDA-event times of the network
    forward, ``detect`` and the 50-slot window similarity, then
    ``torch.profiler`` over 3 more frames of ``Detector.run`` for the kernel
    time per frame by name.  The busy share divides that kernel time by the
    slice phase's (unprofiled) median ms/frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    images, _ = det.pre_process(frames[0])
    rec = det.tracker.recorder
    counts = torch.as_tensor(rec.counts, device=det.device)
    cur = rec.embeds[0].clone()
    row = {"phase": "profile",
           "forward_ms": cuda_times(lambda: det.model(images)),
           "detect_ms": cuda_times(lambda: det.model.detect(images, k=det.cfg.K)),
           "window_similarity_ms": cuda_times(
               lambda: det.model.window_similarity(rec.embeds, counts, cur,
                                                   det.cfg.max_object)),
           "ring_slots_filled": int((rec.counts > 0).sum())}
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for frame in frames[1: 1 + n]:
            det.run(frame)
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        kernels.append((t / 1e3 / n, evt.count / n, evt.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    row.update({"profiled_frames": n, "device_ms_per_frame": device_ms,
                "busy_share": device_ms / ms_per_frame,
                "top_kernels_ms_per_frame": [
                    [round(t, 4), c, name[:90]] for t, c, name in kernels[:12]]})
    emit(row)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off (deft_tpu_torch sets it)")
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "port": deft_tpu_torch.__version__})

    t0 = time.perf_counter()
    secs = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": secs})

    rows, worst = kernel_phase()
    launches, det, frames, ms_per_frame = slice_phase(mot_config())
    profile_phase(det, frames, ms_per_frame)

    per_frame = [r for r in rows if r["regime"] == "trained"
                 and r["dtype"] == "float32"]
    total = {key: sum(r[key] * r["count"] for r in per_frame)
             for key in ("kernel_ms", "plain_ms", "library_ms",
                         "bound_bytes_ms", "bound_operations_ms")}
    bound_by = ("bytes" if total["bound_bytes_ms"]
                >= total["bound_operations_ms"] else "operations")
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "dcn_sample", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": total["kernel_ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": max(total["bound_bytes_ms"], total["bound_operations_ms"]),
        "bound_by": bound_by, "library_ms": total["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
