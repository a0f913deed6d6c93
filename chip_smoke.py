#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deft_tpu_torch/csrc`` into
``build/kernels/`` (one nvcc per source, all at once), holds each of the four
kernels against its plain PyTorch version at the 7 DLA-34 DCNv2 layer shapes
of a 544x960 frame, in two offset regimes and on a bf16 x, the kernels of
the other paths also at the 7 shapes of a 448x800 nuScenes camera and of a
384x1280 KITTI frame (``PHASE_KERNELS``), and times kernel, plain version
and a library yardstick beside a bound.  Then it
drives the main paths at full width (DLA-34 with DCNv2 neck, K=100,
max_object=100, 50-slot rings) with seeded random weights:

* slice 1, MOT17 tracking through ``Detector.run`` (544x960,
  ``dcn_impl="hybrid"``, every DCNv2 layer through ``dcn_sample``) on
  ``FRAMES`` (14) synthetic 1080x1920 frames;
* slice 2, the ``PipelinedRunner`` of ``test.py`` (chunk 1, depth 3) and of
  ``bench.py`` (chunk 4, ``frame_chunk_batched``) with
  ``dcn_impl="pallas"`` (every DCNv2 layer through ``dcn_sample_tap``,
  similarity against the 12 freshest ring slots) on the same frames;
* slice 4, nuScenes monocular 3-D tracking through ``track.py::
  track_nuscenes`` -> ``Detector.run_multi`` (``nuscenes_config()``: 448x800,
  3-D heads, 704-wide AFE, seven per-class trackers with the LSTM motion
  model) on ``NUSCENES_SAMPLES`` (4) samples of a synthetic six-camera rig
  of 900x1600 frames,
  each sample's cameras as one batch;
* slice 6, KITTI 2-D vehicle tracking (``kitti_config()``: 384x1280, three
  classes, cars tracked) on 14 synthetic 375x1242 frames of the numpy
  generator ``deft_tpu_torch/data/synthetic_kitti.py``, through
  ``track.py::track_videos_detector`` -> ``Detector.run`` (``dcn_impl=
  "hybrid"``) and through the ``PipelinedRunner`` at chunk 1 and chunk 4
  (``dcn_impl="pallas"``), each path's tracks written as KITTI txt;
* slice 7, MOT17 public detections (``mot_config(public_det=True)``): the
  slice 1 frames with MOT17-like public boxes made from their rectangles,
  through ``track_videos_detector`` -> ``Detector.run`` (hybrid) and
  ``track_videos`` -> the runner at chunk 1 (pallas), where no head tower
  and no decode may run and the track boxes must lie over public boxes
  (IoU >= 0.5 for 95% of them; PERF.md, PR 7), plus one full-width ``embed_parity`` frame (``detect``'s
  embeddings equal ``embed_image`` at the parity centres);
* slice 8, each recipe's ``test.py`` line of ``experiments/*.sh`` through
  ``python -m deft_tpu_torch.test``'s ``main`` (``cli_phase``) on PNG
  datasets of the three models, at ``--compute_dtype bfloat16`` (the
  hybrid's ``dcn_sample`` on one sample's layers of at most 128 input
  channels, ``dcn_sample_onehot`` on the others and on nuScenes' batch of
  cameras, as the JAX hybrid picks on a TPU)
  and float32, and the MOT line at bf16 with ``--dcn_impl pallas``;
* slice 9, the MOT recipe's ``train.py`` line through ``python -m
  deft_tpu_torch.train``'s ``main`` (``train_phase``: batch 4 at 544x960,
  an epoch of the slice 8 PNG frames, bf16 under the profiler and
  float32; slice 10 runs the recipe's other lines on the ``model_last.pth``
  written), every DCNv2 layer of every
  sample forward through ``dcn_sample_onehot`` (bf16) or ``dcn_sample``
  (float32) and backward through ``dcn_backward`` (T5's tiled route, also
  held against its plain version at the 7 MOT shapes in the kernel phase,
  with its unclamped route ``dcn_backward_entry`` once at radius -1; the
  train lines launch no unclamped one);
* slice 10, every line of the three recipes in the order of
  ``experiments/*.sh``, each on what the line before it wrote
  (``recipes_phase``, in ``build/train/``): the KITTI and nuScenes
  ``train.py`` lines at bf16 (batch 4 at 384x1280 on 30 PNG frames, and
  at 448x800 on 20 samples x 6 cameras; T4 forward and T5 backward, T5
  also held at their 14 layer shapes in the kernel phase), each recipe's
  ``train_prediction.py`` line through ``python -m
  deft_tpu_torch.train_prediction`` (the LSTM motion model on the card),
  and each ``test.py`` line on the ``model_last`` files written, the
  nuScenes one stepping the trained motion model;
* slice 12, data-parallel training (``ddp_phase``, after the train
  phase): the MOT train line at bf16 for 3 steps with the in-process
  loader, once through the one-process ``main`` and once as rank 0 of an
  NCCL group of world size 1 (``train.run.train_rank``), the first step's
  losses held together, rank 0's ``model_last.pth`` checked; and
  test-time geometry (``geometry_phase``, last): 4 MOT frames through
  ``Detector.run`` under ``flip_test`` at float32 (T1 on both samples of
  every layer) and bf16 (T4), through the runner under ``flip_test`` at
  chunk 4 (T2) and under ``--fix_short 544`` (544x1024), and 4 KITTI
  frames under ``keep_res`` (384x1248) through ``Detector.run`` and the
  runner at chunk 1 (host warp), and 3 nuScenes samples under
  ``flip_test`` through ``run_multi`` (the trunk at 12 camera images); T1,
  T2 and T4 also held at the keep_res KITTI and fix_short MOT layer shapes
  in the kernel phase;
* slice 13, the other model families (``archs_phase``, last): DLA-169
  (``--arch dla_169``) tracking 4 MOT frames through ``Detector.run`` at
  float32 (16 T1 per frame) and bf16 (T1 on its five 128-channel layers,
  T4 on the other 11) and through the runner at chunk 1 (16 T2), the MOT
  recipe's train line at ``--arch dla_169`` (bf16, batch 4, 3 steps,
  in-process loader: 128 T4 and 128 T5 per step), DLA-34 with ``--dla_node
  gcn`` (no DCN), and each detection family (``DETECTION_FAMILIES``:
  ResNet-18/101, ResDCN-18/101, DLAv0-34, MobileNetV2 + MSRAUp, ResNet-18 +
  the generic DLAUp) through ``create_model`` -> forward -> ``detect`` on
  one frame at float32 and bf16, every DCN layer (T1 on the necks'
  unclamped gather DCNs) held against its plain version on the model's own
  activations and the heads against the plain-DCN network; T1, T2, T4 and
  T5 also held at the DLA-169 layer shapes and T1 at ResDCN's (radius -1)
  in the kernel phase;
* slice 14, the bench entry point (``bench_phase``, last): ``python -m
  deft_tpu_torch.bench`` in processes of its own with ``DEFT_USE_NATIVE=1``
  (the cascade's assignment through the C++ lapjv of
  ``deft_tpu_torch/native``), MOT17 through the runner at chunk 4, depth
  2 on the bench's synthetic 1080x1920 frames: 60 frames at bf16 (11 T1
  and 5 T4 per dispatched frame), 16 at float32 (16 T1), 8 under
  ``--yuv`` (profiled) and under ``--delta``, each JSON line printed;
  on the card ``_decode_input`` against the CPU and the delta runner's
  tracks against a host-warp run's, bit for bit; then the tools:
  ``bench_loader`` (batch 4, in-process and 4 workers, on the cli phase's
  MOT layout), ``measure_dcn_offsets`` on the checkpoint below, and
  ``trace_device_ms`` on the profiled run;
* slice 15, the visualizer and the COCO-format datasets (after the bench
  phase): the MOT recipe's test line with ``--debug 2 --save_video``
  (``visual_phase``: 4 1080x1920 PNG frames at float32 and bf16, frame by
  frame through ``Detector.run``; 32 T1 per frame at float32, 22 T1 + 10
  T4 at bf16, detect and the ``pred_hm`` forward, whose peaks must be
  detect's; the three boards of every frame and the video's frames), the
  COCO lines (``coco_phase``: ``--dataset coco`` at 512x512 with 80
  classes, 3 bf16 train steps with T4 and T5, the test line with
  ``tools/eval_coco.py``'s 12 stats, and one ``--dataset custom`` frame;
  the kernel phase holds T1, T4 and T5 at its layer shapes,
  ``COCO_LAYERS``, checked against the model there),
  and ``python -m deft_tpu_torch.tools.bench_dcn --iters 20 --regimes
  trained`` (``bench_dcn_phase``), its T1, T2 and T4 per layer within 25%
  of the kernel phase's;

and shows from the launch counters, set to 0 just before each path and read
just after, that every DCNv2 layer of every frame went through its kernel
(and, on nuScenes, that the LSTM stepped tracks).
After slice 1 the seeded MOT weights go through a reference checkpoint
file (``{"epoch", "state_dict"}`` under ``module.`` keys, in ``build/``) and
``cfg.load_model``: every key loads, and one frame's detections equal those
of the weights in memory bit for bit.
The kernel phase also checks that ``dcn_sample_tap`` on x equals
``dcn_sample`` on x rounded to bf16 bit for bit, that ``dcn_fused`` (split-K,
no atomics) gives the same bits on two calls, times ``dcn_sample_tap``
plus the GEMM that reads its patches, and gives each ``dcn_sample_onehot``
row the tile, slice and window of its plan (``cuda_dcn.plan_onehot``).
``dcn_fused`` replaces a TPU kernel that nothing in the JAX package calls,
so no path reaches it: its launches are the kernel phase's.  It imports
nothing of JAX.

Output: one JSON line per measurement, then the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failure exits non-zero before
that last line; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import deft_tpu_torch
from deft_tpu_torch import bench
from deft_tpu_torch import test as port_test
from deft_tpu_torch import train_prediction as port_train_prediction
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.config import kitti_config, mot_config, nuscenes_config
from deft_tpu_torch.csrc.build import BUILD_DIR, build_all
from deft_tpu_torch.data.datasets import NUSCENES_INFO, get_dataset
from deft_tpu_torch.data.image_io import imread
from deft_tpu_torch.data.synthetic_kitti import make_sequence
from deft_tpu_torch.data.synthetic_nuscenes import make_scene, make_tables
import deft_tpu_torch.models.deft as deft_model
from deft_tpu_torch.inference.detector import Detector, parity_tf
from deft_tpu_torch.inference.runner import PipelinedRunner, pack_yuv420
from deft_tpu_torch.models import dcn as dcn_module
from deft_tpu_torch.models.dcn import HYBRID_CM_CHANNELS, DCNv2
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.ops.decode import heat_nms, topk
from deft_tpu_torch.ops.warp import separable_inverse_tf, warp_affine_separable
from deft_tpu_torch.tools import bench_dcn
# the DLA-34 layer table at 544x960 (H, W, Cin, Cout, layers per frame,
# checked against the model in the slice phase) and the offset regimes are
# bench_dcn's, whose rows bench_dcn_phase holds against the kernel phase's
from deft_tpu_torch.tools.bench_dcn import (FP32_FLOPS_PER_S, LAYERS,
                                            HBM_BYTES_PER_S, bound_times,
                                            grid_sample_yardstick,
                                            yardstick_inputs)
from deft_tpu_torch.train import run as port_train
from deft_tpu_torch.track import (
    nuscenes_submission,
    save_kitti_results,
    track_nuscenes,
    tracks_to_results,
    track_videos,
    track_videos_detector,
)
from deft_tpu_torch.tracking import matching, motion_lstm
from deft_tpu_torch.tracking.basetrack import IdAllocator
from deft_tpu_torch.utils import visualize
from deft_tpu_torch.utils.visualize import VideoWriter

# the recipes' command lines, shared with the port's tests (a site package
# named ``tests`` would shadow the repository's directory as a package)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from recipe_lines import (RECIPES, recipe_lines, recipe_test_argv,  # noqa: E402
                          with_flags)
from torch_port_layouts import (layout_coco, layout_kitti,  # noqa: E402
                                layout_nuscenes_train, write_pngs)

SEED = 0
RADIUS = 4                     # mot_config's dcn_offset_range
# frames of the MOT and KITTI paths before the cli phase (30 until the
# bench phase came, 18 until slice 15's phases; 14 = 3 chunks of 4 and a
# padded one)
FRAMES = 14
# the same layers of one 448x800 nuScenes camera (6 per sample)
NUSCENES_LAYERS = [
    (112, 200, 64, 64, 5),
    (56, 100, 128, 64, 4),
    (56, 100, 128, 128, 2),
    (28, 50, 256, 128, 2),
    (28, 50, 256, 256, 1),
    (28, 50, 256, 64, 1),
    (14, 25, 512, 256, 1),
]
NUSCENES_SAMPLES = 4            # 10, then 6 until slice 15's phases
CAMERAS = 6
# the same layers of a 384x1280 KITTI frame
KITTI_LAYERS = [
    (96, 320, 64, 64, 5),
    (48, 160, 128, 64, 4),
    (48, 160, 128, 128, 2),
    (24, 80, 256, 128, 2),
    (24, 80, 256, 256, 1),
    (24, 80, 256, 64, 1),
    (12, 40, 512, 256, 1),
]
# DLA-169's DCNv2 layers at 544x960 input (DLA-60's and DLA-102's too: the
# plans share their channels), checked against the model in the archs phase
DLA169_LAYERS = [
    (136, 240, 128, 128, 5),
    (68, 120, 256, 128, 4),
    (68, 120, 256, 256, 2),
    (34, 60, 512, 256, 2),
    (34, 60, 512, 512, 1),
    (34, 60, 512, 128, 1),
    (17, 30, 1024, 512, 1),
]
# ResDCN-18's deconv neck at 544x960 (msra 64: [256, 128, 64]); ResDCN-101's
# first layer takes its 2048 channels, the other two are these
RESDCN18_LAYERS = [
    (17, 30, 512, 256, 1),
    (34, 60, 256, 128, 1),
    (68, 120, 128, 64, 1),
]
RESDCN101_FIRST = [(17, 30, 2048, 256, 1)]
# the DCNs of the generic necks (MSRAUp, generic DLAUp): impl="gather",
# unclamped, as the JAX package builds them
GATHER_RADIUS = -1
KITTI_SIZE = (375, 1242)       # KITTI image_02 frames
CAR = 2                        # KITTI's tracked class (1-based)
# kernel -> (source, TPU kernel it replaces, launch counter in cuda_dcn)
KERNELS = {
    "dcn_sample": ("deft_tpu_torch/csrc/dcn_sample.cu",
                   "deft_tpu/ops/pallas_dcn.py:585", "LAUNCHES"),   # T1
    "dcn_sample_tap": ("deft_tpu_torch/csrc/dcn_sample.cu",
                       "deft_tpu/ops/pallas_dcn.py:338", "LAUNCHES_TAP"),  # T2
    "dcn_fused": ("deft_tpu_torch/csrc/dcn_fused.cu",
                  "deft_tpu/ops/pallas_dcn.py:224", "LAUNCHES_FUSED"),  # T3
    "dcn_sample_onehot": ("deft_tpu_torch/csrc/dcn_onehot.cu",
                          "deft_tpu/ops/pallas_dcn.py:463",
                          "LAUNCHES_ONEHOT"),                             # T4
    # T5 replaces no Pallas kernel: the jax.vjp of deform_conv_onehot that
    # the JAX trainer takes (pallas_dcn.py:167, :733-747, :773-787).  Its
    # tiled route (dcn_backward_tiled) runs every clamped layer; the
    # unclamped route (dcn_backward) only dcn_impl="gather" or a radius
    # whose window does not fit, no recipe line
    "dcn_backward": ("deft_tpu_torch/csrc/dcn_backward.cu",
                     "deft_tpu/ops/pallas_dcn.py:167",
                     "LAUNCHES_BACKWARD"),                                # T5
    "dcn_backward_entry": ("deft_tpu_torch/csrc/dcn_backward.cu",
                           "deft_tpu/ops/pallas_dcn.py:167",
                           "LAUNCHES_BACKWARD_ENTRY"),                    # T5
}
CHUNK = 4                      # bench.py's runner
PUBLIC_IOU_SHARE = 0.95         # public track boxes at IoU >= 0.5 with a
                               # public box of their frame (see
                               # check_public_results)
BOX_TOL_CARD = 0.0             # px: runner chunk 1 vs chunk 4 frame_chunk
                               # (the same programs per frame)


def reset_launches():
    for _, _, counter in KERNELS.values():
        setattr(cuda_dcn, counter, 0)


def launches() -> dict:
    return {name: getattr(cuda_dcn, counter)
            for name, (_, _, counter) in KERNELS.items()}


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


@functools.lru_cache(maxsize=None)
def capture_stream() -> torch.cuda.Stream:
    """One side stream for every capture: PyTorch keeps a cuBLAS workspace
    for each stream that has run a GEMM, so a fresh pool stream per capture
    leaves workspaces behind that every later peak-memory reading counts."""
    return torch.cuda.Stream()


def graph_times(fn, per_graph: int = 20, reps: int = 7) -> float:
    """Median device milliseconds of one ``fn()`` call with no host launch
    overhead: ``per_graph`` calls captured back to back in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events."""
    side = capture_stream()
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


def device_profile(fn, n: int, host_ops: bool = True):
    """``torch.profiler`` over ``fn()``, which does ``n`` units of work:
    (device kernel ms per unit, the 12 costliest kernels per unit).
    ``host_ops=False`` records the device activity alone, which a long run
    of many small host operations needs (their events otherwise take
    longer to collect than the run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
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
    return (sum(k[0] for k in kernels),
            [[round(t, 4), c, name[:90]] for t, c, name in kernels[:12]])


# ---- the kernel against its plain version ----------------------------------

def make_offsets(rng, h, w, regime: str) -> np.ndarray:
    """'trained': ``bench_dcn.make_offsets``' regime of trained checkpoints
    (N(0, 0.5) noise on a smooth ramp, clipped to +-2 px); 'uniform6':
    U(-6, 6), which reaches past the +-4 clamp everywhere."""
    if regime == "uniform6":
        return rng.uniform(-6.0, 6.0, (h, w, 9, 2)).astype(np.float32)
    return bench_dcn.make_offsets(rng, h, w, 9, regime)


def grid_sample_backward_yardstick(x, offsets, mask, g, radius):
    """T5's work through the library: what autograd runs for the backward
    of ``grid_sample_yardstick``, i.e. ``grid_sampler_2d_backward`` of the
    gradient times the mask (dx and the grid's gradient) plus the mask's
    gradient, the sum over channels of the gradient times the sampled
    values (kept from the forward, as autograd keeps them).  Returns the
    timed closure; a yardstick of time only."""
    h, w, c = x.shape
    x_nchw, grid, m = yardstick_inputs(x, offsets, mask, radius)
    go = g.reshape(h * w, 9, c).permute(2, 1, 0)[None].contiguous().to(
        x_nchw.dtype)                                        # [1, C, 9, HW]
    sampled = torch.nn.functional.grid_sample(
        x_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True)

    def run():
        dx, dgrid = torch.ops.aten.grid_sampler_2d_backward(
            go * m, x_nchw, grid, 0, 0, True, [True, True])
        return dx, dgrid, (go * sampled).sum(1)

    return run


def backward_bound(h, w, c, x_bytes, g_bytes):
    """Least time of one T5 call, as (bytes_ms, operations_ms): g, x,
    offsets and mask read once, dx in float32, doffsets and dmask written
    once, over the memory rate; 32 float32 operations per sampled element
    (the blend, the two corner differences, the three channel sums and the
    four weighted corner updates) plus ~40 per (pixel, tap), at the float32
    rate outside the tensor cores."""
    nbytes = (h * w * 9 * c * g_bytes + h * w * c * x_bytes
              + 2 * (h * w * 9 * 2 * 4 + h * w * 9 * 4) + h * w * c * 4)
    ops = h * w * 9 * (32 * c + 40)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3


def backward_row(x, offsets, mask, rng, shape, regime, model="mot",
                 radius=RADIUS):
    """T5 against its plain version on one layer's inputs and a N(0, 1)
    patch gradient in x's dtype (bf16 x: T4's bf16 patches), with its
    times, bound and library yardstick.  The route is asserted from the
    two counters: the tiled one (``dcn_backward``) for radius >= 0, the
    unclamped one (``dcn_backward_entry``) for radius < 0; the row carries
    the tiled route's plan.  Tolerances: doffsets and dmask, float32 sums
    over C in another order, 1e-5 x max|plain|; dx, summed with float32
    atomics in an order that changes from call to call, 1e-5 x max|plain|
    in float32 and one bf16 step (2^-7 x max|plain|) when cast to a bf16
    x.  Whether two calls give the same bits is recorded, per output."""
    h, w, c, cout, count = shape
    g = torch.from_numpy(rng.normal(0, 1, (h * w, 9 * c)).astype(np.float32)
                         ).to(x.device, x.dtype)
    args = (g, x, offsets, mask, radius)
    plan = cuda_dcn.plan_backward(h, w, c, radius,
                                  cuda_dcn._sm_count(x.device.index),
                                  x.element_size())
    name = "dcn_backward" if plan is not None else "dcn_backward_entry"
    if (plan is None) != (radius < 0):
        raise AssertionError(f"T5 at {(h, w, c)} radius {radius}: plan "
                             f"{plan}")

    def kernel():
        return cuda_dcn.deform_sample_backward(*args)

    def plain():
        return cuda_dcn.deform_sample_backward_reference(*args)

    before = launches()
    got = kernel()
    torch.cuda.synchronize()
    after = launches()
    if {k: after[k] - before[k] for k in after} != {
            k: int(k == name) for k in after}:
        raise AssertionError(f"T5 at {(h, w, c)} radius {radius}: launches "
                             f"{before} -> {after}, expected one {name}")
    again = kernel()
    ref = plain()
    err = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        e = (a.float() - b.float()).abs().max().item()
        rel = 2.0 ** -7 if (i == 0 and x.dtype == torch.bfloat16) else 1e-5
        tol = rel * b.float().abs().max().item()
        if not e <= tol:
            raise AssertionError(
                f"dcn_backward output {i} disagrees with its plain version "
                f"at {(h, w, c)} {regime} {x.dtype}: {e} > {tol}")
        err = max(err, e)
    t_bytes, t_ops = backward_bound(h, w, c, x.element_size(),
                                    g.element_size())
    same_bits = [torch.equal(a, b) for a, b in zip(got, again)]
    return {"phase": "kernel", "kernel": name, "model": model,
            "H": h, "W": w, "C": c, "Cout": cout, "count": count,
            "regime": regime, "dtype": str(x.dtype).replace("torch.", ""),
            "radius": radius,
            "route": "tiled" if plan is not None else "unclamped",
            "plan": None if plan is None else {
                "TH": plan.tile_h, "TW": plan.tile_w, "Cs": plan.slice_c,
                "slices": plan.slices, "slice_run": plan.slice_run,
                "blocks": plan.blocks,
                "resident": plan.resident, "smem_bytes": plan.smem_bytes,
                "workspace": plan.workspace},
            "kernel_ms": graph_times(kernel), "kernel_call_ms":
                cuda_times(kernel),
            "plain_ms": graph_times(plain, per_graph=2,
                                    reps=5),
            "library_ms": graph_times(grid_sample_backward_yardstick(
                x, offsets, mask, g, radius)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "bound_operations_ffma_ms": t_ops,
            "max_abs_err": err,
            "same_bits_two_calls": all(same_bits),
            "same_bits_two_calls_dx_doffsets_dmask": same_bits}


def kernel_calls(name, x, offsets, mask, weight, bias, radius=RADIUS):
    """(kernel, plain version, library yardstick, tolerance relative to
    max|plain|, bound) of one kernel on these inputs at clamp ``radius``
    (the samplers; -1: none).  Tolerances: float32 outputs 1e-5 (1e-4 for
    the fused product's sums of up to 4608 terms in another order); bf16
    outputs one bf16 step at the top of the range."""
    h, w, c = x.shape
    args = (x, offsets, mask)
    sample = grid_sample_yardstick(x, offsets, mask, radius)
    bf16_tol = 2.0 ** -7
    f32 = x.dtype == torch.float32
    if name == "dcn_fused":
        wargs = args + (weight, bias, RADIUS)

        def library():
            patches = sample().permute(0, 3, 2, 1).reshape(h * w, 9 * c)
            return torch.addmm(bias, patches.float(), weight)

        return (lambda: cuda_dcn.deform_conv_fused(*wargs),
                lambda: cuda_dcn.deform_conv_fused_reference(*wargs),
                library, 1e-4 if f32 else bf16_tol,
                bound_times(h, w, c, x.element_size(), 0, weight.shape[1]))
    kernel, plain, out_bytes, tol = {
        "dcn_sample": (cuda_dcn.deform_sample, cuda_dcn.deform_sample_reference,
                       x.element_size(), 1e-5 if f32 else bf16_tol),
        "dcn_sample_tap": (cuda_dcn.deform_sample_tap,
                           cuda_dcn.deform_sample_tap_reference,
                           x.element_size(), 1e-5 if f32 else bf16_tol),
        "dcn_sample_onehot": (cuda_dcn.deform_sample_onehot,
                              cuda_dcn.deform_sample_onehot_reference, 2,
                              bf16_tol),
    }[name]
    return (lambda: kernel(*args, radius), lambda: plain(*args, radius),
            sample, tol, bound_times(h, w, c, x.element_size(), out_bytes))


def bitwise_checks(x, offsets, mask, weight, bias, shape):
    """dcn_sample_tap(x) == dcn_sample(x rounded to bf16), and two
    dcn_fused calls give the same bits."""
    tap = cuda_dcn.deform_sample_tap(x, offsets, mask, RADIUS)
    plain = cuda_dcn.deform_sample(x.bfloat16().float(), offsets, mask,
                                   RADIUS)
    if not torch.equal(tap, plain):
        raise AssertionError(f"dcn_sample_tap differs from dcn_sample on a "
                             f"bf16-rounded x at {shape}")
    first = cuda_dcn.deform_conv_fused(x, offsets, mask, weight, bias, RADIUS)
    second = cuda_dcn.deform_conv_fused(x, offsets, mask, weight, bias, RADIUS)
    if not torch.equal(first, second):
        raise AssertionError(f"dcn_fused gives other bits on a second call "
                             f"at {shape}")


# kernels held and timed per (model, x dtype) at every layer shape of the
# model; dcn_fused on a bf16 x only at the largest MOT shape; dcn_backward
# alone on a bf16 x with offsets past the clamp (MOT), and on a bf16 x at
# the KITTI and nuScenes shapes of their train lines; T5's unclamped route
# (dcn_backward_entry, radius -1) only at the largest MOT shape, float32,
# 'trained' offsets
PHASE_KERNELS = {
    ("mot", torch.float32): tuple(KERNELS),
    ("mot", torch.bfloat16): ("dcn_sample", "dcn_sample_tap", "dcn_fused",
                              "dcn_sample_onehot", "dcn_backward"),
    ("kitti", torch.float32): ("dcn_sample", "dcn_sample_tap"),
    ("kitti", torch.bfloat16): ("dcn_sample", "dcn_sample_tap",
                                "dcn_sample_onehot", "dcn_backward"),
    ("nuscenes", torch.float32): ("dcn_sample",),
    ("nuscenes", torch.bfloat16): ("dcn_sample", "dcn_sample_onehot",
                                   "dcn_backward"),
    # slice 12's layer sizes: keep_res KITTI and fix_short MOT frames
    ("kitti_keep_res", torch.float32): ("dcn_sample", "dcn_sample_tap"),
    ("kitti_keep_res", torch.bfloat16): ("dcn_sample_onehot",),
    ("mot_fix_short", torch.float32): ("dcn_sample", "dcn_sample_tap"),
    ("mot_fix_short", torch.bfloat16): ("dcn_sample_onehot",),
    # slice 13's widths: DLA-169 (T1 on a bf16 x only on its 128-channel
    # layers, as the bf16 hybrid gives it) and ResDCN's unclamped neck
    ("dla169", torch.float32): ("dcn_sample", "dcn_sample_tap"),
    ("dla169", torch.bfloat16): ("dcn_sample", "dcn_sample_onehot",
                                 "dcn_backward"),
    ("resdcn18", torch.float32): ("dcn_sample",),
    ("resdcn18", torch.bfloat16): ("dcn_sample",),
    ("resdcn101", torch.float32): ("dcn_sample",),
    ("resdcn101", torch.bfloat16): ("dcn_sample",),
    # slice 15's COCO lines at 512x512: T1 on a float32 x (the heatmap
    # raise's forward), the bf16 hybrid's T1 (layers of <= 128 channels)
    # and T4, and T5 of the bf16 train line
    ("coco", torch.float32): ("dcn_sample",),
    ("coco", torch.bfloat16): ("dcn_sample", "dcn_sample_onehot",
                               "dcn_backward"),
}
# the clamp radius of each model's layers in the kernel phase
PHASE_RADIUS = {"resdcn18": GATHER_RADIUS, "resdcn101": GATHER_RADIUS}


def kernel_phase():
    """Every kernel of ``PHASE_KERNELS`` against its plain version at the 7
    layer shapes of a 544x960 MOT frame, a 448x800 nuScenes camera and a
    384x1280 KITTI frame, and (T1, T2 on a float32 x, T4 on a bf16 one,
    'trained' offsets) of a 384x1248 keep_res KITTI frame and a 544x1024
    fix_short MOT frame: on a float32 x with 'trained' offsets and with
    offsets past the clamp, and on a bf16 x (the recipes' trunk) with
    'trained' offsets (T5, ``dcn_backward``, on the MOT shapes, also on a
    bf16 x past the clamp; ``backward_row``; its unclamped route once, at
    radius -1 on the largest MOT layer), and the layer shapes of DLA-169
    (T1, T2 on a float32 x; T1 on its 128-channel layers, T4 and T5 on a
    bf16 x) and of ResDCN's neck (T1 unclamped, both dtypes), and the
    layer shapes of DLA-34 at COCO's 512x512 (T1 on a float32 x; T1 on
    its 64- and 128-channel layers, T4 and T5 on a bf16 x); the bitwise
    checks at every
    float32 MOT case; times and bounds per call, T2 with the GEMM that
    reads its patches, and each kernel's plan."""
    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    rows = []
    cases = [(shape, regime, dtype, model)
             for model, layers in (("mot", LAYERS),
                                   ("nuscenes", NUSCENES_LAYERS),
                                   ("kitti", KITTI_LAYERS))
             for regime, dtype in (("trained", torch.float32),
                                   ("uniform6", torch.float32),
                                   ("trained", torch.bfloat16),
                                   ("uniform6", torch.bfloat16))
             for shape in layers
             if model == "mot" or (regime, dtype) != ("uniform6",
                                                      torch.bfloat16)]
    cases += [(shape, "trained", dtype, model)
              for model, layers in (("kitti_keep_res", KITTI_KEEP_RES_LAYERS),
                                    ("mot_fix_short", MOT_FIX_SHORT_LAYERS),
                                    ("dla169", DLA169_LAYERS),
                                    ("resdcn18", RESDCN18_LAYERS),
                                    ("resdcn101", RESDCN101_FIRST),
                                    ("coco", COCO_LAYERS))
              for dtype in (torch.float32, torch.bfloat16)
              for shape in layers]
    for (h, w, c, cout, count), regime, dtype, model in cases:
        x = torch.from_numpy(rng.normal(0, 1, (h, w, c)).astype(np.float32)
                             ).to(dev, dtype)
        offsets = torch.from_numpy(make_offsets(rng, h, w, regime)).to(dev)
        mask = torch.from_numpy(rng.uniform(0, 1, (h, w, 9)).astype(
            np.float32)).to(dev)
        weight = torch.from_numpy((rng.normal(0, 1, (9 * c, cout))
                                   / math.sqrt(9 * c)).astype(np.float32)
                                  ).to(dev)
        bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)
                                ).to(dev)
        f32 = dtype == torch.float32
        radius = PHASE_RADIUS.get(model, RADIUS)
        if f32 and model == "mot":
            bitwise_checks(x, offsets, mask, weight, bias, (h, w, c, cout))
        for name in PHASE_KERNELS[(model, dtype)]:
            if (model in ("dla169", "coco") and not f32
                    and name == "dcn_sample" and c > HYBRID_CM_CHANNELS):
                continue
            if (not f32 and name == "dcn_fused"
                    and (h, w, c, cout, count) != LAYERS[0]):
                continue
            if not f32 and regime == "uniform6" and name != "dcn_backward":
                continue
            if name == "dcn_backward_entry" and (
                    (h, w, c, cout, count) != LAYERS[0]
                    or regime != "trained"):
                continue
            if name in ("dcn_backward", "dcn_backward_entry"):
                row = backward_row(x, offsets, mask, rng,
                                   (h, w, c, cout, count), regime, model,
                                   RADIUS if name == "dcn_backward" else -1)
                emit(row)
                rows.append(row)
                continue
            kernel, plain, library, tol_rel, (t_bytes, t_ffma, t_ops) = (
                kernel_calls(name, x, offsets, mask, weight, bias, radius))
            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (got.float() - ref.float()).abs().max().item()
            tol = tol_rel * ref.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(
                    f"{name} disagrees with its plain version at "
                    f"{(h, w, c, cout)} {regime} {dtype}: {err} > {tol}")
            row = {"phase": "kernel", "kernel": name, "model": model,
                   "H": h, "W": w, "C": c,
                   "Cout": cout, "count": count, "regime": regime,
                   "dtype": str(dtype).replace("torch.", ""),
                   "radius": radius,
                   "kernel_ms": graph_times(kernel),
                   "kernel_call_ms": cuda_times(kernel),
                   "plain_ms": graph_times(plain, per_graph=2,
                                           reps=5),
                   "library_ms": graph_times(library),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                   "bound_operations_ffma_ms": t_ffma,
                   "max_abs_err": err, "tolerance": tol}
            if f32 and model == "mot" and name == "dcn_sample_tap":
                row["with_gemm_ms"] = graph_times(
                    lambda: cuda_dcn.deform_conv_tap(x, offsets, mask, weight,
                                                     bias, RADIUS))
            if name in ("dcn_sample", "dcn_sample_tap"):
                plan = cuda_dcn.plan_sample(
                    h, w, c, cuda_dcn._sm_count(x.device.index))
                row["plan"] = {"tiles": plan.tiles, "slices": plan.slices,
                               "slice_c": plan.slice_c,
                               "blocks": plan.blocks}
            if name == "dcn_sample_onehot":
                plan = cuda_dcn.plan_onehot(
                    h, w, c, RADIUS, cuda_dcn._sm_count(x.device.index))
                row["plan"] = {"TH": plan.tile_h, "TW": plan.tile_w,
                               "Cs": plan.slice_c, "blocks": plan.blocks,
                               "window_bytes": plan.window_bytes,
                               "smem_bytes": plan.smem_bytes}
            if f32 and model == "mot" and name in ("dcn_sample_tap",
                                                   "dcn_fused"):
                row["bitwise_check"] = ("equals dcn_sample on bf16-rounded x"
                                        if name == "dcn_sample_tap" else
                                        "same bits on two calls")
            emit(row)
            rows.append(row)
    return rows


# ---- slice 13: the other model families --------------------------------------

ARCH_FRAMES = 4                # 10, then 6 until slice 15's phases
ARCH_TRAIN_ITERS = 3
# the detection families through create_model -> forward -> detect, each
# held against itself with every DCN through its plain version: the kernel
# phase's tolerances (float32 1e-5, bf16 one step at the top of the range),
# relative to each head's max|plain|
DETECTION_FAMILIES = (
    ("res_18", {}), ("res_101", {}), ("resdcn_18", {}), ("resdcn_101", {}),
    ("dlav0_34", {}),
    ("generic", dict(backbone="mobilenet", neck="msraup",
                     msra_outchannel=64)),
    ("generic", dict(backbone="resnet", num_layers=18, neck="dlaup",
                     dla_node="dcn")),
)
FAMILY_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the whole network's heads against the plain-DCN network, relative to the
# largest head value: the layers' differences pass through the rest of the
# network (a bf16 step in one layer's output moves the next layer's input)
NETWORK_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}
ARCH_TOP_K = 10                # top scores a family's row prints


def normalized_input(frame, cfg, device):
    """A uint8 BGR frame as ``Detector.pre_process`` gives it to the
    network at fix_res: [1, input_h, input_w, 3] float32, normalized."""
    h, w = frame.shape[:2]
    c = np.array([w / 2.0, h / 2.0], np.float32)
    warped = warp_affine_separable(
        torch.as_tensor(frame, device=device)[None],
        separable_inverse_tf(c, max(h, w) * 1.0, cfg.input_w, cfg.input_h),
        cfg.input_h, cfg.input_w)
    mean = torch.tensor(deft_model.MEAN, device=device)
    std = torch.tensor(deft_model.STD, device=device)
    return (warped / 255.0 - mean) / std


@contextlib.contextmanager
def layer_checks(model, dtype):
    """Meanwhile every DCNv2 layer's output is held against the same
    layer on the same input with its kernel's plain version (``plain_dcns``),
    within ``FAMILY_TOL[dtype]`` of max|plain|; yields the list of each
    call's (layer shape, error relative to max|plain|)."""
    seen = []

    def hook(mod, args, out):
        with plain_dcns():
            ref = mod.forward(*args)           # not through the hooks
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        shape = (tuple(args[0].shape[2:]), args[0].shape[1], out.shape[1])
        if not err <= FAMILY_TOL[dtype] * top:
            raise AssertionError(f"DCNv2 {shape} {dtype} off its plain "
                                 f"version by {err} (max {top})")
        seen.append((shape, err / max(top, 1e-30)))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, DCNv2)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def plain_dcns():
    """Every DCNv2 layer meanwhile samples through the plain version of its
    kernel, on the card too (the families' reference)."""
    plain = {cuda_dcn.deform_sample: cuda_dcn.deform_sample_reference,
             cuda_dcn.deform_sample_tap: cuda_dcn.deform_sample_tap_reference,
             cuda_dcn.deform_sample_onehot:
                 cuda_dcn.deform_sample_onehot_reference}
    chosen = DCNv2._function

    def function(self, *args):
        fn = chosen(self, *args)
        if isinstance(fn, functools.partial):       # deform_conv_rounded
            return functools.partial(fn.func, plain[fn.args[0]])
        return functools.partial(fn, sample=plain[dcn_module._SAMPLERS[fn]])

    DCNv2._function = function
    try:
        yield
    finally:
        DCNv2._function = chosen


def arch_run(name, det, frames, per_frame, chunk=None):
    """One tracking path of the archs phase: ``Detector.run`` (``chunk``
    None) or a ``PipelinedRunner`` at ``chunk``.  Asserts ``per_frame``
    {(kernel, x dtype): launches} per dispatched frame and nothing else,
    and finite tracks; returns its row: wall ms/frame (the frames after
    the first; a runner's whole sequence), device ms/frame over three more
    frames under ``torch.profiler``, launches and detections per frame."""
    sync = torch.cuda.synchronize
    counts = counted_detections(det)
    if chunk is None:
        run_ms = []
        step = timed(det.run, sync, run_ms)
        sync()
        reset_launches()
        with sampled_dtypes() as seen:
            seq = [step(frame) for frame in frames]
        count = launches()
        ms = statistics.median(run_ms[1:])

        def again():
            for frame in frames[1:4]:
                det.run(frame)
    else:
        runner = PipelinedRunner(det, depth=3, chunk=chunk)
        runner.track_sequence(frames[: 2 * chunk])          # warm up
        runner.reset()
        counts.clear()
        sync()
        reset_launches()
        t0 = time.perf_counter()
        with sampled_dtypes() as seen:
            seq = runner.track_sequence(frames)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        count = launches()

        def again():
            runner.reset()
            runner.track_sequence(frames[:3])
    want = {key: n * len(frames) for key, n in per_frame.items()}
    want_count = dict.fromkeys(KERNELS, 0)
    want_count.update({k: n for (k, _), n in want.items()})
    if count != want_count or dict(seen) != want:
        raise AssertionError(f"archs {name}: launches {count} on x "
                             f"{dict(seen)}, expected {want}")
    n_tracks = check_tracks(seq, 0)
    device_ms, _ = device_profile(again, 3)
    cfg = det.cfg
    return {"phase": "archs", "path": name,
            "config": f"{cfg.arch} {cfg.dla_node} dcn_impl={cfg.dcn_impl} "
                      f"{cfg.compute_dtype} {cfg.input_h}x{cfg.input_w} "
                      f"K={cfg.K} max_object={cfg.max_object}",
            "frames": len(frames), "frame_size": list(frames[0].shape[:2]),
            "ms_per_frame": ms, "device_ms_per_frame": device_ms,
            "launches": count,
            "launches_per_frame": {f"{k} {d}": n for (k, d), n
                                   in per_frame.items()},
            "detections_to_tracker_per_frame": counts[: len(frames)],
            "tracks_per_frame_median": statistics.median(n_tracks)}


def family_run(arch, kw, frame, dtype, weights=None):
    """One detection family at ``dtype`` through ``create_model`` ->
    ``forward`` -> ``detect`` on one 544x960 frame, with ``weights``, or
    else seeded ones with the offset convs randomized and the heatmap
    raised (``raise_class_heatmaps``, at float32: a bf16 head's seeded
    logits are all one value).  Asserts T1 on every DCNv2 layer (the
    necks' gather DCNs, at either dtype) and nothing else; holds each
    layer's output against the same layer with its kernel's plain version
    (``layer_checks``, ``FAMILY_TOL``) and every head of the forward
    against the same model with every DCN through its plain version
    (``NETWORK_TOL``); returns (its row: launches per frame, device ms per
    frame, the top scores and the largest errors; the weights)."""
    cfg = mot_config(arch=arch, compute_dtype=dtype, **kw)
    model = create_model(arch, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED)
    x = normalized_input(frame, cfg, "cuda")
    n_dcn = sum(isinstance(m, DCNv2) for m in model.modules())
    with torch.no_grad():
        if weights is not None:
            model.load_state_dict(weights)
        else:
            if n_dcn:
                randomize_offsets(model, x, gen)
            # the seeded MobileNetV2's features decay to ~1e-11 by the
            # neck's end: read the heatmap's spread with its bias at 0
            raise_class_heatmaps(model, x)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model(x)                                   # the library's first picks
        torch.cuda.synchronize()
        reset_launches()
        with sampled_dtypes() as seen:
            outputs, maps = model(x)
            dets = model.detect(x, k=cfg.K)
            torch.cuda.synchronize()
        count = launches()
        want = {("dcn_sample", dtype): 2 * n_dcn} if n_dcn else {}
        if dict(seen) != want or sum(count.values()) != 2 * n_dcn:
            raise AssertionError(f"{arch} {kw} {dtype}: launches {count} on "
                                 f"x {dict(seen)}, expected {want}")
        with layer_checks(model, dtype) as layers:
            model(x)
        with plain_dcns():
            plain, _ = model(x)
        top = max(ref.abs().max().item() for ref in plain.values())
        worst = 0.0
        for head, out in outputs.items():
            ref = plain[head]
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{arch} {kw} {dtype}: head {head} "
                                     f"{tuple(out.shape)} not finite")
            worst = max(worst, (out - ref).abs().max().item() / top)
        if not worst <= NETWORK_TOL[dtype]:
            raise AssertionError(f"{arch} {kw} {dtype}: heads off the plain "
                                 f"DCNs' by {worst} of their max {top}")
        device_ms, _ = device_profile(lambda: [model.detect(x, k=cfg.K)
                                               for _ in range(3)], 3)
    scores = dets["scores"][0]
    if not torch.isfinite(scores).all() or scores.shape != (cfg.K,):
        raise AssertionError(f"{arch} {kw} {dtype}: scores {scores}")
    return {"phase": "archs", "family": arch, "options": kw, "dtype": dtype,
            "model": type(model).__name__, "input": [cfg.input_h,
                                                      cfg.input_w],
            "dcn_layers": n_dcn, "feature_maps": len(maps),
            "launches": count,
            "launches_per_frame": {f"{k} {d}": n // 2 for (k, d), n
                                   in dict(seen).items()},
            "device_ms_per_frame": device_ms,
            "top_scores": [round(float(v), 6)
                           for v in scores[:ARCH_TOP_K].cpu()],
            "layer_max_rel_err_to_plain": max((e for _, e in layers),
                                              default=0.0),
            "layer_tolerance": FAMILY_TOL[dtype],
            "heads_max_rel_err_to_plain": worst,
            "heads_tolerance": NETWORK_TOL[dtype]}, weights


def archs_phase(data: Path) -> dict:
    """Slice 13's paths at full width with seeded random weights.

    * DLA-169 (``--arch dla_169``) tracking MOT at 544x960 through
      ``Detector.run`` on 10 synthetic 1080p frames at float32 (hybrid:
      16 T1 per frame) and bf16 (hybrid: T1 on the five 128-channel layers,
      T4 on the other 11), and through the ``PipelinedRunner`` at chunk 1
      (``dcn_impl="pallas"``, 16 T2 per frame); the float32 card forward
      held against the CPU's (``reference_check``);
    * the MOT recipe's ``train.py`` line with ``--arch dla_169`` (bf16,
      batch 4, 3 steps, the in-process loader, ``--load_model`` of the
      tracking weights) under ``--profile``: 128 T4 and 128 T5 per step;
    * DLA-34 with ``--dla_node gcn`` through ``Detector.run``: no DCN, no
      launch;
    * every detection family of ``DETECTION_FAMILIES`` at float32 and bf16
      (``family_run``).

    Returns {path: launches}."""
    frames = list(synthetic_frames(ARCH_FRAMES))
    cfg = mot_config(arch="dla_169")
    det, n_dcn, offset_q = prepared_detector(cfg, frames, "cuda",
                                             DLA169_LAYERS)
    ref_rel = reference_check(det, cfg)
    weights = {k: v.detach().clone() for k, v in det.model.state_dict().items()}
    bf16_layers = Counter(bf16_hybrid_kernel("mot", m.weight.shape[1])
                          for m in det.model.modules()
                          if isinstance(m, DCNv2))
    out = {}
    rows = []
    for name, dtype, impl, chunk in (
            ("Detector.run DLA-169 float32", "float32", "hybrid", None),
            ("Detector.run DLA-169 bf16", "bfloat16", "hybrid", None),
            ("PipelinedRunner chunk 1 DLA-169", "float32", "pallas", 1)):
        if (dtype, impl) != ("float32", "hybrid"):
            det = Detector(cfg.replace(compute_dtype=dtype, dcn_impl=impl),
                           weights, device="cuda")
        if impl == "pallas":
            per_frame = {("dcn_sample_tap", dtype): n_dcn}
        elif dtype == "float32":
            per_frame = {("dcn_sample", dtype): n_dcn}
        else:
            per_frame = {(k, dtype): n for k, n in bf16_layers.items()}
        row = arch_run(name, det, frames, per_frame, chunk)
        if impl == "hybrid" and dtype == "float32":
            row.update({"card_vs_cpu_max_rel_err": ref_rel,
                        "offset_abs_q01_q50_q99": offset_q})
        emit(row)
        rows.append(row)
        out[name] = row["launches"]
        del det
    gc.collect()
    torch.cuda.empty_cache()

    weights_file = TRAIN_DIR / "weights" / "dla169" / "model.pth"
    weights_file.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": 0, "state_dict": {k: v.cpu() for k, v
                                           in weights.items()}}, weights_file)
    del weights
    (train_argv,) = [a for (r, script, _), a in recipe_lines().items()
                     if r == "mot" and script == "train.py"]
    line = with_flags(train_argv, arch="dla_169", data_dir=data.parent,
                      exp_dir="exp_archs", num_epochs=1,
                      num_iters=ARCH_TRAIN_ITERS, num_workers=0,
                      load_model=weights_file)
    per_step = n_dcn * parse_config(line)[0].batch_size * 2
    cwd = os.getcwd()
    os.chdir(TRAIN_DIR)
    try:
        row = train_line("mot", line, per_step, ARCH_TRAIN_ITERS,
                         profile=TRAIN_DIR / "profile" / "dla169")
    finally:
        os.chdir(cwd)
    row["phase"] = "archs"
    row["path"] = "deft_tpu_torch.train DLA-169 bf16"
    emit(row)
    out[row["path"]] = row["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    gcn = mot_config(dla_node="gcn")
    det = Detector(gcn, device="cuda")
    if any(isinstance(m, DCNv2) for m in det.model.modules()):
        raise AssertionError("a gcn DLA-34 has DCNv2 layers")
    raise_heatmap(det.model, det.pre_process(frames[0])[0])
    row = arch_run("Detector.run DLA-34 gcn", det, frames, {})
    emit(row)
    out[row["path"]] = row["launches"]
    del det

    for arch, kw in DETECTION_FAMILIES:
        weights = None
        for dtype in ("float32", "bfloat16"):
            row, weights = family_run(arch, kw, frames[0], dtype, weights)
            emit(row)
            out[f"{arch} {kw} {dtype}, forward + detect"] = row["launches"]
        del weights
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- the main path ----------------------------------------------------------

def synthetic_scene(n: int, h: int = 1080, w: int = 1920):
    """Moving coloured rectangles on a noisy background: per frame the
    uint8 BGR image and the rectangles' [x1, y1, x2, y2] boxes (float64
    [40, 4], in drawing order: later ones may cover earlier ones)."""
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
        boxes = np.empty((n_obj, 4))
        for i, ((y, x), (vy, vx), (bh, bw), col) in enumerate(
                zip(pos, vel, size, colours)):
            y0 = int(np.clip(y + vy * f, 0, h - bh))
            x0 = int(np.clip(x + vx * f, 0, w - bw))
            img[y0: y0 + bh, x0: x0 + bw] = col
            boxes[i] = (x0, y0, x0 + bw, y0 + bh)
        yield img, boxes


def synthetic_frames(n: int, h: int = 1080, w: int = 1920):
    """``synthetic_scene``'s frames alone."""
    for img, _ in synthetic_scene(n, h, w):
        yield img


@torch.no_grad()
def dcn_layer_shapes(model, image) -> Counter:
    """The (H, W, Cin, Cout) of every DCNv2 layer in one forward of
    ``image``, counted."""
    shapes = Counter()

    def pre_hook(mod, args):
        x = args[0]
        shapes[(x.shape[2], x.shape[3], x.shape[1],
                mod.weight.shape[0])] += 1

    hooks = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
             if isinstance(m, DCNv2)]
    try:
        model(image)
    finally:
        for hk in hooks:
            hk.remove()
    return shapes


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
    the heatmap head so ~1% of this image's pixels score above 0.5 in every
    class."""
    outputs, _ = model(image)
    z = outputs["hm"]
    gain = 2.0 / z.std().item()
    thr = torch.quantile(z.reshape(-1, z.shape[-1]), 1.0 - top_fraction,
                         dim=0)
    out = model.hm[-1]
    out.weight.mul_(gain)
    out.bias.copy_((out.bias - thr) * gain)


@torch.no_grad()
def raise_class_heatmaps(model, image, top_fraction=0.01):
    """``raise_heatmap`` for a head of several classes: the seeded head's
    logits spread by ~1e-6 about its -4.6 prior bias, below float32's
    resolution at 4.6, so the spread is read with the bias at 0.  Then
    ~``top_fraction`` of this image's pixels score above 0.5 in each class,
    and the box head's bias is set to a car's size in output cells."""
    out = model.hm[-1]
    out.bias.zero_()
    outputs, _ = model(image)
    z = outputs["hm"]
    gain = 2.0 / z.std().item()
    thr = torch.quantile(z.reshape(-1, z.shape[-1]), 1.0 - top_fraction,
                         dim=0)
    out.weight.mul_(gain)
    out.bias.copy_(-thr * gain)
    # random box heads give boxes of zero size: a car's 48x32 input pixels
    model.wh[-1].bias.copy_(torch.tensor([12.0, 8.0]))


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


def prepared_detector(cfg, frames, device, layers, heatmap=raise_heatmap):
    """A Detector with seeded weights, its offset convs randomized and its
    heatmap raised on the first frame by ``heatmap``; checks the DCNv2
    layer shapes."""
    gen = torch.Generator().manual_seed(SEED)
    det = Detector(cfg, device=device)
    model = det.model
    n_dcn = sum(isinstance(m, DCNv2) for m in model.modules())
    first, _ = det.pre_process(frames[0])
    offset_q, shapes = randomize_offsets(model, first, gen)
    expected = Counter({l[:4]: l[4] for l in layers})
    if shapes != expected or n_dcn != sum(expected.values()):
        raise AssertionError(f"DCN layer shapes {dict(shapes)} != {dict(expected)}")
    heatmap(model, first)
    return det, n_dcn, offset_q


def check_tracks(seq, min_dets):
    """Finite boxes and enough detections in every frame's track list."""
    n_dets = [len(online) for online in seq]
    for online in seq:
        for t in online:
            if not np.isfinite(t.tlbr).all():
                raise AssertionError("non-finite track box")
    if min(n_dets) < min_dets:
        raise AssertionError(f"too few detections per frame: {n_dets}")
    return n_dets


def stage_times(det, frames, sync) -> dict:
    """Where a steady ``Detector.run`` frame's time goes: the median ms of
    each stage over ``frames``, each stage ended by ``sync``."""
    stages = {"pre_process": [], "detect": [], "post_process": [],
              "track": []}
    for frame in frames:
        t = [time.perf_counter()]
        images, meta = det.pre_process(frame)
        sync()
        t.append(time.perf_counter())
        dets, emb = det.process(images)
        sync()
        t.append(time.perf_counter())
        results = det.post_process(dets, meta)
        t.append(time.perf_counter())
        det._track(results, emb[0][: len(results)], None)
        sync()
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t[:-1], t[1:]):
            stages[name].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in stages.items()}


def slice_phase(cfg, frames, device="cuda", layers=LAYERS, min_dets=20):
    """Drive ``Detector.run`` over the frames and check that every DCNv2
    layer of every frame launched ``dcn_sample``.  ``device``, ``layers``
    and ``min_dets`` exist for a rehearsal at a tiny size on the CPU."""
    det, n_dcn, offset_q = prepared_detector(cfg, frames, device, layers)
    sync = torch.cuda.synchronize if det.device.type == "cuda" else lambda: None
    ref_rel = reference_check(det, cfg)
    det.reset_tracking()

    sync()
    resident = None
    if det.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    reset_launches()
    times, seq, n_tracks = [], [], []
    for frame in frames:
        t0 = time.perf_counter()
        online = det.run(frame)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        seq.append(online)
        n_tracks.append(len(det.tracker.tracked_stracks))
    count = launches()
    peak = (torch.cuda.max_memory_allocated() if det.device.type == "cuda"
            else None)
    on_card = det.device.type == "cuda"
    expected = dict.fromkeys(KERNELS, 0)
    expected["dcn_sample"] = n_dcn * len(frames) if on_card else 0
    if count != expected:
        raise AssertionError(f"kernel launches {count}, expected {expected}")
    if not torch.isfinite(det.tracker.recorder.embeds).all():
        raise AssertionError("non-finite embeddings in the ring")
    n_dets = check_tracks(seq, min_dets)
    stages = stage_times(det, frames[:5], sync)

    row = {"phase": "slice", "device": str(det.device),
           "config": f"mot_config dla_34 {cfg.dla_node} dcn_impl="
                     f"{cfg.dcn_impl} {cfg.input_h}x{cfg.input_w} K={cfg.K} "
                     f"max_object={cfg.max_object}",
           "frames": len(frames), "frame_size": list(frames[0].shape[:2]),
           "ms_per_frame_median": statistics.median(times[1:]),
           "ms_first_frame": times[0],
           "dets_per_frame_median": statistics.median(n_dets),
           "tracks_per_frame_median": statistics.median(n_tracks),
           "dcn_layers": n_dcn, "launches": count,
           "peak_memory_bytes": peak, "resident_at_start_bytes": resident,
           "offset_abs_q01_q50_q99": offset_q,
           "card_vs_cpu_max_rel_err": ref_rel,
           "stage_ms_median": stages}
    emit(row)
    return count["dcn_sample"], det, row["ms_per_frame_median"]


# runner runs: (name, chunk, chunk_batched); bench.py batches only with
# --chunk-batched
RUNS = (("test.py", 1, False), ("bench.py", CHUNK, False),
        ("bench.py --chunk-batched", CHUNK, True))
CONFIG_NAMES = {"mot": "mot_config", "kitti_tracking": "kitti_config"}


@torch.no_grad()
def runner_phase(frames, cfg=None, device="cuda", layers=LAYERS, min_dets=20,
                 runs=RUNS, phase="runner", heatmap=raise_heatmap):
    """Slice 2's main path: ``mot_config(dcn_impl="pallas")`` through the
    ``PipelinedRunner`` of test.py (chunk 1, depth 3), then of bench.py
    (chunk 4: ``frame_chunk``, and ``frame_chunk_batched`` under its
    --chunk-batched; the last chunk is padded to 4).  Each run follows a
    warm-up sequence and a ``reset``; its launch counts are read around
    ``track_sequence`` alone.  Every DCNv2 layer of every dispatched frame
    must launch ``dcn_sample_tap`` and nothing else.

    Chunk 4 ``frame_chunk`` runs each frame's program as chunk 1 does, so
    its frames must carry the same track ids, each track's box within
    BOX_TOL_CARD.  The batched run is held to that only as a report: cuDNN
    picks other algorithms for a batch of 4, whose last-bit differences T2's
    bf16 rounding of each DCN input turns into bf16 steps, and the random
    weights' heatmap gain amplifies those into other detections
    (PERF.md §6).  Returns ({run: row}, {run: runner}, {run: per-frame
    track lists}).  ``cfg``, ``runs`` and ``heatmap`` give slice 6's KITTI
    runs, under ``phase``; ``device``, ``layers`` and ``min_dets`` exist for
    a rehearsal on the CPU."""
    cfg = cfg or mot_config(dcn_impl="pallas")
    det, n_dcn, offset_q = prepared_detector(cfg, frames, device, layers,
                                             heatmap)
    on_card = det.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else lambda: None
    rows, tracks, runners, seqs = {}, {}, {}, {}
    for run, chunk, batched in runs:
        det.cfg = cfg.replace(chunk_batched=batched)
        runner = PipelinedRunner(det, depth=3, chunk=chunk)
        runner.track_sequence(frames[: 2 * chunk])
        det.ids = IdAllocator()       # every run numbers its tracks from 1
        runner.reset()
        sync()
        resident = None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        seq = runner.track_sequence(frames)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        count = launches()
        dispatched = math.ceil(len(frames) / chunk) * chunk
        expected = dict.fromkeys(KERNELS, 0)
        expected["dcn_sample_tap"] = n_dcn * dispatched if on_card else 0
        if count != expected:
            raise AssertionError(f"{run}: kernel launches {count}, expected "
                                 f"{expected}")
        if len(seq) != len(frames):
            raise AssertionError(f"{run}: {len(seq)} frames tracked")
        if not torch.isfinite(runner.state["embeds"]).all():
            raise AssertionError(f"{run}: non-finite embeddings in the ring")
        n_dets = check_tracks(seq, min_dets)
        rows[run] = {
            "phase": phase, "run": run, "device": str(det.device),
            "config": f"{CONFIG_NAMES[cfg.dataset]} dla_34 {cfg.dla_node} "
                      f"dcn_impl="
                      f"{cfg.dcn_impl} {cfg.input_h}x{cfg.input_w} "
                      f"K={cfg.K} max_object={cfg.max_object} sim_window="
                      f"{runner.sim_window}",
            "chunk": chunk, "chunk_batched": batched, "depth": 3,
            "frames": len(frames), "frames_dispatched": dispatched,
            "ms_per_frame": wall_ms / len(frames),
            "timings_ms_per_frame": runner.timings(),
            "main_keys": list(runner.main_keys()),
            "dets_per_frame_median": statistics.median(n_dets),
            "dcn_layers": n_dcn, "launches": count,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if on_card else None),
            "resident_at_start_bytes": resident,
            "offset_abs_q01_q50_q99": offset_q}
        # per frame: track id -> box (a frame's tracks come in the order of
        # its detections)
        tracks[run] = [{t.track_id: t.tlbr for t in online} for online in seq]
        runners[run] = runner
        seqs[run] = seq
    base = tracks["test.py"]
    for run, _, batched in runs[1:]:
        same = [sorted(a) == sorted(b) for a, b in zip(base, tracks[run])]
        box_diff = max((float(np.abs(a[i] - b[i]).max())
                        for a, b in zip(base, tracks[run]) for i in a if i in b),
                       default=0.0)
        rows[run].update({"frames_with_chunk_1_track_ids": sum(same),
                          "first_frame_ids_differ": (same.index(False)
                                                     if not all(same) else None),
                          "max_box_diff_px_to_chunk_1": box_diff})
        if not batched and not (all(same) and box_diff <= BOX_TOL_CARD):
            raise AssertionError(
                f"{run} differs from chunk 1: {sum(same)} of {len(same)} "
                f"frames with its track ids, boxes within {box_diff} px")
    for row in rows.values():
        emit(row)
    det.cfg = cfg
    return rows, runners, seqs


@torch.no_grad()
def runner_profile_phase(runner, frames, ms_per_frame):
    """Where the runner's time goes on the card: CUDA-event times of the
    window similarity against the 12 freshest ring slots (the runner's) and
    against all 50, then ``torch.profiler`` over 8 frames of the chunk-1
    runner for the device kernel time per frame.  The busy share divides it
    by the runner phase's (unprofiled) ms/frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = runner.det.model
    state = runner.state
    m = runner.cfg.max_object
    cur = state["embeds"][0].clone()
    n = torch.tensor(m, dtype=torch.int32, device=cur.device)
    idx = (state["ptr"] - 1 - torch.arange(runner.sim_window,
                                           device=cur.device)) % 50
    row = {"phase": "runner_profile",
           "similarity_12_slots_ms": cuda_times(lambda: model.window_similarity(
               state["embeds"][idx], state["counts"][idx], cur, n)),
           "similarity_50_slots_ms": cuda_times(lambda: model.window_similarity(
               state["embeds"], state["counts"], cur, n))}
    # the main thread's dispatch with the cascade on the same thread (no
    # worker competing for the interpreter lock)
    runner.reset()
    runner.cascade_async = False
    runner.track_sequence(frames[:10])
    row["timings_ms_per_frame_cascade_inline"] = runner.timings()
    runner.cascade_async = True
    runner.reset()
    n_frames = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.track_sequence(frames[:n_frames])
        torch.cuda.synchronize()
    kernels, host_waits = [], {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            if "Synchronize" in evt.key or "cudaMemcpy" in evt.key:
                host_waits[evt.key] = evt.count / n_frames
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        kernels.append((t / 1e3 / n_frames, evt.count / n_frames, evt.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    row.update({"profiled_frames": n_frames, "device_ms_per_frame": device_ms,
                "busy_share": device_ms / ms_per_frame,
                "host_sync_and_copy_calls_per_frame": host_waits,
                "top_kernels_ms_per_frame": [
                    [round(t, 4), c, name[:90]] for t, c, name in kernels[:12]]})
    emit(row)


@torch.no_grad()
def profile_phase(det, frames, ms_per_frame, phase="profile"):
    """Where a frame's device time goes: CUDA-event times of the network
    forward, ``detect`` and the 50-slot window similarity, then
    ``torch.profiler`` over 3 more frames of ``Detector.run`` for the kernel
    time per frame by name.  The busy share divides that kernel time by the
    (unprofiled) median ms/frame of the phase that drove ``det``, the slice
    phase's or, under ``phase="kitti_profile"``, the KITTI phase's."""
    images, _ = det.pre_process(frames[0])
    rec = det.tracker.recorder
    counts = torch.as_tensor(rec.counts, device=det.device)
    cur = rec.embeds[0].clone()
    row = {"phase": phase,
           "forward_ms": cuda_times(lambda: det.model(images)),
           "detect_ms": cuda_times(lambda: det.model.detect(images, k=det.cfg.K)),
           "window_similarity_ms": cuda_times(
               lambda: det.model.window_similarity(rec.embeds, counts, cur,
                                                   det.cfg.max_object)),
           "ring_slots_filled": int((rec.counts > 0).sum())}
    n = 3
    device_ms, top = device_profile(
        lambda: [det.run(frame) for frame in frames[1: 1 + n]], n)
    row.update({"profiled_frames": n, "device_ms_per_frame": device_ms,
                "busy_share": device_ms / ms_per_frame,
                "top_kernels_ms_per_frame": top})
    emit(row)


def timed(fn, sync, times):
    """``fn`` with each call's host time, ended by ``sync``, appended to
    ``times`` (ms)."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


@torch.no_grad()
def plausible_3d_heads(model):
    """Random 3-D heads give degenerate boxes (sizes and depths near 0):
    set the dim head's bias to a car's (h, w, l) = (1.6, 1.9, 4.5) m and the
    depth head's to ~20 m, as ``raise_heatmap`` sets the heatmap's."""
    model.dim[-1].bias.copy_(torch.tensor([1.6, 1.9, 4.5]))
    model.dep[-1].bias.fill_(-math.log(20.0))


def snapshot(online):
    return [(t.track_id, t.classe, np.asarray(t.tlbr)) for t in online]


@torch.no_grad()
def nuscenes_phase(cfg=None, device="cuda", layers=NUSCENES_LAYERS,
                   samples=NUSCENES_SAMPLES, size=(900, 1600), min_tracks=20):
    """Slice 4's main path: ``nuscenes_config()`` at full width with seeded
    random weights through ``track_nuscenes`` -> ``Detector.run_multi`` on
    ``samples`` samples of the six-camera rig.  Every DCNv2 layer of every
    camera must launch ``dcn_sample`` (16 x 6 per sample) and the LSTM must
    step tracks; the tracks must carry global boxes and the submission be
    well formed.  Reports ms per sample (median over samples 2 on), the
    stage split (the LSTM inside the track stage), peak memory, the
    ``torch.profiler`` busy share and how many cameras' tracks one
    ``run`` per camera reproduces.  ``cfg``, ``device``, ``layers``,
    ``size`` and ``min_tracks`` exist for a rehearsal on the CPU."""
    cfg = cfg or nuscenes_config()
    scene = make_scene(n_samples=samples, cameras=CAMERAS, height=size[0],
                       width=size[1], seed=SEED + 3)
    gen = torch.Generator().manual_seed(SEED)
    det = Detector(cfg, device=device)
    on_card = det.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else lambda: None
    model = det.model
    n_dcn = sum(isinstance(m, DCNv2) for m in model.modules())
    info0, frame0 = scene[0]
    first, _ = det.pre_process(frame0, {"calib": info0["calib"]})
    offset_q, shapes = randomize_offsets(model, first, gen)
    expected = Counter({l[:4]: l[4] for l in layers})
    if shapes != expected or n_dcn != sum(expected.values()):
        raise AssertionError(f"nuScenes DCN layer shapes {dict(shapes)} != "
                             f"{dict(expected)}")
    raise_heatmap(model, first)
    plausible_3d_heads(model)
    infos = {info["id"]: info for info, _ in scene}

    run_ms, lstm_ms = [], []
    det.run_multi = timed(det.run_multi, sync, run_ms)
    det.motion.predict_batch = timed(det.motion.predict_batch, sync, lstm_ms)
    sync()
    resident = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    reset_launches()
    motion_lstm.BATCHES = motion_lstm.ROWS = 0
    results = track_nuscenes(det, [(1, scene)])
    sync()
    count = launches()
    lstm_steps = (motion_lstm.BATCHES, motion_lstm.ROWS)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    expected = dict.fromkeys(KERNELS, 0)
    expected["dcn_sample"] = n_dcn * CAMERAS * samples if on_card else 0
    if count != expected:
        raise AssertionError(f"nuScenes kernel launches {count}, expected "
                             f"{expected}")
    if lstm_steps[0] < 1 or lstm_steps[1] < 1:
        raise AssertionError(f"no LSTM step with rows: {lstm_steps}")
    items = [item for v in results.values() for item in v]
    if len(results) != len(scene) or len(items) < min_tracks * samples:
        raise AssertionError(f"{len(items)} tracks over {len(results)} "
                             f"frames")
    for item in items:
        box = item["translation"] + item["size"] + item["rotation"]
        if not np.isfinite(box).all() or not np.isfinite(item["bbox"]).all():
            raise AssertionError(f"non-finite track box {item}")
    sub = nuscenes_submission(results, infos)
    if sorted(sub["results"]) != sorted({i["sample_token"]
                                         for i in infos.values()}):
        raise AssertionError("submission samples differ from the scene's")
    for token, sub_items in sub["results"].items():
        if not 0 < len(sub_items) <= 500:
            raise AssertionError(f"{len(sub_items)} items in {token}")
        for it in sub_items:
            if (len(it["translation"]) != 3 or len(it["rotation"]) != 4
                    or len(it["velocity"]) != 2
                    or it["tracking_name"] != it["detection_name"]):
                raise AssertionError(f"malformed submission item {it}")
    for rec in det.tracker.values():
        if not torch.isfinite(rec.recorder.embeds).all():
            raise AssertionError("non-finite embeddings in a ring")
    lstm_during_run = sum(lstm_ms)

    # where a steady sample's time goes, each stage ended by a synchronize;
    # inside the track stage: the LSTM steps, the trackers' window
    # similarity (card, copy out, host decay) and the 3-D IoU (host)
    stages = {"pre_process": [], "detect": [], "post_process": [],
              "track": [], "track_lstm": [], "track_similarity": [],
              "track_iou3d": [], "iou3d_pairs": []}
    sim_ms, iou_ms, pairs = [], [], []
    iou_ddd_distance = matching.iou_ddd_distance

    def counted_iou3d(a, b):
        pairs.append(len(a) * len(b))
        return iou_ddd_distance(a, b)

    matching.iou_ddd_distance = timed(counted_iou3d, lambda: None, iou_ms)
    for tracker in det.tracker.values():
        tracker.recorder.update = timed(tracker.recorder.update, sync, sim_ms)
    for sample in [scene[i: i + CAMERAS]
                   for i in range(CAMERAS, 4 * CAMERAS, CAMERAS)][:samples - 1]:
        t = [time.perf_counter()]
        prepared = [det.pre_process(f, {"calib": i["calib"]})
                    for i, f in sample]
        sync()
        t.append(time.perf_counter())
        dets, emb = det.process(torch.cat([p[0] for p in prepared]))
        sync()
        t.append(time.perf_counter())
        results_b = [det.post_process({k: v[b: b + 1] for k, v in dets.items()},
                                      prepared[b][1])
                     for b in range(len(sample))]
        t.append(time.perf_counter())
        for times in (lstm_ms, sim_ms, iou_ms, pairs):
            times.clear()
        for b, (info, _) in enumerate(sample):
            det._track(results_b[b], emb[b][: len(results_b[b])], info)
        sync()
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t[:-1], t[1:]):
            stages[name].append((b - a) * 1e3)
        for name, times in (("track_lstm", lstm_ms), ("iou3d_pairs", pairs),
                            ("track_similarity", sim_ms),
                            ("track_iou3d", iou_ms)):
            stages[name].append(sum(times))
    matching.iou_ddd_distance = iou_ddd_distance

    # run_multi against one run per camera, same weights, first 3 samples
    seq = Detector(cfg, model.state_dict(), device=device,
                   motion_state_dict=det.motion.model.state_dict())
    det.ids = IdAllocator()
    det.reset_tracking()
    same, box_diff, n_cams = 0, 0.0, 0
    for i in range(0, 3 * CAMERAS, CAMERAS):
        sample = scene[i: i + CAMERAS]
        want = [snapshot(seq.run(f, {"calib": inf["calib"]}, inf))
                for inf, f in sample]
        got = det.run_multi([f for _, f in sample],
                            [{"calib": inf["calib"]} for inf, _ in sample],
                            [inf for inf, _ in sample], materialize=snapshot)
        for g, w in zip(got, want):
            n_cams += 1
            if [x[:2] for x in g] == [x[:2] for x in w]:
                same += 1
                box_diff = max([box_diff] + [float(np.abs(a[2] - b[2]).max())
                                             for a, b in zip(g, w)])
    # where the two part: the batch-6 detect against six batch-1 ones
    images = torch.cat([det.pre_process(f, {"calib": inf["calib"]})[0]
                        for inf, f in scene[:CAMERAS]])
    dets6, emb6 = det.process(images)
    singles = [det.process(images[b: b + 1]) for b in range(CAMERAS)]
    detect_diff = {
        "scores": max(float(np.abs(dets6["scores"][b] - d["scores"][0]).max())
                      for b, (d, _) in enumerate(singles)),
        "embeddings": max(float((emb6[b] - e[0]).abs().max())
                          for b, (_, e) in enumerate(singles)),
        "cameras_same_top_k_order": sum(
            np.array_equal(dets6["inds"][b], d["inds"][0])
            for b, (d, _) in enumerate(singles))}

    row = {"phase": "nuscenes", "device": str(det.device),
           "config": f"nuscenes_config dla_34 {cfg.dla_node} dcn_impl="
                     f"{cfg.dcn_impl} {cfg.input_h}x{cfg.input_w} K={cfg.K} "
                     f"max_object={cfg.max_object} lstm={cfg.lstm} "
                     f"embed_dim={det.embed_dim}",
           "samples": samples, "cameras": CAMERAS,
           "frame_size": list(frame0.shape[:2]),
           "ms_per_sample_median": statistics.median(run_ms[1:samples]),
           "ms_first_sample": run_ms[0],
           "ms_per_sample_all": run_ms[:samples],
           "lstm_ms_during_run": lstm_during_run,
           "lstm_batches": lstm_steps[0], "lstm_rows": lstm_steps[1],
           "tracks_per_sample_median": statistics.median(
               [sum(len(results[i["id"]]) for i, _ in scene[j: j + CAMERAS])
                for j in range(0, len(scene), CAMERAS)]),
           "submission_items": sum(len(v) for v in sub["results"].values()),
           "dcn_layers": n_dcn, "launches": count,
           "peak_memory_bytes": peak, "resident_at_start_bytes": resident,
           "offset_abs_q01_q50_q99": offset_q,
           "stage_ms_median": {k: statistics.median(v)
                               for k, v in stages.items()},
           "run_multi_vs_run_cameras_same_ids": f"{same} of {n_cams}",
           "run_multi_vs_run_max_box_diff_px": box_diff,
           "batch6_vs_batch1_detect_max_abs_diff": detect_diff}
    if on_card:
        row.update(profile_samples(det, scene, row["ms_per_sample_median"]))
    emit(row)
    return count["dcn_sample"]


def profile_samples(det, scene, ms_per_sample):
    """``torch.profiler`` over 2 samples of ``run_multi``: device kernel
    time per sample by name, and its share of the unprofiled ms/sample."""
    n = 2

    def samples():
        for i in range(0, n * CAMERAS, CAMERAS):
            sample = scene[i: i + CAMERAS]
            det.run_multi([f for _, f in sample],
                          [{"calib": inf["calib"]} for inf, _ in sample],
                          [inf for inf, _ in sample])

    device_ms, top = device_profile(samples, n)
    return {"profiled_samples": n, "device_ms_per_sample": device_ms,
            "busy_share": device_ms / ms_per_sample,
            "top_kernels_ms_per_sample": top}


@torch.no_grad()
def checkpoint_phase(det, frame, out_dir=BUILD_DIR.parent / "checkpoint"):
    """The detector's weights through a reference checkpoint file: its
    ``state_dict`` under ``module.`` keys in ``{"epoch", "state_dict"}``,
    loaded by a second ``Detector`` through ``cfg.load_model``.  Every key
    must load (none kept at its seeded value, none dropped) and one frame's
    detections and embeddings must equal those of the weights in memory bit
    for bit."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "model_mot.pth"
    torch.save({"epoch": 1, "state_dict": {
        "module." + k: v.cpu() for k, v in det.model.state_dict().items()}},
        path)
    loaded = Detector(det.cfg.replace(load_model=str(path)),
                      device=det.device)
    report = loaded.load_report
    if report.kept or report.dropped:
        raise AssertionError(f"checkpoint keys kept {report.kept}, dropped "
                             f"{report.dropped}")
    images, meta = det.pre_process(frame)
    want, want_emb = det.process(images)
    got, got_emb = loaded.process(images)
    if not (all(np.array_equal(got[k], want[k]) for k in want)
            and torch.equal(got_emb, want_emb)):
        raise AssertionError("detections through the checkpoint differ from "
                             "those of the weights in memory")
    row = {"phase": "checkpoint", "device": str(det.device),
           "file_bytes": path.stat().st_size,
           "keys_loaded": len(report.loaded), "keys_kept": 0,
           "keys_dropped": 0, "detections_bit_identical": True,
           "detections_above_threshold": len(det.post_process(want, meta))}
    emit(row)
    return row


def check_kitti_results(results, height, width, n_frames, out_dir):
    """Every item a Car with a finite box of positive size that overlaps
    the frame; the KITTI txt that ``save_kitti_results`` writes has 18
    fields per line, class Car and frames in range.  Returns (the txt's
    path, its lines)."""
    for items in results.values():
        for it in items:
            x1, y1, x2, y2 = (float(v) for v in it["bbox"])
            if not (it["class"] == CAR and np.isfinite([x1, y1, x2, y2]).all()
                    and x1 < x2 and y1 < y2 and x1 < width and x2 > 0
                    and y1 < height and y2 > 0):
                raise AssertionError(f"bad KITTI item {it}")
    videos = [{"id": 1, "file_name": "0000"}]
    infos = {1: [{"id": i + 1, "frame_id": i + 1} for i in range(n_frames)]}
    path = os.path.join(save_kitti_results(results, videos, infos,
                                           str(out_dir)), "0000.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) != sum(len(v) for v in results.values()):
        raise AssertionError(f"{len(lines)} lines in {path}")
    for line in lines:
        parts = line.split()
        if (len(parts) != 18 or parts[2] != "Car"
                or not 0 <= int(parts[0]) < n_frames):
            raise AssertionError(f"malformed KITTI line {line!r}")
    return path, len(lines)


@torch.no_grad()
def kitti_phase(cfg=None, device="cuda", layers=KITTI_LAYERS,
                size=KITTI_SIZE, n_frames=FRAMES, min_dets=5,
                out_dir=BUILD_DIR.parent / "kitti"):
    """Slice 6's main path: ``kitti_config()`` at full width with seeded
    random weights (offsets spread about +-2 px, the heatmap raised in
    every class, so that Pedestrians and Cyclists reach the car filter) on
    ``n_frames`` frames of the numpy KITTI scene.  First through
    ``track_videos_detector`` -> ``Detector.run`` (``dcn_impl="hybrid"``):
    every DCNv2 layer of every frame must launch ``dcn_sample``, and the car
    filter must drop detections.  Then through the runner
    (``dcn_impl="pallas"``) at chunk 1 and chunk 4 (``runner_phase``: 16
    ``dcn_sample_tap`` launches per dispatched frame, chunk 4 equal to chunk
    1).  Each path's items must be cars with boxes that overlap the frame,
    and their KITTI txt well formed.  Returns the launches of
    ``Detector.run`` and of the runner's chunk-1 and chunk-4 runs.  ``cfg``,
    ``device``, ``layers``, ``size``, ``n_frames`` and ``min_dets`` exist
    for a rehearsal on the CPU."""
    cfg = cfg or kitti_config()
    frames, _ = make_sequence(n_frames=n_frames, height=size[0],
                              width=size[1], seed=SEED + 4)
    det, n_dcn, offset_q = prepared_detector(cfg, frames, device, layers,
                                             raise_class_heatmaps)
    on_card = det.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else lambda: None
    classes, run_ms = [], []
    post_process = det.post_process

    def counted_post_process(dets, meta):
        results = post_process(dets, meta)
        classes.append([d["class"] for d in results])
        return results

    det.post_process = counted_post_process
    det.run = timed(det.run, sync, run_ms)
    sync()
    reset_launches()
    results = track_videos_detector(
        det, [(1, [(i + 1, f) for i, f in enumerate(frames)])],
        cls_default=CAR)
    sync()
    count = launches()
    expected = dict.fromkeys(KERNELS, 0)
    expected["dcn_sample"] = n_dcn * n_frames if on_card else 0
    if count != expected:
        raise AssertionError(f"KITTI kernel launches {count}, expected "
                             f"{expected}")
    dropped = [sum(c != CAR for c in frame_classes)
               for frame_classes in classes]
    cars = [sum(c == CAR for c in frame_classes) for frame_classes in classes]
    if sum(dropped) == 0:
        raise AssertionError("the car filter dropped nothing")
    if min(len(v) for v in results.values()) < min_dets:
        raise AssertionError("too few car tracks per frame: "
                             f"{[len(v) for v in results.values()]}")
    txt, n_lines = check_kitti_results(results, size[0], size[1], n_frames,
                                       out_dir / "detector")
    stages = stage_times(det, frames[1:6], sync)
    row = {"phase": "kitti", "path": "Detector.run", "device": str(det.device),
           "config": f"kitti_config dla_34 {cfg.dla_node} dcn_impl="
                     f"{cfg.dcn_impl} {cfg.input_h}x{cfg.input_w} K={cfg.K} "
                     f"max_object={cfg.max_object} dtype=float32",
           "frames": n_frames, "frame_size": list(size),
           "ms_per_frame_median": statistics.median(run_ms[1:]),
           "ms_first_frame": run_ms[0],
           "car_detections_per_frame_median": statistics.median(cars),
           "non_car_detections_dropped_per_frame": dropped,
           "tracks_per_frame_median": statistics.median(
               len(v) for v in results.values()),
           "dcn_layers": n_dcn, "launches": count,
           "offset_abs_q01_q50_q99": offset_q,
           "kitti_txt": txt, "kitti_txt_lines": n_lines,
           "stage_ms_median": stages}
    emit(row)
    if on_card:
        profile_phase(det, frames, row["ms_per_frame_median"],
                      phase="kitti_profile")
    detector_launches = count["dcn_sample"]
    del det

    rows, _, seqs = runner_phase(
        frames, cfg.replace(dcn_impl="pallas"), device, layers, min_dets,
        runs=(("test.py", 1, False), ("bench.py", CHUNK, False)),
        phase="kitti_runner", heatmap=raise_class_heatmaps)
    for run, seq in seqs.items():
        check_kitti_results(
            {i + 1: tracks_to_results(online, CAR)
             for i, online in enumerate(seq)}, size[0], size[1], n_frames,
            out_dir / run.replace(" ", "_"))
    return (detector_launches,
            {run: row["launches"]["dcn_sample_tap"]
             for run, row in rows.items()})


def public_detections(boxes_per_frame, h: int, w: int, seed: int = SEED + 5):
    """Public detections of the scene, shaped like MOT17's DPM / FRCNN /
    SDP det files: each rectangle's box jittered by up to 3% of its size,
    ~10% of them dropped, 2-4 false positives of a rectangle's size range,
    scores U(0.3, 1.0); ~36-44 per frame.  Per frame a list of the det
    dicts of ``data/public_dets.py``."""
    rng = np.random.RandomState(seed)
    out = []
    for boxes in boxes_per_frame:
        size = np.tile(boxes[:, 2:] - boxes[:, :2], 2)
        jittered = boxes + rng.uniform(-0.03, 0.03, boxes.shape) * size
        kept = jittered[rng.uniform(size=len(boxes)) >= 0.1]
        n_fp = rng.randint(2, 5)
        wh = rng.uniform([0.02, 0.07], [0.08, 0.28], (n_fp, 2)) * [w, h]
        xy = rng.uniform(0, 1, (n_fp, 2)) * ([w, h] - wh)
        dets = np.concatenate([kept, np.concatenate([xy, xy + wh], 1)])
        scores = rng.uniform(0.3, 1.0, len(dets))
        out.append([{"bbox": [float(v) for v in d], "score": float(sc),
                     "class": 1,
                     "ct": [float(d[0] + d[2]) / 2, float(d[1] + d[3]) / 2]}
                    for d, sc in zip(dets, scores)])
    return out


def box_iou(a, b) -> np.ndarray:
    """[N, 4] x [M, 4] tlbr boxes -> [N, M] IoU."""
    a, b = np.asarray(a, np.float64)[:, None], np.asarray(b, np.float64)[None]
    iw = (np.minimum(a[..., 2], b[..., 2])
          - np.maximum(a[..., 0], b[..., 0])).clip(min=0)
    ih = (np.minimum(a[..., 3], b[..., 3])
          - np.maximum(a[..., 1], b[..., 1])).clip(min=0)
    inter = iw * ih
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area(a) + area(b) - inter)


def check_public_results(results, dets_of_image, max_object: int):
    """The tracker reports one item per public detection it was handed
    (matched tracks and births: a frame's first max_object), each over a
    public box of its frame.  A matched track reports its Kalman posterior,
    which lies between its prediction and the box it was matched to, so an
    item's best IoU with the frame's public boxes falls below 0.5 only where
    the association swapped two objects; with seeded random weights the AFE
    similarity is flat and swaps happen (PERF.md, PR 7), so at least
    PUBLIC_IOU_SHARE of the items must reach 0.5 and every item must
    overlap a public box.  Returns (items per frame, the share at IoU >=
    0.5, the least best IoU)."""
    n_items, best = [], []
    for image_id, items in results.items():
        public = dets_of_image[image_id]
        if len(items) != min(len(public), max_object):
            raise AssertionError(f"image {image_id}: {len(items)} items for "
                                 f"{len(public)} public detections")
        n_items.append(len(items))
        if items:
            best += box_iou([it["bbox"] for it in items],
                            [d["bbox"] for d in public]).max(axis=1).tolist()
    share = float(np.mean(np.asarray(best) >= 0.5))
    if share < PUBLIC_IOU_SHARE or min(best) <= 0.0:
        raise AssertionError(f"{share} of the track boxes at IoU >= 0.5 with "
                             f"a public box of their frame, the least at "
                             f"{min(best)}")
    return n_items, share, min(best)


class ModelCalls:
    """Counts the head towers' forwards and ``generic_decode`` calls of a
    model while it is entered."""

    def __init__(self, model):
        self.model = model
        self.heads = self.decodes = 0

    def _head(self, *_):
        self.heads += 1

    def _decode(self, *args, **kwargs):
        self.decodes += 1
        return self._generic_decode(*args, **kwargs)

    def __enter__(self):
        self._hooks = [getattr(self.model, h).register_forward_hook(self._head)
                       for h in self.model.heads]
        self._generic_decode = deft_model.generic_decode
        deft_model.generic_decode = self._decode
        return self

    def __exit__(self, *exc):
        for hk in self._hooks:
            hk.remove()
        deft_model.generic_decode = self._generic_decode


def first_appearance_ids(per_frame):
    """Per frame its track ids, renumbered in order of first appearance
    (two paths draw ids from other allocators)."""
    remap = {}
    return [[remap.setdefault(i, len(remap)) for i in ids]
            for ids in per_frame]


@torch.no_grad()
def embed_parity_check(det, frame):
    """``detect`` under ``parity_tf`` at full width: its embeddings equal
    ``embed_image`` at the parity centres computed on the host within
    1e-4 of max|emb| (``tests/test_public_det.py::test_embed_parity_mode``).
    Returns the row's numbers."""
    images, meta = det.pre_process(frame)
    ptf = parity_tf(meta)
    dets, emb = det.model.detect(images, k=det.cfg.K, parity_tf=ptf)
    _, emb_default = det.model.detect(images, k=det.cfg.K)
    bb = dets["bboxes"][0].cpu().numpy().astype(np.float64)
    cts = np.stack([(bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2],
                   -1) * 4.0                                 # input pixels
    orig = (np.concatenate([cts, np.ones((len(cts), 1))], 1)
            @ ptf[:6].reshape(2, 3).astype(np.float64).T)    # original pixels
    centers = np.stack([2 * orig[:, 0] / meta["width"] - 1,
                        2 * orig[:, 1] / meta["height"] - 1], -1)
    ref = det.model.embed_image(images, torch.as_tensor(
        centers[None], dtype=torch.float32, device=det.device))
    err = (emb - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()
    if not (torch.isfinite(emb).all() and err <= tol):
        raise AssertionError(f"embed_parity: detect vs embed_image at the "
                             f"parity centres {err} > {tol}")
    return {"embed_parity_max_abs_err": err, "embed_parity_tolerance": tol,
            "embed_parity_vs_default_max_abs_diff":
                (emb - emb_default).abs().max().item()}


@torch.no_grad()
def public_phase(cfg=None, device="cuda", layers=LAYERS, n_frames=FRAMES,
                 size=(1080, 1920)):
    """Slice 7's main path: MOT17 public detections
    (``mot_config(public_det=True)``) on the slice's synthetic frames,
    whose rectangles give MOT17-like public detections
    (``public_detections``).  First through ``track_videos_detector`` ->
    ``Detector.run`` (``dcn_impl="hybrid"``), then through ``track_videos``
    -> the ``PipelinedRunner`` at test.py's chunk 1 (``dcn_impl="pallas"``,
    the same weights).  Each path must launch its kernel 16 times per frame
    and no head tower or decode; each frame must report one item per
    public detection, over the frame's public boxes
    (``check_public_results``).  Then ``embed_parity_check`` on one
    frame.  Reports ms/frame, the stage split (host timers and synchronized stages), the
    runner's buckets, the device time per frame and busy share, peak
    memory, and how many frames carry the same ids on the two paths
    (renumbered by first appearance; T2 rounds each DCN input to bf16).
    Returns the launches of the two paths.  ``cfg``, ``device``,
    ``layers``, ``n_frames`` and ``size`` exist for a rehearsal on the
    CPU."""
    cfg = cfg or mot_config(public_det=True)
    frames, boxes = zip(*synthetic_scene(n_frames, *size))
    dets = public_detections(boxes, *size)
    ids = list(range(1, n_frames + 1))
    by_image = dict(zip(ids, dets))
    video = [(1, list(zip(ids, frames)))]
    det, n_dcn, offset_q = prepared_detector(cfg, frames, device, layers)
    on_card = det.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else lambda: None
    launched, per_frame_ids = {}, {}
    for path in ("Detector.run", "PipelinedRunner"):
        if path == "PipelinedRunner":
            rdet = Detector(cfg.replace(dcn_impl="pallas"),
                            det.model.state_dict(), device=device)
            runner = PipelinedRunner(rdet, depth=3, chunk=CHUNK)
            if runner.chunk != 1:
                raise AssertionError(f"public runner at chunk {runner.chunk}")
            runner.track_sequence(frames[:2], [{"cur_dets": d}
                                               for d in dets[:2]])
            rdet.ids = IdAllocator()
            runner.reset()
            model, kernel, impl = rdet.model, "dcn_sample_tap", "pallas"
            drive = lambda: track_videos(runner, video, public_dets=by_image)
        else:
            run_ms = []
            det.run = timed(det.run, sync, run_ms)
            det.timers.reset()
            model, kernel, impl = det.model, "dcn_sample", cfg.dcn_impl
            drive = lambda: track_videos_detector(det, video,
                                                  public_dets=by_image)
        sync()
        resident = None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        with ModelCalls(model) as calls:
            reset_launches()
            t0 = time.perf_counter()
            results = drive()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
            count = launches()
        expected = dict.fromkeys(KERNELS, 0)
        expected[kernel] = n_dcn * n_frames if on_card else 0
        if count != expected:
            raise AssertionError(f"public {path}: kernel launches {count}, "
                                 f"expected {expected}")
        if calls.heads or calls.decodes:
            raise AssertionError(f"public {path}: {calls.heads} head tower "
                                 f"and {calls.decodes} decode calls")
        if sorted(results) != ids:
            raise AssertionError(f"public {path}: {len(results)} frames")
        n_items, iou_share, worst_iou = check_public_results(
            results, by_image, cfg.max_object)
        launched[path] = count[kernel]
        per_frame_ids[path] = [[it["tracking_id"] for it in results[i]]
                               for i in ids]
        row = {"phase": "public", "path": path, "device": str(det.device),
               "config": f"mot_config public_det dla_34 {cfg.dla_node} "
                         f"dcn_impl={impl} {cfg.input_h}x{cfg.input_w} "
                         f"max_object={cfg.max_object}",
               "frames": n_frames, "frame_size": list(size),
               "public_dets_per_frame": [min(len(d) for d in dets),
                                         statistics.median(len(d) for d in dets),
                                         max(len(d) for d in dets)],
               "items_per_frame_median": statistics.median(n_items),
               "share_at_iou_0.5_with_public": iou_share,
               "least_best_iou_with_public": worst_iou,
               "dcn_layers": n_dcn, "launches": count,
               "head_tower_calls": calls.heads, "decode_calls": calls.decodes,
               "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                     if on_card else None),
               "resident_at_start_bytes": resident,
               "offset_abs_q01_q50_q99": offset_q}
        if path == "Detector.run":
            del det.run                     # the class's method again
            row.update({"ms_per_frame_median": statistics.median(run_ms[1:]),
                        "ms_first_frame": run_ms[0],
                        "host_timers_ms": det.timers.mean_ms(),
                        "stage_ms_median": public_stage_times(
                            det, frames[1:6], dets[1:6], sync)})
            if on_card:
                det.reset_tracking()
                dev_ms, top = device_profile(lambda: [
                    det.run(f, {"cur_dets": d})
                    for f, d in zip(frames[6:9], dets[6:9])], 3)
                row.update({"device_ms_per_frame": dev_ms,
                            "busy_share": dev_ms / row["ms_per_frame_median"],
                            "top_kernels_ms_per_frame": top})
            row.update(embed_parity_check(det, frames[0]))
        else:
            row.update({"chunk": runner.chunk, "depth": 3,
                        "sim_window": runner.sim_window,
                        "ms_per_frame": wall_ms / n_frames,
                        "timings_ms_per_frame": runner.timings(),
                        "main_keys": list(runner.main_keys())})
            if on_card:
                runner.reset()
                dev_ms, top = device_profile(lambda: runner.track_sequence(
                    frames[:8], [{"cur_dets": d} for d in dets[:8]]), 8)
                row.update({"device_ms_per_frame": dev_ms,
                            "busy_share": dev_ms / row["ms_per_frame"],
                            "top_kernels_ms_per_frame": top})
            canon = {p: first_appearance_ids(v)
                     for p, v in per_frame_ids.items()}
            same = [a == b for a, b in zip(canon["Detector.run"],
                                           canon["PipelinedRunner"])]
            row.update({"frames_with_detector_run_ids": sum(same),
                        "first_frame_ids_differ": (same.index(False)
                                                   if not all(same) else None)})
        emit(row)
    return launched


def public_stage_times(det, frames, dets, sync) -> dict:
    """A steady public ``Detector.run`` frame by the JAX package's stages
    (pre, net, track): the median ms of each over ``frames``, each stage
    ended by ``sync``."""
    stages = {"pre": [], "net": [], "track": []}
    for frame, d in zip(frames, dets):
        t = [time.perf_counter()]
        images, meta = det.pre_process(frame, {"cur_dets": d})
        sync()
        t.append(time.perf_counter())
        results, emb = det.embed_public(images, meta)
        sync()
        t.append(time.perf_counter())
        det.tracker.update(results, emb)
        sync()
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t[:-1], t[1:]):
            stages[name].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in stages.items()}


# ---- the recipes' test.py line (slice 8) ------------------------------------

CLI_DIR = BUILD_DIR.parent / "cli"
KITTI_CLI_FRAMES = 20          # tracking_val_half.json holds the last 10
CLI_MOT_FRAMES = 30            # the MOT recipe's motion line needs windows
                               # of this sequence's trajectories
NUSCENES_CLI_SAMPLES = 2       # 3 until slice 15's phases
RECIPE_DIRS = {"mot": "mot17", "kitti": "kitti_tracking",
               "nuscenes": "nuscenes"}


def layout_mot(root: Path, n_frames: int, size) -> Path:
    """``synthetic_scene`` as ``mot17/``: ``train/SYN-01/img1/*.png``,
    ``gt/gt.txt`` and ``annotations/val_half.json`` with
    ``gt/gt_val_half.txt`` in ``tools/convert_mot_to_coco.py``'s layout;
    the sequence is its own val half (all ``n_frames`` frames)."""
    data = root / "mot17"
    seq = data / "train" / "SYN-01"
    scene = list(synthetic_scene(n_frames, *size))
    write_pngs((seq / "img1" / f"{f + 1:06d}.png", img)
               for f, (img, _) in enumerate(scene))
    rows = [f"{f + 1},{i + 1},{b[0]:.1f},{b[1]:.1f},{b[2] - b[0]:.1f},"
            f"{b[3] - b[1]:.1f},1,1,1"
            for f, (_, boxes) in enumerate(scene) for i, b in enumerate(boxes)]
    (seq / "gt").mkdir(parents=True, exist_ok=True)
    for name in ("gt.txt", "gt_val_half.txt"):
        (seq / "gt" / name).write_text("\n".join(rows) + "\n")
    images = [{"id": f + 1, "file_name": f"SYN-01/img1/{f + 1:06d}.png",
               "video_id": 1, "frame_id": f + 1, "height": size[0],
               "width": size[1]} for f in range(n_frames)]
    ann = {"images": images, "annotations": [],
           "videos": [{"id": 1, "file_name": "SYN-01"}],
           "categories": [{"id": 1, "name": "pedestrian"}]}
    (data / "annotations").mkdir(parents=True, exist_ok=True)
    (data / "annotations" / "val_half.json").write_text(json.dumps(ann))
    return data


def layout_nuscenes(root: Path, samples: int, size) -> Path:
    """The six-camera rig as ``nuscenes/``: PNG frames under
    ``v1.0-trainval/samples/<camera>/``, ``annotations/val.json`` and the
    rig's ground truth as the v1.0 tables ``tools/eval_nuscenes.py`` reads
    (``synthetic_nuscenes.make_tables``)."""
    data = root / "nuscenes"
    version = data / "v1.0-trainval"
    scene = make_scene(n_samples=samples, cameras=CAMERAS, height=size[0],
                       width=size[1], seed=SEED + 3)
    images = []
    for info, frame in scene:
        name = "samples/" + info["file_name"].replace(".jpg", ".png")
        images.append(dict(info, file_name=name))
        write_pngs([(version / name, frame)])
    for name, rows in make_tables(samples, seed=SEED + 3).items():
        (version / f"{name}.json").write_text(json.dumps(rows))
    ann = {"images": images, "annotations": [],
           "videos": [{"id": 1, "file_name": "scene-0001"}],
           "categories": [{"id": i + 1, "name": n} for i, n in
                          enumerate(NUSCENES_INFO.class_name)]}
    (data / "annotations").mkdir(parents=True, exist_ok=True)
    (data / "annotations" / "val.json").write_text(json.dumps(ann))
    return data


@torch.no_grad()
def recipe_checkpoints(recipe: str, argv, data: Path, out: Path,
                       layers) -> tuple:
    """Seeded float32 weights for the recipe's config (the CLI's parse of
    its line), as the other phases prepare them: offset convs randomized on
    the dataset's first frame, the heatmap raised (every class on KITTI),
    plausible 3-D heads on nuScenes; saved as a reference ``.pth`` under
    ``out``, and the seeded LSTM motion model's beside it where the line
    has ``--load_model_traj`` (used by ``cli_phase`` alone: the recipes
    phase's test lines load the motion model their
    ``train_prediction.py`` line trained).  Returns the flags that name the files, the
    number of DCNv2 layers and {kernel: layers} of the bf16 hybrid
    (``bf16_hybrid_kernel``)."""
    cfg, _ = parse_config(argv)
    cfg = cfg.replace(compute_dtype="float32", load_model="",
                      load_model_traj="")
    ann = {"mot": "val_half.json", "kitti": "tracking_val_half.json",
           "nuscenes": "val.json"}[recipe]
    dataset = get_dataset(cfg.dataset)(cfg, "val", data_dir=str(data))
    info = json.loads((data / "annotations" / ann).read_text())["images"][0]
    frame = imread(os.path.join(dataset.img_dir, info["file_name"]))
    heatmap = raise_class_heatmaps if recipe == "kitti" else raise_heatmap
    det, n_dcn, _ = prepared_detector(cfg, [frame], "cuda", layers, heatmap)
    bf16_layers = Counter(bf16_hybrid_kernel(recipe, m.weight.shape[1])
                          for m in det.model.modules()
                          if isinstance(m, DCNv2))
    if recipe == "nuscenes":
        plausible_3d_heads(det.model)
    # one bf16 detect at the input size, so that the measured runs do not
    # pay the library's first choice of bf16 convolution kernels
    bf16 = create_model(cfg.arch, cfg.replace(compute_dtype="bfloat16"),
                        det.device)
    bf16.load_state_dict(det.model.state_dict())
    bf16.detect(det.pre_process(frame)[0], k=cfg.K)
    del bf16
    out.mkdir(parents=True, exist_ok=True)
    flags = {"load_model": out / "model.pth"}
    torch.save({"epoch": 0, "state_dict": {
        k: v.cpu() for k, v in det.model.state_dict().items()}},
        flags["load_model"])
    if "--load_model_traj" in argv:
        flags["load_model_traj"] = out / "motion.pth"
        motion = motion_lstm.LSTMMotion(cfg.dataset, device="cpu")
        torch.save(motion.model.state_dict(), flags["load_model_traj"])
    return flags, n_dcn, bf16_layers


WRAPPER_KERNELS = {"deform_sample": "dcn_sample",
                   "deform_sample_tap": "dcn_sample_tap",
                   "deform_sample_onehot": "dcn_sample_onehot",
                   "deform_conv_fused": "dcn_fused",
                   "deform_sample_backward": "dcn_backward"}


@contextlib.contextmanager
def sampled_dtypes():
    """Counts (kernel, x dtype) of every kernel launch meanwhile: each
    wrapper asks ``cuda_dcn._on_card`` with x first, and launches where it
    answers True."""
    seen = Counter()
    on_card = cuda_dcn._on_card

    def counted(name, *tensors):
        launching = on_card(name, *tensors)
        if launching:
            seen[(WRAPPER_KERNELS[name],
                  str(tensors[0].dtype).replace("torch.", ""))] += 1
        return launching

    cuda_dcn._on_card = counted
    try:
        yield seen
    finally:
        cuda_dcn._on_card = on_card


def cli_run(argv):
    """``deft_tpu_torch.test.main(argv)`` with its stdout (the evaluators'
    tables) sent to stderr: (metrics, stats, launches, x dtypes, peak
    bytes, resident bytes at the start)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    stats = {}
    reset_launches()
    with sampled_dtypes() as seen, contextlib.redirect_stdout(sys.stderr):
        metrics = port_test.main(argv, stats)
    count = launches()
    return (metrics, stats, count, dict(seen),
            torch.cuda.max_memory_allocated(), resident)


def check_cli_outputs(recipe, argv, metrics, data: Path, empty_ok=False):
    """Every image of the split has a results entry; the results files
    exist (and hold results, unless ``empty_ok``: a network trained a few
    steps from seeded weights may score no detection above the line's
    threshold) and the evaluator scored them."""
    cfg, extras = parse_config(argv)
    ann = {"mot": "val_half.json", "kitti": "tracking_val_half.json",
           "nuscenes": "val.json"}[recipe]
    ids = {str(im["id"]) for im in json.loads(
        (data / "annotations" / ann).read_text())["images"]}
    saved = json.loads((Path(cfg.save_dir)
                        / f"save_results_{cfg.dataset}.json").read_text())
    if set(saved) != ids:
        raise AssertionError(f"{recipe}: results for {len(saved)} of "
                             f"{len(ids)} images")
    if recipe == "nuscenes":
        files = [Path(metrics["submission"])]
        scored = metrics["overall"]["gt"] > 0
    else:
        sub = ("results_mot17halfval" if recipe == "mot"
               else "results_kitti_tracking")
        files = list((Path(cfg.save_dir) / sub).glob("*.txt"))
        scored = metrics["overall"]["num_objects"] > 0
    if not files or not all(empty_ok or f.stat().st_size > 0 for f in files):
        raise AssertionError(f"{recipe}: results files {files}")
    if not scored:
        raise AssertionError(f"{recipe}: the evaluator scored no object")
    return sum(len(v) for v in saved.values())


def bf16_hybrid_kernel(model: str, channels: int) -> str:
    """The kernel of a hybrid DCNv2 layer with ``channels`` input channels
    on a bf16 x (``models/dcn.py``): as the JAX hybrid picks on a TPU,
    ``dcn_sample`` for one sample of at most ``HYBRID_CM_CHANNELS``
    channels, else ``dcn_sample_onehot``.  nuScenes' ``run_multi`` takes a
    sample's six cameras as one batch, which the hybrid routes through the
    onehot function at every layer."""
    if model != "nuscenes" and channels <= HYBRID_CM_CHANNELS:
        return "dcn_sample"
    return "dcn_sample_onehot"


def expected_launches(dtype: str, impl: str, n_dcn: int, bf16_layers: dict,
                      frames: int) -> dict:
    """{(kernel, x dtype): launches} of one recipe run over ``frames``
    (camera) frames: under ``pallas`` every layer through
    ``dcn_sample_tap``; under ``hybrid`` at float32 every layer through
    ``dcn_sample``, at bf16 ``bf16_layers`` {kernel: layers}."""
    if impl == "pallas":
        per_frame = {"dcn_sample_tap": n_dcn}
    elif dtype == "float32":
        per_frame = {"dcn_sample": n_dcn}
    else:
        per_frame = bf16_layers
    return {(k, dtype): n * frames for k, n in per_frame.items()}


def cli_phase():
    """Slice 8's main path: each recipe's ``test.py`` line from
    ``experiments/*.sh`` -- ``--compute_dtype bfloat16`` included -- through
    ``deft_tpu_torch.test.main`` on the card with ``--data_dir``,
    ``--exp_dir`` and the weight files added, on datasets laid out in PNG
    under ``build/cli/`` (30 1080x1920 MOT frames, 10 375x1242 KITTI frames
    in the val half, 2 samples x 6 cameras of 900x1600).  Per recipe and
    dtype (bf16, the line's own, then float32) one unprofiled run, timed
    (wall ms per frame with the image reads, the reads alone, peak memory,
    launches and the dtype of every kernel's x), then the same line under
    ``torch.profiler`` recording the device's activity alone (device kernel
    ms per frame, and the busy share against that run's own wall time);
    then the MOT line at bf16 once more with ``--dcn_impl pallas`` (T2),
    unprofiled.  Asserts, for every run, that every frame has results, the
    results files exist and were scored, and that every DCNv2 layer of
    every frame launched the kernel ``expected_launches`` names on an x of
    the run's dtype.  Returns the launches of the unprofiled bf16 runs per
    (recipe, dcn_impl)."""
    import shutil

    sizes = {"mot": ((1080, 1920), CLI_MOT_FRAMES),
             "kitti": (KITTI_SIZE, KITTI_CLI_FRAMES),
             "nuscenes": ((900, 1600), NUSCENES_CLI_SAMPLES)}
    layers = {"mot": LAYERS, "kitti": KITTI_LAYERS,
              "nuscenes": NUSCENES_LAYERS}
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    data_dir = CLI_DIR / "data"
    data = {"mot": layout_mot(data_dir, sizes["mot"][1], sizes["mot"][0]),
            "kitti": layout_kitti(data_dir, sizes["kitti"][1],
                                  sizes["kitti"][0], SEED + 4),
            "nuscenes": layout_nuscenes(data_dir, sizes["nuscenes"][1],
                                        sizes["nuscenes"][0])}
    emit({"phase": "cli_layout", "seconds": time.perf_counter() - t0,
          "encoder": "deft_tpu_torch.data.image_io.imwrite_png, zlib 1"})
    path_launches = {}
    for recipe in RECIPES:
        base = recipe_test_argv(recipe, data_dir=data_dir,
                                exp_dir=CLI_DIR / "exp", gpus=0,
                                save_results=True)
        files, n_dcn, bf16_layers = recipe_checkpoints(
            recipe, base, data[recipe], CLI_DIR / "weights" / recipe,
            layers[recipe])
        line = with_flags(base, **files)
        runs = [("bfloat16", "hybrid"), ("float32", "hybrid")]
        if recipe == "mot":
            runs.append(("bfloat16", "pallas"))
        for dtype, impl in runs:
            # the line's own dtype first; --dcn_impl only where it changes
            argv = with_flags(line, compute_dtype=dtype)
            if impl != "hybrid":
                argv = with_flags(argv, dcn_impl=impl)

            def checked(out, what):
                metrics, stats, count, seen, _, _ = out
                want = expected_launches(dtype, impl, n_dcn, bf16_layers,
                                         stats["frames"])
                want_count = dict.fromkeys(KERNELS, 0)
                want_count.update({k: n for (k, _), n in want.items()})
                if count != want_count or seen != want:
                    raise AssertionError(
                        f"{recipe} {dtype} {impl} ({what}): launches {count} "
                        f"on x {seen}, expected {want}")
                return check_cli_outputs(recipe, argv, metrics, data[recipe])

            t_run = time.perf_counter()
            out = cli_run(argv)
            t_run = time.perf_counter() - t_run
            metrics, stats, count, seen, peak, resident = out
            items = checked(out, "unprofiled")
            n_frames = stats["frames"]
            ms = stats["seconds"] * 1e3 / n_frames
            overall = metrics["overall"]
            row = {"phase": "cli", "recipe": recipe, "dtype": dtype,
                   "dcn_impl": impl, "argv": argv,
                   "frames": n_frames,
                   "unit": "camera frame" if recipe == "nuscenes" else
                           "frame",
                   "ms_per_frame": ms,
                   "read_ms_per_frame": stats["read_seconds"] * 1e3
                                        / n_frames,
                   "items": items, "launches": count,
                   "main_seconds": t_run,
                   "x_dtype_launches": {f"{k} {d}": n
                                        for (k, d), n in seen.items()},
                   "peak_memory_bytes": peak,
                   "resident_at_start_bytes": resident,
                   "metrics_overall": {k: v for k, v in overall.items()
                                       if isinstance(v, (int, float))}}
            if recipe == "nuscenes":
                row["ms_per_sample"] = ms * CAMERAS
            if impl == "hybrid":
                holder = {}
                device_ms, top = device_profile(
                    lambda: holder.update(out=cli_run(argv)), 1,
                    host_ops=False)
                checked(holder["out"], "profiled")
                prof_stats = holder["out"][1]
                prof_ms = prof_stats["seconds"] * 1e3 / n_frames
                row.update({
                    "profiled_ms_per_frame": prof_ms,
                    "device_ms_per_frame": device_ms / n_frames,
                    "busy_share": device_ms / n_frames / prof_ms,
                    "top_kernels_ms_per_frame": [
                        [round(t / n_frames, 4), c / n_frames, name]
                        for t, c, name in top[:8]]})
            emit(row)
            if dtype == "bfloat16":
                path_launches[(recipe, impl)] = count
    return path_launches


# ---- the recipes' train.py lines (slices 9 and 10) ---------------------------

TRAIN_DIR = BUILD_DIR.parent / "train"
TRAIN_ITERS = CLI_MOT_FRAMES // 4   # one epoch of the cli frames, batch 4
RECIPE_TRAIN_ITERS = 3         # the KITTI and nuScenes train lines
KITTI_TRAIN_FRAMES = 30
NUSCENES_TRAIN_SAMPLES = 20
KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


def write_train_annotations(data: Path) -> Path:
    """``annotations/train.json`` beside ``val_half.json`` of the PNG MOT
    layout (``layout_mot``): every frame of the sequence, its ``gt.txt``
    rectangles as pedestrian annotations with their track ids, in
    ``tools/convert_mot_to_coco.py``'s format; the split that
    ``--dataset_version 17trainval`` trains on."""
    val = json.loads((data / "annotations" / "val_half.json").read_text())
    rows = np.loadtxt(data / "train" / "SYN-01" / "gt" / "gt.txt",
                      delimiter=",", ndmin=2)
    anns = [{"id": i + 1, "image_id": int(r[0]), "category_id": 1,
             "bbox": [float(v) for v in r[2:6]], "area": float(r[4] * r[5]),
             "iscrowd": 0, "track_id": int(r[1]), "conf": 1.0}
            for i, r in enumerate(rows)]
    path = data / "annotations" / "train.json"
    path.write_text(json.dumps(dict(val, annotations=anns)))
    return path


@contextlib.contextmanager
def no_plain_on_card():
    """Every plain version in ``cuda_dcn`` raises meanwhile if it is given
    a CUDA tensor: the run must go through the kernels alone."""
    saved = {n: getattr(cuda_dcn, n) for n in dir(cuda_dcn)
             if n.endswith("_reference")}

    def guarded(name, fn):
        def call(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                raise AssertionError(f"cuda_dcn.{name} ran on the card")
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(cuda_dcn, name, guarded(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_dcn, name, fn)


def train_run(argv):
    """``deft_tpu_torch.train``'s ``main(argv)`` with its stdout sent to
    stderr: (stats, launches, x dtypes, peak bytes, resident bytes at the
    start)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    stats = {}
    reset_launches()
    with no_plain_on_card(), sampled_dtypes() as seen, \
            contextlib.redirect_stdout(sys.stderr):
        port_train.main(argv, stats)
    return (stats, launches(), dict(seen), torch.cuda.max_memory_allocated(),
            resident)


def train_line(recipe: str, argv, per_step: int, steps: int, profile=None
               ) -> dict:
    """One run of a recipe's ``train.py`` line (``train_run``), under
    ``--profile <profile>`` where given.  Asserts ``steps`` steps, per step
    ``per_step`` launches of T4 (bf16) or T1 (float32) and as many of T5 on
    an x of the line's dtype and no other kernel, no plain version on the
    card, finite losses and ``model_last.pth``.  Returns the row: ms/step
    and the loader's wait over the steps after the first, the first apart,
    samples/s, launches, peak memory, the first and last losses, and under
    ``--profile`` the device ms/step and busy share from the second step
    on, over those steps' wall time."""
    dtype = parse_config(argv)[0].compute_dtype or "float32"
    batch = parse_config(argv)[0].batch_size
    if profile is not None:
        argv = with_flags(argv, profile=profile)
    t_run = time.perf_counter()
    stats, count, seen, peak, resident = train_run(argv)
    t_run = time.perf_counter() - t_run
    n = len(stats["step_seconds"])
    sampler = "dcn_sample_onehot" if dtype == "bfloat16" else "dcn_sample"
    want = {key: per_step * n for key in ((sampler, dtype),
                                          ("dcn_backward", dtype))
            if per_step}
    want_count = dict.fromkeys(KERNELS, 0)
    want_count.update({k: v for (k, _), v in want.items()})
    if n != steps or count != want_count or seen != want:
        raise AssertionError(f"{recipe} train {dtype}: {n} steps, launches "
                             f"{count} on x {seen}, expected {want}")
    for when in ("first", "last"):
        if not all(math.isfinite(v) for v in stats[when].values()):
            raise AssertionError(f"{recipe} train {dtype}: {when} losses "
                                 f"{stats[when]}")
    if not Path(stats["checkpoint"]).is_file():
        raise AssertionError(f"{recipe} train {dtype}: no "
                             f"{stats['checkpoint']}")
    warm = stats["step_seconds"][1:]
    wait = stats["wait_seconds"][1:]
    row = {"phase": "train", "recipe": recipe, "dtype": dtype,
           "argv": argv, "steps": n, "batch": batch,
           "ms_per_step": statistics.mean(warm) * 1e3,
           "median_ms_per_step": statistics.median(warm) * 1e3,
           "first_step_ms": stats["step_seconds"][0] * 1e3,
           "first_step_wait_ms": stats["wait_seconds"][0] * 1e3,
           "samples_per_s": batch / statistics.mean(warm),
           "loader_wait_ms_per_step": statistics.mean(wait) * 1e3,
           "launches": count,
           "launches_per_step": {k: v // n for k, v in count.items() if v},
           "x_dtype_launches": {f"{k} {d}": v for (k, d), v in seen.items()},
           "peak_memory_bytes": peak, "resident_at_start_bytes": resident,
           "main_seconds": t_run,
           "loss_first": stats["first"], "loss_last": stats["last"]}
    if profile is not None:
        psteps = stats["profiled_steps"]
        wall_ms = sum(stats["step_seconds"][-psteps:]) * 1e3
        row.update({"profiled": True, "profiled_steps": psteps,
                    "device_ms_per_step": stats["device_ms"] / psteps,
                    "busy_share": stats["device_ms"] / wall_ms,
                    "profile_trace": str(Path(profile) / "trace.json")})
    return row


def train_phase(data: Path) -> dict:
    """Slice 9's main path: the MOT recipe's ``train.py`` line of
    ``experiments/mot17_tracking.sh`` verbatim (``--compute_dtype
    bfloat16``, batch 4 at 544x960, DLA-34 with the hybrid DCNv2 neck,
    ``--num_workers`` 4 by default) through ``python -m
    deft_tpu_torch.train``'s ``main``, with ``--data_dir``, ``--exp_dir
    exp`` (in ``build/train/``), ``--num_epochs 1``, ``--num_iters 7``
    and ``--load_model`` naming seeded weights whose offset convs are
    randomized as the other phases do (``recipe_checkpoints``), on the
    ``cli_phase`` PNG frames with a ``train.json`` (``write_train_
    annotations``): first at float32, then as the line stands, at bf16,
    under ``--profile`` (device activity from the second step on, over
    those steps' wall time).  Each run is held by ``train_line`` (per
    step 128 launches, 16 layers x 4 samples x the image and the
    pre_image, of T4 or T1 and of T5).  ``recipes_phase`` then runs the
    recipe's other lines on the ``model_last`` the bf16 run wrote.
    Returns the launches of the runs per dtype."""
    import shutil

    write_train_annotations(data)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    (train_argv,) = [a for (r, script, _), a in recipe_lines().items()
                     if r == "mot" and script == "train.py"]
    files, n_dcn, _ = recipe_checkpoints(
        "mot", recipe_test_argv("mot", data_dir=data.parent,
                                exp_dir=TRAIN_DIR / "seed", gpus=0),
        data, TRAIN_DIR / "weights", LAYERS)
    per_step = n_dcn * parse_config(train_argv)[0].batch_size * 2
    cwd = os.getcwd()
    os.chdir(TRAIN_DIR)   # the test line names exp/tracking/mot17_train/...
    launched = {}
    try:
        line = with_flags(train_argv, data_dir=data.parent, exp_dir="exp",
                          num_epochs=1, num_iters=TRAIN_ITERS,
                          load_model=files["load_model"])
        for dtype in ("float32", "bfloat16"):
            row = train_line("mot", with_flags(line, compute_dtype=dtype),
                             per_step, TRAIN_ITERS,
                             profile=(TRAIN_DIR / "profile" / "mot"
                                      if dtype == "bfloat16" else None))
            emit(row)
            launched[dtype] = row["launches"]
    finally:
        os.chdir(cwd)
    return launched


@contextlib.contextmanager
def motion_models():
    """Every ``LSTMMotion`` built meanwhile, in a list."""
    built = []
    init = motion_lstm.LSTMMotion.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    motion_lstm.LSTMMotion.__init__ = recorded
    try:
        yield built
    finally:
        motion_lstm.LSTMMotion.__init__ = init


def prediction_line(recipe: str, argv) -> dict:
    """The recipe's ``train_prediction.py`` line through ``python -m
    deft_tpu_torch.train_prediction``'s ``main`` on the card.  Asserts
    finite losses, one step per trajectory of the dataset but the ones too
    short to train on, and a ``model_last.pth`` that loads strictly into a
    ``DecoderRNN``.  Returns its row: ms/step (the sample's construction
    included) and trajectories/s over the steps after the first."""
    stats = {}
    t_run = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        port_train_prediction.main(argv, stats)
    t_run = time.perf_counter() - t_run
    steps = len(stats["losses"])
    if steps + stats["skipped"] != stats["trajectories"] or steps < 2:
        raise AssertionError(f"{recipe} motion model: {steps} steps, "
                             f"{stats['skipped']} skipped of "
                             f"{stats['trajectories']}")
    if not all(math.isfinite(v) for v in stats["losses"]):
        raise AssertionError(f"{recipe} motion model: losses "
                             f"{stats['losses']}")
    blob = torch.load(stats["checkpoint"], map_location="cpu",
                      weights_only=True)
    dataset = parse_config(argv)[0].dataset
    motion_lstm.DecoderRNN(dataset).load_state_dict(blob["state_dict"])
    warm = stats["step_seconds"][1:]
    return {"phase": "train_prediction", "recipe": recipe, "argv": argv,
            "trajectories": stats["trajectories"], "steps": steps,
            "skipped": stats["skipped"],
            "ms_per_step": statistics.mean(warm) * 1e3,
            "median_ms_per_step": statistics.median(warm) * 1e3,
            "first_step_ms": stats["step_seconds"][0] * 1e3,
            "trajectories_per_s": 1.0 / statistics.mean(warm),
            "lengths": dict(sorted(Counter(stats["lengths"]).items())),
            "loss_first": stats["losses"][0],
            "loss_last": stats["losses"][-1],
            "main_seconds": t_run, "checkpoint": stats["checkpoint"]}


def recipes_phase(data_dir: Path) -> dict:
    """Slice 10's main path: every line of the three recipes, in the order
    of ``experiments/*.sh``, each on the files the line before it wrote,
    from ``build/train/`` (its ``data/`` holds the train layouts, its
    ``exp/`` what the lines write):

    * the ``train.py`` line: MOT's ran in ``train_phase``; KITTI's and
      nuScenes' run here verbatim plus ``--data_dir``, ``--exp_dir exp``,
      ``--num_epochs 1 --num_iters 4``, ``--load_model`` of seeded weights
      (``recipe_checkpoints`` on the ``cli_phase`` layouts) and
      ``--profile``, at the line's bf16, on 30 PNG KITTI frames of
      375x1242 with cars, pedestrians and cyclists (``layout_kitti``) and
      20 samples x 6 cameras of 900x1600 (``layout_nuscenes_train``,
      converted by the port's ``convert_nuscenes``); ``train_line`` holds
      each (128 T4 and 128 T5 per step);
    * the ``train_prediction.py`` line verbatim plus ``--num_epochs 1``
      (``prediction_line``), reading ``data/<dataset>/...`` under the
      working directory (MOT: the ``cli_phase`` frames' ``train.json``);
    * the ``test.py`` line verbatim plus ``--data_dir`` of the
      ``cli_phase`` layouts, on the ``model_last`` files the two lines
      before it wrote: every frame has a results entry and the results
      files are scored (they may hold no track: 4 steps from seeded
      weights leave few detections above the threshold); on nuScenes every
      ``LSTMMotion`` built holds the trained motion file's weights bit for
      bit and the LSTM stepped tracks.

    Returns {(recipe, script): launches}."""
    cwd = os.getcwd()
    os.chdir(TRAIN_DIR)
    launched = {}
    try:
        t0 = time.perf_counter()
        train_data = TRAIN_DIR / "data"
        train_data.mkdir(exist_ok=True)
        if not (train_data / "mot17").exists():
            (train_data / "mot17").symlink_to(data_dir / "mot17")
        layout_kitti(train_data, KITTI_TRAIN_FRAMES, KITTI_SIZE, SEED + 6,
                     classes=KITTI_CLASSES)
        layout_nuscenes_train(train_data, NUSCENES_TRAIN_SAMPLES, (900, 1600),
                              SEED + 7)
        emit({"phase": "recipes_layout",
              "seconds": time.perf_counter() - t0,
              "kitti_frames": KITTI_TRAIN_FRAMES,
              "nuscenes_samples": NUSCENES_TRAIN_SAMPLES,
              "cameras": CAMERAS})
        layers = {"kitti": KITTI_LAYERS, "nuscenes": NUSCENES_LAYERS}
        lines = recipe_lines()
        for recipe in RECIPES:
            argv = {script: a for (r, script, _), a in lines.items()
                    if r == recipe}
            if recipe != "mot":
                files, n_dcn, _ = recipe_checkpoints(
                    recipe, recipe_test_argv(
                        recipe, data_dir=data_dir,
                        exp_dir=TRAIN_DIR / "seed", gpus=0),
                    data_dir / RECIPE_DIRS[recipe],
                    TRAIN_DIR / "weights" / recipe, layers[recipe])
                line = with_flags(argv["train.py"], data_dir=train_data,
                                  exp_dir="exp", num_epochs=1,
                                  num_iters=RECIPE_TRAIN_ITERS,
                                  load_model=files["load_model"])
                per_step = n_dcn * parse_config(line)[0].batch_size * 2
                row = train_line(recipe, line, per_step, RECIPE_TRAIN_ITERS,
                                 profile=TRAIN_DIR / "profile" / recipe)
                emit(row)
                launched[(recipe, "train.py")] = row["launches"]
            row = prediction_line(recipe, with_flags(
                argv["train_prediction.py"], num_epochs=1))
            emit(row)
            motion_file = row["checkpoint"]
            test_argv = with_flags(argv["test.py"], data_dir=data_dir,
                                   save_results=True)
            motion_lstm.BATCHES = 0
            with motion_models() as built:
                metrics, tstats, count, _, _, _ = cli_run(test_argv)
            items = check_cli_outputs(recipe, test_argv, metrics,
                                      data_dir / RECIPE_DIRS[recipe],
                                      empty_ok=True)
            test_row = {"phase": "recipe_test", "recipe": recipe,
                        "argv": test_argv, "frames": tstats["frames"],
                        "items": items, "launches": count,
                        "ms_per_frame": tstats["seconds"] * 1e3
                                        / tstats["frames"],
                        "metrics_overall": {
                            k: v for k, v in metrics["overall"].items()
                            if isinstance(v, (int, float))}}
            if recipe == "nuscenes":
                trained = torch.load(motion_file, map_location="cpu",
                                     weights_only=True)["state_dict"]
                if not built or motion_lstm.BATCHES == 0:
                    raise AssertionError(
                        f"nuScenes test line: {len(built)} motion models, "
                        f"{motion_lstm.BATCHES} LSTM steps")
                for motion in built:
                    for k, v in motion.model.state_dict().items():
                        if not torch.equal(v.cpu(), trained[k]):
                            raise AssertionError(
                                f"nuScenes test line: the motion model's {k} "
                                f"is not {motion_file}'s")
                test_row.update({"motion_models": len(built),
                                 "lstm_batches": motion_lstm.BATCHES,
                                 "motion_file": motion_file})
            emit(test_row)
            launched[(recipe, "test.py")] = count
    finally:
        os.chdir(cwd)
    return launched


# ---- test-time geometry and data-parallel training (slice 12) ---------------

GEOMETRY_FRAMES = 4            # 10, then 6 until slice 15's phases
# the DCNv2 layers of a 375x1242 KITTI frame under keep_res (384x1248) and
# of a 1080x1920 MOT frame under --fix_short 544 (544x1024)
KITTI_KEEP_RES_LAYERS = [
    (96, 312, 64, 64, 5),
    (48, 156, 128, 64, 4),
    (48, 156, 128, 128, 2),
    (24, 78, 256, 128, 2),
    (24, 78, 256, 256, 1),
    (24, 78, 256, 64, 1),
    (12, 39, 512, 256, 1),
]
MOT_FIX_SHORT_LAYERS = [
    (136, 256, 64, 64, 5),
    (68, 128, 128, 64, 4),
    (68, 128, 128, 128, 2),
    (34, 64, 256, 128, 2),
    (34, 64, 256, 256, 1),
    (34, 64, 256, 64, 1),
    (17, 32, 512, 256, 1),
]
DDP_ITERS = 3
LOSS_RTOL = 1e-4               # tests/test_torch_port_train_step.py's


def counted_detections(det, tracked_class=None):
    """``det.post_process`` wrapped so that each call's detections of the
    tracked class (every class without one) are counted into the list
    returned: the detections that reach the tracker (the runner cuts them
    at its valid count, which the threshold already sets)."""
    counts = []
    post_process = det.post_process

    def counted(dets, meta):
        results = post_process(dets, meta)
        counts.append(sum(tracked_class is None or d["class"] == tracked_class
                          for d in results))
        return results

    det.post_process = counted
    return counts


def geometry_run(name, det, frames, per_frame, kernel, dtype, chunk=None,
                 tracked_class=None, min_dets=1):
    """One path of the geometry phase over ``frames``: ``Detector.run``
    (``chunk`` None) or a ``PipelinedRunner`` at ``chunk``.  Asserts
    ``per_frame`` launches of ``kernel`` on an x of ``dtype`` per
    dispatched frame and no other kernel, finite tracks and at least
    ``min_dets`` detections to the tracker per frame (median); returns its
    row: wall ms/frame (the frames after the first; a runner's whole
    sequence over its frames), device ms/frame over three more frames of
    the same path under ``torch.profiler``, launches per frame and the
    detections to the tracker."""
    sync = torch.cuda.synchronize
    counts = counted_detections(det, tracked_class)
    if chunk is None:
        run_ms = []
        step = timed(det.run, sync, run_ms)
        sync()
        reset_launches()
        with sampled_dtypes() as seen:
            seq = [step(frame) for frame in frames]
        count = launches()
        ms = statistics.median(run_ms[1:])
        dispatched = len(frames)

        def again():
            for frame in frames[1:4]:
                det.run(frame)
    else:
        runner = PipelinedRunner(det, depth=3, chunk=chunk)
        runner.track_sequence(frames[: 2 * chunk])          # warm up
        runner.reset()
        counts.clear()
        sync()
        reset_launches()
        t0 = time.perf_counter()
        with sampled_dtypes() as seen:
            seq = runner.track_sequence(frames)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        count = launches()
        dispatched = math.ceil(len(frames) / chunk) * chunk

        def again():
            runner.reset()
            runner.track_sequence(frames[:3])
    expected = dict.fromkeys(KERNELS, 0)
    expected[kernel] = per_frame * dispatched
    if count != expected or dict(seen) != {(kernel, dtype): expected[kernel]}:
        raise AssertionError(f"geometry {name}: launches {count} on x "
                             f"{dict(seen)}, expected {expected} on {dtype}")
    n_dets = check_tracks(seq, 0)
    tracked = counts[: len(frames)]
    if statistics.median(tracked) < min_dets:
        raise AssertionError(f"geometry {name}: detections to the tracker "
                             f"{tracked}")
    device_ms, _ = device_profile(again, 3)
    cfg = det.cfg
    return {"phase": "geometry", "path": name,
            "config": f"{cfg.dataset} {cfg.input_h}x{cfg.input_w} "
                      f"dcn_impl={cfg.dcn_impl} dtype={dtype} flip_test="
                      f"{cfg.flip_test} keep_res={cfg.keep_res} fix_short="
                      f"{cfg.fix_short}",
            "frames": len(frames), "frame_size": list(frames[0].shape[:2]),
            "frames_dispatched": dispatched,
            "ms_per_frame": ms, "device_ms_per_frame": device_ms,
            "launches": count, "launches_per_dispatched_frame":
                {k: v / dispatched for k, v in count.items() if v},
            "detections_to_tracker_per_frame": tracked,
            "tracks_per_frame_median": statistics.median(n_dets)}


GEOMETRY_SAMPLES = 3


@torch.no_grad()
def geometry_nuscenes_run():
    """The nuScenes rig under ``flip_test`` through ``track_nuscenes`` ->
    ``Detector.run_multi`` on 3 samples of six 900x1600 cameras: each
    sample's trunk runs at batch 12 (the cameras and their mirrors), T1 on
    every sample of every layer at float32, 192 per sample.  Asserts the
    launches and finite tracks with global boxes; returns the phase's row
    (ms per sample after the first, device ms per sample over one more
    under ``torch.profiler``)."""
    cfg = nuscenes_config(flip_test=True)
    scene = make_scene(n_samples=GEOMETRY_SAMPLES, cameras=CAMERAS,
                       height=900, width=1600, seed=SEED + 3)
    det = Detector(cfg)
    info0, frame0 = scene[0]
    first, _ = det.pre_process(frame0, {"calib": info0["calib"]})
    _, shapes = randomize_offsets(det.model,
                                  first, torch.Generator().manual_seed(SEED))
    n_dcn = sum(shapes.values())
    raise_heatmap(det.model, first)
    plausible_3d_heads(det.model)
    run_ms = []
    run_multi = det.run_multi
    det.run_multi = timed(run_multi, torch.cuda.synchronize, run_ms)
    torch.cuda.synchronize()
    reset_launches()
    with sampled_dtypes() as seen:
        results = track_nuscenes(det, [(1, scene)])
    count = launches()
    per_sample = 2 * CAMERAS * n_dcn
    expected = dict.fromkeys(KERNELS, 0)
    expected["dcn_sample"] = per_sample * GEOMETRY_SAMPLES
    if (count != expected or dict(seen) != {("dcn_sample", "float32"):
                                            expected["dcn_sample"]}):
        raise AssertionError(f"geometry nuScenes flip: launches {count} on x "
                             f"{dict(seen)}, expected {expected}")
    items = [item for v in results.values() for item in v]
    for item in items:
        box = item["translation"] + item["size"] + item["rotation"]
        if not np.isfinite(box).all():
            raise AssertionError(f"non-finite track box {item}")
    if not items:
        raise AssertionError("geometry nuScenes flip: no tracks")
    frames = [frame for _, frame in scene[:CAMERAS]]
    metas = [{"calib": info["calib"]} for info, _ in scene[:CAMERAS]]
    infos = [info for info, _ in scene[:CAMERAS]]
    device_ms, _ = device_profile(
        lambda: run_multi(frames, metas, infos), 1)
    return {"phase": "geometry", "path": "Detector.run_multi nuScenes "
                                          "flip_test float32",
            "config": f"nuscenes {cfg.input_h}x{cfg.input_w} dcn_impl="
                      f"{cfg.dcn_impl} dtype=float32 flip_test=True",
            "samples": GEOMETRY_SAMPLES, "cameras": CAMERAS,
            "frame_size": list(frame0.shape[:2]),
            "ms_per_sample": statistics.median(run_ms[1:]),
            "device_ms_per_sample": device_ms, "launches": count,
            "launches_per_sample": {k: v / GEOMETRY_SAMPLES
                                    for k, v in count.items() if v},
            "tracks_per_camera_frame": len(items) / len(scene)}


@torch.no_grad()
def geometry_phase():
    """Slice 12's paths at full width on the card (PERF.md §4): the MOT
    slice on 10 synthetic 1080x1920 frames through ``Detector.run`` under
    ``flip_test`` (``dcn_impl="hybrid"``: float32, T1 on each of the 2
    samples of every layer, 32 per frame; bf16, T4 on all 32, as the JAX
    hybrid sends a batch to ``deform_conv_onehot``), through the runner
    under ``flip_test`` (``dcn_impl="pallas"``, chunk 4: T2, 32 per
    dispatched frame), and under ``--fix_short 544`` (544x1024, T1 16 per
    frame); KITTI on 10 numpy 375x1242 frames under ``keep_res``
    (384x1248) through ``Detector.run`` (T1, 16) and the runner at chunk 1
    (host warp, T2, 16).  Each path is held by ``geometry_run``.  Then the
    nuScenes rig under ``flip_test`` (``geometry_nuscenes_run``: T1, 192
    per sample).  Returns the rows and the launches per kernel of all the
    paths."""
    gen_frames = list(synthetic_frames(GEOMETRY_FRAMES))
    total = Counter()
    rows = []
    cfg = mot_config(flip_test=True)
    det, n_dcn, _ = prepared_detector(cfg, gen_frames, "cuda", LAYERS)
    weights = det.model.state_dict()
    rows.append(geometry_run("Detector.run MOT flip_test float32", det,
                             gen_frames, 2 * n_dcn, "dcn_sample",
                             "float32"))
    del det
    det = Detector(cfg.replace(compute_dtype="bfloat16"), weights)
    rows.append(geometry_run("Detector.run MOT flip_test bf16", det,
                             gen_frames, 2 * n_dcn, "dcn_sample_onehot",
                             "bfloat16"))
    del det
    det = Detector(cfg.replace(dcn_impl="pallas"), weights)
    rows.append(geometry_run(f"PipelinedRunner chunk {CHUNK} MOT flip_test",
                             det, gen_frames, 2 * n_dcn, "dcn_sample_tap",
                             "float32", chunk=CHUNK))
    del det
    det, n_dcn, _ = prepared_detector(mot_config(fix_short=544), gen_frames,
                                      "cuda", MOT_FIX_SHORT_LAYERS)
    rows.append(geometry_run("Detector.run MOT fix_short 544", det,
                             gen_frames, n_dcn, "dcn_sample", "float32"))
    del det, gen_frames
    kitti_frames, _ = make_sequence(n_frames=GEOMETRY_FRAMES,
                                    height=KITTI_SIZE[0],
                                    width=KITTI_SIZE[1], seed=SEED + 4)
    cfg = kitti_config(keep_res=True)
    det, n_dcn, _ = prepared_detector(cfg, kitti_frames, "cuda",
                                      KITTI_KEEP_RES_LAYERS,
                                      raise_class_heatmaps)
    weights = det.model.state_dict()
    rows.append(geometry_run("Detector.run KITTI keep_res", det,
                             kitti_frames, n_dcn, "dcn_sample", "float32",
                             tracked_class=CAR))
    del det
    det = Detector(cfg.replace(dcn_impl="pallas"), weights)
    rows.append(geometry_run("PipelinedRunner chunk 1 KITTI keep_res", det,
                             kitti_frames, n_dcn, "dcn_sample_tap",
                             "float32", chunk=1, tracked_class=CAR))
    del det, kitti_frames
    rows.append(geometry_nuscenes_run())
    for row in rows:
        emit(row)
        total.update(row["launches"])
    return rows, total


def ddp_phase(data: Path) -> dict:
    """Slice 12's training path: the MOT recipe's ``train.py`` line
    (bf16, batch 4 at 544x960, ``--num_workers 0`` so that the batches are
    a function of the seed, ``--num_iters 3``, the train phase's seeded
    ``--load_model``) once through ``deft_tpu_torch.train``'s one-process
    ``main`` and once through ``train_rank(0, 1, "nccl", ...)``, rank 0 of
    an NCCL group of world size 1 on the card.  Asserts the group's
    backend, the first step's losses within 1e-4 relative of the
    one-process line's, 128 T4 and 128 T5 launches per step, and that
    rank 0 wrote ``model_last.pth``.  Returns the launches of the NCCL
    run."""
    (train_argv,) = [a for (r, script, _), a in recipe_lines().items()
                     if r == "mot" and script == "train.py"]
    weights = TRAIN_DIR / "weights" / "model.pth"
    n_dcn = sum(layer[4] for layer in LAYERS)
    per_step = n_dcn * parse_config(train_argv)[0].batch_size * 2
    cwd = os.getcwd()
    os.chdir(TRAIN_DIR)
    rows = {}
    try:
        for run in ("one process", "nccl world 1"):
            line = with_flags(train_argv, data_dir=data.parent,
                              exp_dir=f"exp_ddp/{run.split()[0]}",
                              num_epochs=1, num_iters=DDP_ITERS,
                              num_workers=0, load_model=weights)
            if run == "one process":
                rows[run] = train_line("mot", line, per_step, DDP_ITERS)
                continue
            gc.collect()
            torch.cuda.empty_cache()
            stats = {}
            reset_launches()
            t_run = time.perf_counter()
            with no_plain_on_card(), sampled_dtypes() as seen, \
                    contextlib.redirect_stdout(sys.stderr):
                port_train.train_rank(0, 1, "nccl", line, stats)
            t_run = time.perf_counter() - t_run
            count = launches()
            n = len(stats["step_seconds"])
            want = {("dcn_sample_onehot", "bfloat16"): per_step * n,
                    ("dcn_backward", "bfloat16"): per_step * n}
            if (n != DDP_ITERS or dict(seen) != want
                    or stats["backend"] != "nccl" or stats["world"] != 1):
                raise AssertionError(
                    f"ddp: {n} steps on {stats.get('backend')} world "
                    f"{stats.get('world')}, launches {dict(seen)}")
            if not Path(stats["checkpoint"]).is_file():
                raise AssertionError(f"ddp: rank 0 wrote no "
                                     f"{stats['checkpoint']}")
            rows[run] = {"phase": "train", "recipe": "mot",
                         "dtype": "bfloat16", "argv": line, "steps": n,
                         "ms_per_step": statistics.mean(
                             stats["step_seconds"][1:]) * 1e3,
                         "first_step_ms": stats["step_seconds"][0] * 1e3,
                         "launches": count, "main_seconds": t_run,
                         "loss_first": stats["first"],
                         "loss_last": stats["last"]}
    finally:
        os.chdir(cwd)
    one, nccl = rows["one process"], rows["nccl world 1"]
    rel = {k: abs(nccl["loss_first"][k] - v) / max(abs(v), 1.0)
           for k, v in one["loss_first"].items()}
    if max(rel.values()) > LOSS_RTOL:
        raise AssertionError(f"ddp: first-step losses {nccl['loss_first']} "
                             f"against one process {one['loss_first']}")
    emit({"phase": "ddp", "backend": "nccl", "world": 1,
          "argv": nccl["argv"], "steps": DDP_ITERS,
          "ms_per_step": nccl["ms_per_step"],
          "one_process_ms_per_step": one["ms_per_step"],
          "first_step_ms": nccl["first_step_ms"],
          "one_process_first_step_ms": one["first_step_ms"],
          "first_step_loss_max_rel_diff": max(rel.values()),
          "loss_first": nccl["loss_first"], "launches": nccl["launches"],
          "checkpoint_written_by_rank_0": True})
    return nccl["launches"]


def per_frame_sums(rows, dtype="float32"):
    """Per-frame sums over the layers of ``rows`` ('trained' offsets, x in
    ``dtype``)."""
    per_frame = [r for r in rows if r["regime"] == "trained"
                 and r["dtype"] == dtype]
    return {key: sum(r[key] * r["count"] for r in per_frame)
            for key in ("kernel_ms", "plain_ms", "library_ms",
                        "bound_bytes_ms", "bound_operations_ms",
                        "bound_operations_ffma_ms")}


def sums_entry(sums):
    """Per-frame (or per-camera) sums as a kernel entry's numbers."""
    return {"ms": sums["kernel_ms"], "plain_ms": sums["plain_ms"],
            "library_ms": sums["library_ms"],
            "bound_ms": max(sums["bound_bytes_ms"],
                            sums["bound_operations_ms"]),
            "bound_by": ("bytes" if sums["bound_bytes_ms"]
                         >= sums["bound_operations_ms"] else "operations")}


# ---- the bench entry point (python -m deft_tpu_torch.bench) ----------------

REPO = Path(__file__).resolve().parent
BENCH_DIR = BUILD_DIR.parent / "bench"
BENCH_PASSES = 3               # the bench's timed passes
# (run, its flags): the MOT17 path at chunk 4, depth 2, with the C++ lapjv
# (frames cut to the phase's time, the float32 run's from 30 to 16 for
# slice 15's phases: the float32 run's cascade and the host
# warp of the wire encodings take 120-260 ms per frame on the NVIDIA H100
# 80GB HBM3 machine at 700 W, PERF.md §6)
BENCH_RUNS = (
    ("bf16", ("--frames", "60", "--warmup", "8")),
    ("fp32", ("--frames", "16", "--warmup", "8", "--fp32")),
    ("yuv", ("--frames", "8", "--warmup", "4", "--yuv", "--profile",
             str(BENCH_DIR / "profile"))),
    ("delta", ("--frames", "8", "--warmup", "4", "--delta")),
)
# launches per dispatched frame: the bf16 hybrid takes T1 on the 11 layers
# of <= 128 input channels and T4 on the other 5; float32 T1 on all 16
BENCH_PER_FRAME = {"bfloat16": {"dcn_sample": 11, "dcn_sample_onehot": 5},
                   "float32": {"dcn_sample": 16}}
BENCH_CHECK_FRAMES = 12        # the delta-vs-host-warp check on the card
BENCH_LOADER_SAMPLES = 8       # per loader pass of bench_loader
DECODE_TOL = 1e-5


def module_run(module: str, args, timeout: int = 600):
    """``python -m module args`` in a process of its own from the
    repository root, with ``DEFT_USE_NATIVE=1``: (stdout, stderr, seconds).
    A non-zero exit raises with the tail of its stderr."""
    env = dict(os.environ, DEFT_USE_NATIVE="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"python -m {module} {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-6000:]}")
    return proc.stdout, proc.stderr, time.perf_counter() - t0


def bench_run(name: str, args) -> dict:
    """One bench process: its JSON line, the launches of its timed passes
    against ``BENCH_PER_FRAME`` per dispatched frame, and the C++ lapjv
    calls of its cascade."""
    out, err, seconds = module_run("deft_tpu_torch.bench", args)
    line = json.loads(out.strip().splitlines()[-1])
    notes = [x for x in err.splitlines() if x.startswith("#")]
    launch_line = next(x for x in notes if x.startswith("# launches"))
    launches = json.loads(launch_line.split(": ", 1)[1])
    lapjv = int(next(x for x in notes if x.startswith("# native lapjv"))
                .split(": ", 1)[1].split()[0])
    frames = int(args[args.index("--frames") + 1])
    dispatched = BENCH_PASSES * math.ceil(frames / CHUNK) * CHUNK
    dtype = "float32" if "--fp32" in args else "bfloat16"
    want = {k: BENCH_PER_FRAME[dtype].get(k, 0) * dispatched
            for k in launches}
    if launches != want:
        raise AssertionError(f"bench {name}: launches {launches}, expected "
                             f"{want} ({dispatched} dispatched frames)")
    if lapjv <= 0:
        raise AssertionError(f"bench {name}: no C++ lapjv call")
    missing = {"device_ms", "wire_rtt_ms", "wire_frame_up_ms",
               "wire_chunk_up_ms", "e2e_ms_per_frame"} - set(line)
    if torch.cuda.get_device_name(0) in bench.PEAKS:
        missing |= {"mfu"} - set(line)
    if missing:
        raise AssertionError(f"bench {name}: no {sorted(missing)} in {line}")
    print(json.dumps(line), flush=True)
    row = {"phase": "bench", "run": name, "args": list(args),
           "seconds": seconds, "dtype": dtype,
           "dispatched_frames": dispatched, "launches": launches,
           "lapjv_calls": lapjv, "line": line, "notes": notes}
    emit(row)
    return row


def relabel_ids(seq):
    """Track ids as their order of first appearance."""
    order = {}
    return [[order.setdefault(t.track_id, len(order)) for t in fr]
            for fr in seq]


@torch.no_grad()
def bench_device_checks(device="cuda", cfg=None, size=(1080, 1920)) -> dict:
    """On the card: ``_decode_input`` of a packed input-size frame against
    the CPU's to DECODE_TOL, and the delta-upload runner's tracks against a
    host-warp run's without it (the bench's config, chunk 4): equal bit for
    bit, the same programs on the same frames."""
    cfg = cfg or mot_config(track_thresh=1e-3, compute_dtype="bfloat16",
                            sims_quant=True)
    frames = [bench.make_synthetic_frame(t, *size)
              for t in range(BENCH_CHECK_FRAMES)]
    model = create_model(cfg.arch, cfg, device)
    packed = torch.from_numpy(np.stack([pack_yuv420(
        bench.make_synthetic_frame(t, cfg.input_h, cfg.input_w))
        for t in range(2)]))
    got = model._decode_input(packed.to(device), True).cpu()
    want = model.cpu()._decode_input(packed, True)
    decode_err = float((got - want).abs().max())
    if decode_err > DECODE_TOL:
        raise AssertionError(f"_decode_input on the card differs from the "
                             f"CPU's by {decode_err}")
    delta = Detector(cfg.replace(delta_upload=True), device=device)
    plain = Detector(cfg, delta.model.state_dict(), device=device)
    runs = {}
    for name, det in (("delta", delta), ("host_warp", plain)):
        runner = PipelinedRunner(det, depth=2, chunk=CHUNK)
        runner.host_warp = True
        runs[name] = runner.track_sequence(frames)
    same_ids = relabel_ids(runs["delta"]) == relabel_ids(runs["host_warp"])
    same_boxes = same_ids and all(
        np.array_equal(a.tlbr, b.tlbr)
        for fa, fb in zip(runs["delta"], runs["host_warp"])
        for a, b in zip(fa, fb))
    if not same_boxes:
        raise AssertionError("the delta-upload runner's tracks differ from "
                             "the host-warp run's on the card")
    row = {"phase": "bench_checks", "decode_max_abs_err": decode_err,
           "decode_tol": DECODE_TOL, "delta_frames": BENCH_CHECK_FRAMES,
           "delta_tracks": sum(len(f) for f in runs["delta"]),
           "delta_equals_host_warp": True}
    emit(row)
    return row


def bench_tools(data: Path, checkpoint: Path, profiled_frames: int) -> dict:
    """The measuring tools of the slice, each in a process of its own:
    ``bench_loader`` on the cli phase's MOT layout (``train.json``, 30
    frames of 1080x1920 PNG) at batch 4 (BENCH_LOADER_SAMPLES per pass),
    ``measure_dcn_offsets`` on the checkpoint phase's seeded ``.pth`` (its
    radii a valid ``--dcn_layer_radii``), ``trace_device_ms`` on the
    profiled bench run's trace."""
    from deft_tpu_torch.models.factory import parse_layer_radii

    out, err, secs = module_run("deft_tpu_torch.tools.bench_loader", [
        "--batch", "4", "--steps", "4", "--workers", "0,4", "--frames",
        str(BENCH_LOADER_SAMPLES), "--data_dir", str(data)])
    loader = json.loads(out.strip().splitlines()[-1])
    if not (loader["value"] > 0 and loader["train_step_ms"] > 0):
        raise AssertionError(f"bench_loader: {loader}")
    loader.update(seconds=secs,
                  notes=[x for x in err.splitlines() if x.startswith("#")])
    emit({"phase": "bench_loader", **loader})
    radii_path = BENCH_DIR / "radii.json"
    out, _, secs = module_run("deft_tpu_torch.tools.measure_dcn_offsets", [
        "--load_model", str(checkpoint), "--frames", "2",
        "--radii_out", str(radii_path)])
    layers = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    radii = json.loads(radii_path.read_text())
    if len(layers) != 16 or not parse_layer_radii(json.dumps(radii)):
        raise AssertionError(f"measure_dcn_offsets: {layers} {radii}")
    emit({"phase": "measure_dcn_offsets", "seconds": secs,
          "layers": len(layers),
          "absmax": max(r["absmax"] for r in layers), "radii": radii})
    out, _, secs = module_run("deft_tpu_torch.tools.trace_device_ms", [
        str(BENCH_DIR / "profile"), "--frames", str(profiled_frames)])
    trace = json.loads(out.strip().splitlines()[-1])
    if not trace["device_busy_ms_total"] > 0:
        raise AssertionError(f"trace_device_ms: {trace}")
    emit({"phase": "trace_device_ms", "seconds": secs, **trace})
    return {"loader": loader, "trace": trace}


def bench_phase(data: Path, checkpoint: Path) -> dict:
    """``python -m deft_tpu_torch.bench`` as a user runs it (``BENCH_RUNS``,
    ``DEFT_USE_NATIVE=1``), ``bench_device_checks`` and ``bench_tools``;
    returns each run's launches."""
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    rows = {name: bench_run(name, list(args)) for name, args in BENCH_RUNS}
    bench_device_checks()
    profiled = next(args for _, args in BENCH_RUNS if "--profile" in args)
    bench_tools(data, checkpoint, BENCH_PASSES * int(
        profiled[profiled.index("--frames") + 1]))
    return {name: row["launches"] for name, row in rows.items()}


# ---- slice 15: the visualizer, COCO and custom datasets, bench_dcn ----------

VISUAL_DIR = BUILD_DIR.parent / "visual"
VISUAL_FRAMES = 4
VISUAL_SIZE = (1080, 1920)
# launches per frame of the MOT line under --debug 2: detect and the pred_hm
# forward, 16 DCNv2 layers each through the hybrid (bf16: 11 + 5)
VISUAL_PER_FRAME = {"float32": {"dcn_sample": 32},
                    "bfloat16": {"dcn_sample": 22, "dcn_sample_onehot": 10}}
BOARDS = ("generic", "previous", "pred_hm")
# decoded peaks within this of the K-th score are ties: left out of the
# pred_hm check
PEAK_TIE = {"float32": 1e-5, "bfloat16": 1e-2}
COCO_DIR = BUILD_DIR.parent / "coco"
COCO_SIZE = (480, 640)           # COCO's images are about 640x480
COCO_TRAIN_ITERS = 3
# DLA-34's DCNv2 layers at COCO's 512x512 input, which the coco phase's
# train and test lines run (checked against the model there)
COCO_LAYERS = [
    (128, 128, 64, 64, 5),
    (64, 64, 128, 64, 4),
    (64, 64, 128, 128, 2),
    (32, 32, 256, 128, 2),
    (32, 32, 256, 256, 1),
    (32, 32, 256, 64, 1),
    (16, 16, 512, 256, 1),
]
# COCO 2017's 80 category ids: 1-90 less the ten its detection split skips
COCO_CATEGORIES = [{"id": i, "name": f"class_{i}"} for i in range(1, 91)
                   if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
              "AR100", "ARs", "ARm", "ARl")
BENCH_DCN_TOL = 0.25             # bench_dcn against the kernel phase, per layer


@contextlib.contextmanager
def debug_records():
    """While it is open, per ``Detector.run`` frame: the decoded peaks of
    ``process`` (``scores``, ``ys``, ``xs``, ``clses``), the ``pred_hm``
    forward's heatmap (``debug_heatmap``), and the host seconds spent in
    ``show_debug`` and in ``VideoWriter.write``."""
    rec = {"dets": [], "hm": [], "boards_seconds": 0.0,
           "video_seconds": 0.0}
    saved = (Detector.process, Detector.debug_heatmap, Detector.show_debug,
             VideoWriter.write)

    def process(self, images, meta=None):
        dets, emb = saved[0](self, images, meta)
        rec["dets"].append({k: dets[k] for k in ("scores", "ys", "xs",
                                                 "clses")})
        return dets, emb

    def debug_heatmap(self, images):
        hm = saved[1](self, images)
        rec["hm"].append(hm)
        return hm

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec[key] += time.perf_counter() - t0
            return out
        return call

    Detector.process, Detector.debug_heatmap = process, debug_heatmap
    Detector.show_debug = timed(saved[2], "boards_seconds")
    VideoWriter.write = timed(saved[3], "video_seconds")
    try:
        yield rec
    finally:
        (Detector.process, Detector.debug_heatmap, Detector.show_debug,
         VideoWriter.write) = saved


def peak_check(dets, hm, k: int, tie: float) -> dict:
    """The ``pred_hm`` forward's heatmap decoded as ``detect`` decodes its
    own (clamped as ``clamped_sigmoid``, the 3x3 max-pool, top-K) against
    the detect
    program's peaks: every decoded peak more than ``tie`` above the K-th
    score must be among the heatmap's top K at the same (y, x, class).
    Returns the peaks compared and the largest score difference."""
    heat = heat_nms(torch.from_numpy(hm)[None].clamp(1e-4, 1.0 - 1e-4))
    scores, _, clses, ys, xs = topk(heat, k=k)
    mine = {(int(y), int(x), int(c)): float(s) for s, y, x, c in zip(
        scores[0], ys[0], xs[0], clses[0])}
    floor = float(dets["scores"][0].min())
    compared, worst = 0, 0.0
    for s, y, x, c in zip(dets["scores"][0], dets["ys"][0], dets["xs"][0],
                          dets["clses"][0]):
        if s <= floor + tie:
            continue
        key = (int(y), int(x), int(c))
        if key not in mine:
            raise AssertionError(f"decoded peak {key} (score {s}) is not "
                                 f"among the pred_hm forward's top {k}")
        compared += 1
        worst = max(worst, abs(mine[key] - float(s)))
    return {"peaks_compared": compared, "max_score_diff": worst}


def visual_phase(weights: Path) -> dict:
    """Slice 15's main path: the MOT recipe's test line through
    ``deft_tpu_torch.test.main`` with ``--debug 2 --save_video`` (so frame
    by frame through ``Detector.run``) on ``VISUAL_FRAMES`` 1080x1920 PNG
    frames (``layout_mot`` under ``build/visual/``), the cli phase's MOT
    weights, at float32 and at the line's bf16.  Asserts per run the
    launches (``VISUAL_PER_FRAME``: detect and the pred_hm forward), the
    results and their MOT scores (``check_cli_outputs``), the three boards
    of every frame under ``<save_dir>/debug/`` and the video's frames
    (PNG in ``video_1/`` without cv2, else ``video_1.mp4``), and that the
    pred_hm forward's peaks are the detect program's (``peak_check``).
    Reports ms/frame with the boards and the video, without them (the same
    run less the host seconds of ``show_debug`` and the video writes), and
    the two alone, and the time of one ``plot_tracking`` board with its
    rectangles drawn as slices (``_band``) and through the general polygon
    fill (``band_times``).  Returns each dtype's launches."""
    import shutil

    shutil.rmtree(VISUAL_DIR, ignore_errors=True)
    data = layout_mot(VISUAL_DIR / "data", VISUAL_FRAMES, VISUAL_SIZE)
    launched = {}
    for dtype in ("float32", "bfloat16"):
        argv = recipe_test_argv(
            "mot", data_dir=VISUAL_DIR / "data",
            exp_dir=VISUAL_DIR / "exp" / dtype, gpus=0,
            save_results=True, load_model=weights, compute_dtype=dtype,
            debug=2, save_video=True)
        cfg = parse_config(argv)[0]
        with debug_records() as rec:
            metrics, stats, count, seen, peak, _ = cli_run(argv)
        n = stats["frames"]
        want = {(name, dtype): per * n
                for name, per in VISUAL_PER_FRAME[dtype].items()}
        want_count = dict.fromkeys(KERNELS, 0)
        want_count.update({name: v for (name, _), v in want.items()})
        if n != VISUAL_FRAMES or count != want_count or seen != want:
            raise AssertionError(f"visual {dtype}: {n} frames, launches "
                                 f"{count} on x {seen}, expected {want}")
        items = check_cli_outputs("mot", argv, metrics, data)
        save = Path(cfg.save_dir)
        boards = sorted(p.name for p in (save / "debug").iterdir())
        if boards != sorted(f"{i:05d}_{b}.png" for i in range(1, n + 1)
                            for b in BOARDS):
            raise AssertionError(f"visual {dtype}: boards {boards}")
        for name in boards:
            board = imread(str(save / "debug" / name))
            want_shape = ((cfg.input_h, cfg.input_w, 3) if "pred_hm" in name
                          else VISUAL_SIZE + (3,))
            if board is None or board.shape != want_shape:
                raise AssertionError(f"visual {dtype}: board {name}")
        video = sorted((save / "video_1").glob("*.png"))
        mp4 = save / "video_1.mp4"
        if len(video) != n and not (mp4.is_file() and mp4.stat().st_size):
            raise AssertionError(f"visual {dtype}: {len(video)} video "
                                 f"frames of {n}, no {mp4.name}")
        if len(rec["hm"]) != n or len(rec["dets"]) != n:
            raise AssertionError(f"visual {dtype}: {len(rec['hm'])} pred_hm "
                                 f"forwards, {len(rec['dets'])} detects")
        peaks = [peak_check(d, h, cfg.K, PEAK_TIE[dtype])
                 for d, h in zip(rec["dets"], rec["hm"])]
        ms = stats["seconds"] * 1e3 / n
        drawn_ms = (rec["boards_seconds"] + rec["video_seconds"]) * 1e3 / n
        emit({"phase": "visual", "dtype": dtype, "argv": argv, "frames": n,
              "launches": count,
              "x_dtype_launches": {f"{k} {d}": v for (k, d), v in
                                   seen.items()},
              "items": items, "boards": len(boards),
              "video": (f"{len(video)} PNG frames in video_1/" if video
                        else mp4.name),
              "peaks_compared": sum(p["peaks_compared"] for p in peaks),
              "peak_max_score_diff": max(p["max_score_diff"]
                                         for p in peaks),
              "ms_per_frame_with_boards": ms,
              "ms_per_frame_without_boards": ms - drawn_ms,
              "boards_ms_per_frame": rec["boards_seconds"] * 1e3 / n,
              "video_ms_per_frame": rec["video_seconds"] * 1e3 / n,
              "read_ms_per_frame": stats["read_seconds"] * 1e3 / n,
              "peak_memory_bytes": peak,
              "mota": metrics["overall"].get("mota")})
        launched[dtype] = count
    emit(band_times())
    return launched


def band_times(tracks: int = 40, reps: int = 5) -> dict:
    """Host ms of one ``plot_tracking`` board of ``tracks`` seeded boxes on
    a ``VISUAL_SIZE`` frame, its thickness-2 rectangles drawn as slices
    (``visualize._band``, what the boards run) and through the general
    polygon fill (``_thick_line``, the same pixels; tests/test_torch_port_
    visualize.py), alternating, the median of ``reps`` boards each."""
    rng = np.random.RandomState(SEED + 9)
    frame = rng.randint(0, 256, VISUAL_SIZE + (3,)).astype(np.uint8)
    h, w = VISUAL_SIZE
    x, y = rng.uniform(0, w - 100, tracks), rng.uniform(0, h - 100, tracks)
    boxes = [{"bbox": [x0, y0, x0 + bw, y0 + bh], "tracking_id": i + 1}
             for i, (x0, y0, bw, bh) in enumerate(zip(
                 x, y, rng.uniform(20, 300, tracks),
                 rng.uniform(40, 400, tracks)))]
    band = visualize._band

    def general(img, p0, p1, color):
        visualize._thick_line(img, p0, p1, color, 2, False)

    times = {"band": [], "polygon": []}
    try:
        for _ in range(reps):
            for name, fn in (("band", band), ("polygon", general)):
                visualize._band = fn
                t0 = time.perf_counter()
                visualize.plot_tracking(frame, boxes)
                times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        visualize._band = band
    return {"phase": "visual_band", "tracks": tracks,
            "frame": list(VISUAL_SIZE),
            "board_ms_band": statistics.median(times["band"]),
            "board_ms_polygon": statistics.median(times["polygon"])}


def coco_phase() -> dict:
    """Slice 15's datasets: a COCO 2017 layout of videos under
    ``build/coco/`` (``layout_coco``: 480x640 PNG frames, COCO's 80
    category ids, six moving boxes per video; train 2 videos x 6 frames,
    val 1 x 4), then

    * ``python -m deft_tpu_torch.train --dataset coco`` at bf16, batch 4
      at COCO's 512x512, 80 classes, ``COCO_TRAIN_ITERS`` steps, seeded
      weights (``train_line``: 128 T4 and 128 T5 launches per step,
      finite losses, ``model_last.pth``);
    * the test line on the val split at bf16 with that ``model_last``,
      its heatmap raised (``raise_class_heatmaps``), through the runner
      (11 T1 + 5 T4 per frame): results for every frame,
      ``results_coco.json`` and ``tools/eval_coco.py``'s 12 stats;
    * one ``--dataset custom`` frame (``--num_classes 80`` over the val
      images, a json of its first image): tracked (16 launches), then
      ``run_eval`` raises, as the JAX ``CustomDataset``'s does.

    The DCNv2 layers of the lines, at 512x512, are checked against
    ``COCO_LAYERS``, the kernel phase's table for them.  Returns the
    launches per run."""
    import shutil

    shutil.rmtree(COCO_DIR, ignore_errors=True)
    coco = COCO_DIR / "data" / "coco"
    layout_coco(coco, "train", COCO_CATEGORIES, videos=2, frames=6,
                size=COCO_SIZE, seed=SEED + 7, objects=6)
    val = layout_coco(coco, "val", COCO_CATEGORIES, videos=1, frames=4,
                      size=COCO_SIZE, seed=SEED + 8, objects=6)
    common = ["--compute_dtype", "bfloat16", "--data_dir",
              str(COCO_DIR / "data"), "--gpus", "0"]
    train = ["tracking", "--exp_id", "coco", "--dataset", "coco",
             "--batch_size", "4", "--num_epochs", "1", "--num_iters",
             str(COCO_TRAIN_ITERS), "--num_workers", "1", "--exp_dir",
             str(COCO_DIR / "exp")] + common
    row = train_line("coco", train, 16 * 4 * 2, COCO_TRAIN_ITERS)
    row["phase"] = "coco_train"
    emit(row)
    launched = {"train": row["launches"]}
    # three steps from seeded weights leave the heatmap near its prior: the
    # test lines load model_last with its heads raised as the cli phase
    # raises seeded ones (raise_class_heatmaps, on the first val frame)
    blob = json.loads(val.read_text())
    first = blob["images"][0]
    cfg = parse_config(["tracking", "--dataset", "coco"] + common)[0]
    train_cfg = parse_config(train)[0]
    det = Detector(cfg.replace(
        compute_dtype="float32",
        load_model=str(COCO_DIR / "exp" / "tracking" / "coco"
                       / "model_last.pth")))
    image = det.pre_process(imread(str(coco / "val2017"
                                       / first["file_name"])))[0]
    shapes = dcn_layer_shapes(det.model, image)
    if (shapes != Counter({l[:4]: l[4] for l in COCO_LAYERS})
            or {(train_cfg.input_h, train_cfg.input_w),
                (cfg.input_h, cfg.input_w)} != {(512, 512)}):
        raise AssertionError(f"coco DCN layers {dict(shapes)} at "
                             f"{cfg.input_h}x{cfg.input_w} (train "
                             f"{train_cfg.input_h}x{train_cfg.input_w}) are "
                             f"not COCO_LAYERS")
    raise_class_heatmaps(det.model, image)
    model = COCO_DIR / "model_test.pth"
    torch.save({"epoch": 0, "state_dict": {
        k: v.cpu() for k, v in det.model.state_dict().items()}}, model)
    del det

    per_frame = {("dcn_sample", "bfloat16"): 11,
                 ("dcn_sample_onehot", "bfloat16"): 5}
    test = ["tracking", "--exp_id", "coco", "--dataset", "coco",
            "--load_model", str(model), "--save_results", "--exp_dir",
            str(COCO_DIR / "exp_test")] + common
    metrics, stats, count, seen, peak, _ = cli_run(test)
    n = stats["frames"]
    want = {k: v * n for k, v in per_frame.items()}
    save = Path(parse_config(test)[0].save_dir)
    results = json.loads((save / "save_results_coco.json").read_text())
    detections = json.loads((save / "results_coco.json").read_text())
    if (n != 4 or seen != want or sorted(metrics) != sorted(COCO_STATS)
            or not all(math.isfinite(v) for v in metrics.values())
            or len(results) != n):
        raise AssertionError(f"coco test line: {n} frames, launches {seen} "
                             f"(expected {want}), {len(results)} results, "
                             f"stats {metrics}")
    emit({"phase": "coco_test", "argv": test, "frames": n,
          "launches": count, "items": sum(len(v) for v in results.values()),
          "results_coco_json": len(detections), "stats": metrics,
          "ms_per_frame": stats["seconds"] * 1e3 / n,
          "read_ms_per_frame": stats["read_seconds"] * 1e3 / n,
          "peak_memory_bytes": peak})
    launched["test"] = count

    custom_json = COCO_DIR / "custom.json"
    custom_json.write_text(json.dumps({
        "images": [first], "annotations": [], "videos": blob["videos"],
        "categories": [{"id": i, "name": str(i)} for i in range(1, 81)]}))
    custom = ["tracking", "--exp_id", "custom", "--dataset", "custom",
              "--num_classes", "80", "--custom_dataset_img_path",
              str(coco / "val2017"), "--custom_dataset_ann_path",
              str(custom_json), "--load_model", str(model),
              "--save_results", "--exp_dir", str(COCO_DIR / "exp_test")
              ] + common
    reset_launches()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            port_test.main(custom)
    except NotImplementedError as e:
        if "no bundled evaluator" not in str(e):
            raise
    else:
        raise AssertionError("the custom dataset's run_eval did not raise")
    count = launches()
    saved = json.loads((Path(parse_config(custom)[0].save_dir)
                        / "save_results_custom.json").read_text())
    if list(saved) != [str(first["id"])] or any(
            count[k] != v for (k, _), v in per_frame.items()):
        raise AssertionError(f"custom frame: results {list(saved)}, "
                             f"launches {count}")
    emit({"phase": "custom_test", "argv": custom, "frames": 1,
          "launches": count, "items": len(saved[str(first["id"])]),
          "run_eval": "NotImplementedError, as the JAX CustomDataset"})
    launched["custom"] = count
    return launched


def bench_dcn_phase(rows) -> dict:
    """``python -m deft_tpu_torch.tools.bench_dcn --iters 20 --regimes
    trained --radius 4`` in process (its rows printed), then its T1 and T2
    (float32 x) and T4 (bf16 x) per layer against the kernel phase's time
    of the same kernel, shape, dtype and offset regime: within
    ``BENCH_DCN_TOL`` of it.  Returns the ratios."""
    bench = bench_dcn.main(["--iters", "20", "--regimes", "trained",
                            "--radius", str(RADIUS)])
    ratios = {}
    for r in bench:
        if r["impl"] not in ("sample", "sample_tap", "onehot"):
            continue
        h, w, c, cout = bench_dcn.LAYERS[r["layer"]][:4]
        (mine,) = [x for x in rows if x["kernel"] == r["kernel"]
                   and x["model"] == "mot" and x["regime"] == "trained"
                   and x["dtype"] == r["dtype"]
                   and (x["H"], x["W"], x["C"], x["Cout"]) == (h, w, c,
                                                               cout)]
        ratios[f"{r['kernel']} {r['dtype']} {h}x{w}x{c}->{cout}"] = (
            r["ms"] / mine["kernel_ms"])
    worst = max(ratios.values(), key=lambda v: abs(v - 1.0))
    emit({"phase": "bench_dcn", "rows": len(bench),
          "model_weighted_ms_per_frame": {
              f"{impl} r={radius}": ms for (impl, _, radius), ms in
              bench_dcn.model_weighted(bench).items()},
          "ms_over_kernel_phase": ratios, "worst_ratio": worst})
    if abs(worst - 1.0) > BENCH_DCN_TOL:
        raise AssertionError(f"bench_dcn differs from the kernel phase by "
                             f"{worst}: {ratios}")
    return ratios


def kernels_line(rows, kernel_launches, slice_launches, runner_launches,
                 nuscenes_launches, kitti_launches, kitti_runner_launches,
                 public_launches, cli_launches, train_launches,
                 recipe_launches, geometry_rows, ddp_launches,
                 archs_launches, bench_launches, visual_launches,
                 coco_launches):
    """Per kernel: per-frame sums over the 16 layers of a 544x960 MOT frame
    (float32 x), the worst error of any case, and the launches of the paths
    that run it (the kernel phase's for ``dcn_fused``, which no path
    reaches); ``dcn_sample`` adds its sums over a 448x800 nuScenes camera,
    it and ``dcn_sample_tap`` their sums over a 384x1280 KITTI frame and
    over a 544x960 MOT frame on a bf16 x, and ``dcn_sample`` and
    ``dcn_sample_onehot`` their sums on a bf16 x over the layers the bf16
    hybrid gives each, per model (the recipes' test lines).  The train
    phase adds its launches: ``dcn_sample`` (float32), ``dcn_sample_onehot``
    (bf16) and ``dcn_backward`` (both, its only path); the recipes phase
    those of the KITTI and nuScenes train lines (``dcn_sample_onehot`` and
    ``dcn_backward``, bf16) and of the three test lines on the trained
    files; ``dcn_backward`` (T5's tiled route) its sums over the layers of
    a 384x1280 KITTI frame and a 448x800 nuScenes camera on a bf16 x, and
    its plans; ``dcn_backward_entry`` (T5's unclamped route, on no path)
    the numbers of its one call at radius -1 on the largest MOT layer and
    the kernel phase's launches.  The geometry phase's paths add their
    launches to T1, T2 and T4 (``launches_by_path``), and those kernels
    their sums over the layers of a keep_res KITTI frame and a fix_short
    MOT frame (T1 and T2 on a float32 x, T4 on a bf16 one); the ddp
    phase's NCCL run adds its T4 and T5 launches.  The archs phase adds
    the launches of its paths (DLA-169 tracking and training, the
    detection families) and its layer sums: DLA-169's per 544x960 frame
    (T1 and T2 on a float32 x, T4 and T5 on a bf16 one, T1 and T4 on the
    layers the bf16 hybrid gives each) and ResDCN's unclamped neck (T1,
    ResDCN-18's three layers per frame and ResDCN-101's 2048-channel
    one).  The bench phase adds the launches of its runs' timed passes
    (``python -m deft_tpu_torch.bench``: T1, and T4 at bf16); the visual
    phase those of the ``--debug 2 --save_video`` line (T1, and T4 at
    bf16) and the coco phase those of its train line (T4, T5) and test
    lines (T1, T4); T1, T4 and T5 their sums over the layers of a 512x512
    COCO frame (``coco_512_per_frame``; T1 on a bf16 x over the bf16
    hybrid's 11 layers)."""
    cli_hybrid = Counter()
    for (_, impl), count in cli_launches.items():
        if impl == "hybrid":
            cli_hybrid.update(count)
    recipe_train = Counter()
    recipe_test = Counter()
    for (_, script), count in recipe_launches.items():
        (recipe_train if script == "train.py" else recipe_test).update(count)
    entries = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        total = per_frame_sums([r for r in mine if r["model"] == "mot"])
        path = {"dcn_sample": (
                    "Detector.run (MOT, MOT public detections, KITTI) and "
                    "Detector.run_multi (nuScenes), dcn_impl=hybrid; "
                    "deft_tpu_torch.test on the MOT and KITTI test lines "
                    f"(bf16, layers of <= {HYBRID_CM_CHANNELS} channels)",
                    slice_launches + nuscenes_launches + kitti_launches
                    + public_launches["Detector.run"]
                    + cli_hybrid["dcn_sample"]
                    + train_launches["float32"]["dcn_sample"]
                    + recipe_test["dcn_sample"]),
                "dcn_sample_tap": (
                    "PipelinedRunner chunk 1 (MOT, MOT public detections, "
                    "KITTI), dcn_impl=pallas; deft_tpu_torch.test on the "
                    "MOT test line with --dcn_impl pallas (bf16)",
                    runner_launches + kitti_runner_launches["test.py"]
                    + public_launches["PipelinedRunner"]
                    + cli_launches[("mot", "pallas")]["dcn_sample_tap"]),
                "dcn_sample_onehot": (
                    "deft_tpu_torch.test on the recipes' test lines (bf16, "
                    f"dcn_impl=hybrid): MOT and KITTI layers of > "
                    f"{HYBRID_CM_CHANNELS} channels, every nuScenes layer "
                    "(six cameras as one batch); deft_tpu_torch.train on "
                    "the MOT, KITTI and nuScenes train lines (bf16, every "
                    "layer of the batch)",
                    cli_hybrid["dcn_sample_onehot"]
                    + train_launches["bfloat16"]["dcn_sample_onehot"]
                    + recipe_train["dcn_sample_onehot"]
                    + recipe_test["dcn_sample_onehot"]),
                "dcn_backward": (
                    "deft_tpu_torch.train on the MOT recipe's train line, "
                    "bf16 and float32 (train phase), and on the KITTI and "
                    "nuScenes train lines, bf16 (recipes phase)",
                    sum(n["dcn_backward"] for n in train_launches.values())
                    + recipe_train["dcn_backward"]),
                "dcn_backward_entry": (
                    "none: T5's unclamped route, taken for dcn_impl=gather "
                    "or where no window fits, which no recipe line does "
                    "(0 launches on the train lines); launches through the "
                    "wrapper in the kernel phase",
                    kernel_launches["dcn_backward_entry"])}
        path_name, count = path.get(name, (
            "none: nothing in the JAX package calls the TPU kernel; "
            "launches through the wrapper in the kernel phase",
            kernel_launches[name]))
        geometry_paths = {
            f"{row['path']}, " + (f"{row['samples']} samples"
                                  if "samples" in row
                                  else f"{row['frames']} frames"):
                row["launches"][name]
            for row in geometry_rows if row["launches"][name]}
        if name in ("dcn_sample", "dcn_sample_tap", "dcn_sample_onehot"):
            count += sum(geometry_paths.values())
            path_name += "; the geometry phase (flip_test, keep_res, fix_short)"
        if name in ("dcn_sample_onehot", "dcn_backward"):
            count += ddp_launches[name]
            path_name += "; the ddp phase (train_rank, NCCL, world 1)"
        arch_paths = {f"archs phase, {path}": n[name]
                      for path, n in archs_launches.items() if n[name]}
        if arch_paths:
            count += sum(arch_paths.values())
            path_name += ("; the archs phase (DLA-169 tracking and training, "
                          "the detection families' gather DCNs)")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "path": path_name,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
            "bound_ms": max(total["bound_bytes_ms"],
                            total["bound_operations_ms"]),
            "bound_by": ("bytes" if total["bound_bytes_ms"]
                         >= total["bound_operations_ms"] else "operations"),
            "library_ms": total["library_ms"]}
        if name in ("dcn_sample", "dcn_sample_tap"):
            entry["kitti_per_frame"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "kitti"]))
            entry["bf16_per_frame"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "mot"], "bfloat16"))
        if name in ("dcn_sample", "dcn_sample_onehot"):
            hybrid_rows = {
                model: [r for r in mine if r["model"] == model
                        and bf16_hybrid_kernel(model, r["C"]) == name]
                for model in ("mot", "kitti", "nuscenes")}
            entry["bf16_hybrid_layers_per_frame"] = {
                model: sums_entry(per_frame_sums(mine_here, "bfloat16"))
                for model, mine_here in hybrid_rows.items() if mine_here}
            entry["launches_by_path"] = {
                f"deft_tpu_torch.test, {recipe} test line, bf16":
                    n[name] for (recipe, impl), n in cli_launches.items()
                if impl == "hybrid"}
        if name in ("dcn_sample", "dcn_sample_onehot"):
            dtype = "float32" if name == "dcn_sample" else "bfloat16"
            entry["launches_by_path"][
                f"deft_tpu_torch.train, mot train line, {dtype}, "
                f"{TRAIN_ITERS} steps"] = train_launches[dtype][name]
            entry["launches_by_path"].update({
                f"deft_tpu_torch.test, {recipe} test line on the trained "
                f"files, bf16": n[name]
                for (recipe, script), n in recipe_launches.items()
                if script == "test.py" and n[name]})
        if name == "dcn_backward":
            entry["launches_by_path"] = {
                f"deft_tpu_torch.train, mot train line, {dtype}, "
                f"{TRAIN_ITERS} steps": n["dcn_backward"]
                for dtype, n in train_launches.items()}
        if name in ("dcn_backward", "dcn_sample_onehot"):
            entry["launches_by_path"].update({
                f"deft_tpu_torch.train, {recipe} train line, bfloat16, "
                f"{RECIPE_TRAIN_ITERS} steps": n[name]
                for (recipe, script), n in recipe_launches.items()
                if script == "train.py"})
        if name == "dcn_backward":
            entry["bf16_per_frame"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "mot"], "bfloat16"))
            entry["bf16_per_frame_kitti"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "kitti"], "bfloat16"))
            entry["bf16_per_camera_nuscenes"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "nuscenes"], "bfloat16"))
            entry["design"] = ("tiled route: per pixel tile and run of "
                               "channel slices an x window and a float32 dx "
                               "window in shared memory, entries binned by "
                               "window cell, bins owned by lane groups in "
                               "four parity phases (plain shared adds), one "
                               "float4 global add per window cell and 4 "
                               "channels; plan_backward")
            entry["same_bits_two_calls"] = all(
                r["same_bits_two_calls"] for r in mine)
            entry["same_bits_doffsets_dmask_two_calls"] = all(
                all(r["same_bits_two_calls_dx_doffsets_dmask"][1:])
                for r in mine)
            entry["plans"] = {f"{r['model']} {r['dtype']} "
                              f"{r['H']}x{r['W']}x{r['C']}": r["plan"]
                              for r in mine if r["regime"] == "trained"}
        if name == "dcn_backward_entry":
            (one,) = mine
            entry.update({
                "ms": one["kernel_ms"], "plain_ms": one["plain_ms"],
                "library_ms": one["library_ms"], "bound_ms": one["bound_ms"],
                "bound_by": one["bound_by"],
                "per": f"one call at {one['H']}x{one['W']}x{one['C']}, "
                       f"radius {one['radius']}, float32",
                "design": ("one warp per (pixel, tap), lanes over channels, "
                           "float32 atomicAdd into dx, warp shuffles for "
                           "doffsets and dmask"),
                "same_bits_two_calls": one["same_bits_two_calls"]})
        if name == "dcn_sample":
            entry["launches_by_path"].update({
                f"Detector.run, MOT, {FRAMES} frames": slice_launches,
                f"Detector.run_multi, nuScenes, {NUSCENES_SAMPLES} samples "
                f"x {CAMERAS} cameras": nuscenes_launches,
                f"Detector.run, KITTI, {FRAMES} frames": kitti_launches,
                f"Detector.run, MOT public detections, {FRAMES} frames":
                    public_launches["Detector.run"]})
            entry["nuscenes_per_camera"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "nuscenes"]))
        if name == "dcn_sample_tap":
            entry["launches_by_path"] = {
                f"PipelinedRunner chunk 1, MOT, {FRAMES} frames":
                    runner_launches}
            entry["launches_by_path"].update({
                f"PipelinedRunner chunk {c}, KITTI, {FRAMES} frames":
                    kitti_runner_launches[run]
                for run, c in (("test.py", 1), ("bench.py", CHUNK))})
            entry["launches_by_path"][
                f"PipelinedRunner chunk 1, MOT public detections, {FRAMES} "
                f"frames"] = public_launches["PipelinedRunner"]
            entry["launches_by_path"][
                "deft_tpu_torch.test, mot test line --dcn_impl pallas, "
                "bf16"] = cli_launches[("mot", "pallas")]["dcn_sample_tap"]
        if name == "dcn_fused":
            entry["product"] = "3xTF32 mma.sync.m16n8k8, split-K"
            entry["bound_ffma_ms"] = max(total["bound_bytes_ms"],
                                         total["bound_operations_ffma_ms"])
        if name == "dcn_sample_onehot":
            entry["design"] = ("bf16 input window in shared memory per "
                               "(pixel tile, channel slice), plan_onehot")
        if name in ("dcn_sample", "dcn_sample_tap", "dcn_sample_onehot"):
            dtype = "bfloat16" if name == "dcn_sample_onehot" else "float32"
            entry["keep_res_kitti_per_frame"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "kitti_keep_res"], dtype))
            entry["fix_short_mot_per_frame"] = sums_entry(per_frame_sums(
                [r for r in mine if r["model"] == "mot_fix_short"], dtype))
            entry["launches_by_path"].update(
                {f"geometry phase, {path}": n
                 for path, n in geometry_paths.items()})
        if name in ("dcn_sample_onehot", "dcn_backward"):
            entry["launches_by_path"][
                f"ddp phase, train_rank nccl world 1, mot train line bf16, "
                f"{DDP_ITERS} steps"] = ddp_launches[name]
        if name == "dcn_sample_tap":
            entry["store"] = "streaming (st.global.cs)"
            entry["with_gemm_ms"] = sum(
                r["with_gemm_ms"] * r["count"] for r in mine
                if r["regime"] == "trained" and r["dtype"] == "float32"
                and r["model"] == "mot")
        if arch_paths:
            entry.setdefault("launches_by_path", {}).update(arch_paths)
        bench_paths = {
            f"python -m deft_tpu_torch.bench, {run}, {BENCH_PASSES} timed "
            f"passes": n[name] for run, n in bench_launches.items() if n[name]}
        if bench_paths:
            entry["launches"] += sum(bench_paths.values())
            entry["path"] += ("; the bench phase (MOT17 through "
                              "PipelinedRunner chunk 4, python -m "
                              "deft_tpu_torch.bench)")
            entry.setdefault("launches_by_path", {}).update(bench_paths)
        slice15_paths = {
            f"deft_tpu_torch.test --debug 2 --save_video, mot test line, "
            f"{dtype}, {VISUAL_FRAMES} frames": n[name]
            for dtype, n in visual_launches.items() if n[name]}
        slice15_paths.update({
            label: coco_launches[run][name] for run, label in (
                ("train", f"deft_tpu_torch.train --dataset coco, bfloat16, "
                          f"{COCO_TRAIN_ITERS} steps"),
                ("test", "deft_tpu_torch.test --dataset coco, bfloat16, "
                         "4 frames"),
                ("custom", "deft_tpu_torch.test --dataset custom, "
                           "bfloat16, 1 frame"))
            if coco_launches[run][name]})
        if slice15_paths:
            entry["launches"] += sum(slice15_paths.values())
            entry["path"] += ("; the visual phase (--debug 2 --save_video) "
                              "and the coco phase (COCO and custom "
                              "datasets)")
            entry.setdefault("launches_by_path", {}).update(slice15_paths)
        coco = [r for r in mine if r["model"] == "coco"]
        if coco:
            entry["coco_512_per_frame"] = {
                dtype: sums_entry(per_frame_sums(coco, dtype))
                for dtype in ("float32", "bfloat16")
                if any(r["dtype"] == dtype for r in coco)}
        dla169 = [r for r in mine if r["model"] == "dla169"]
        if dla169:
            entry["dla169_per_frame"] = {
                dtype: sums_entry(per_frame_sums(dla169, dtype))
                for dtype in ("float32", "bfloat16")
                if any(r["dtype"] == dtype for r in dla169)}
        if name in ("dcn_sample", "dcn_sample_onehot"):
            entry["dla169_bf16_hybrid_layers_per_frame"] = sums_entry(
                per_frame_sums([r for r in dla169 if bf16_hybrid_kernel(
                    "mot", r["C"]) == name], "bfloat16"))
        if name == "dcn_sample":
            for model, key in (("resdcn18", "resdcn18_unclamped_per_frame"),
                               ("resdcn101",
                                "resdcn101_2048_channel_layer")):
                entry[key] = {
                    dtype: sums_entry(per_frame_sums(
                        [r for r in mine if r["model"] == model], dtype))
                    for dtype in ("float32", "bfloat16")}
        entries.append(entry)
    return {"kernels": entries}


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

    seconds = {"build": time.perf_counter() - t0}

    def lap(phase):
        seconds[phase] = time.perf_counter() - t0 - sum(seconds.values())

    reset_launches()
    rows = kernel_phase()
    kernel_launches = launches()
    lap("kernel")
    frames = list(synthetic_frames(FRAMES))
    slice_launches, det, ms_per_frame = slice_phase(mot_config(), frames)
    checkpoint_phase(det, frames[0])
    profile_phase(det, frames, ms_per_frame)
    del det
    lap("slice, checkpoint, profile")
    runner_rows, runners, _ = runner_phase(frames)
    runner = runners["test.py"]
    runner_profile_phase(runner, frames,
                         runner_rows["test.py"]["ms_per_frame"])
    del runner, runners, frames
    lap("runner")
    nuscenes_launches = nuscenes_phase()
    lap("nuscenes")
    kitti_launches, kitti_runner_launches = kitti_phase()
    lap("kitti")
    public_launches = public_phase()
    lap("public")
    cli_launches = cli_phase()
    lap("cli")
    train_launches = train_phase(CLI_DIR / "data" / "mot17")
    lap("train")
    ddp_launches = ddp_phase(CLI_DIR / "data" / "mot17")
    lap("ddp")
    recipe_launches = recipes_phase(CLI_DIR / "data")
    lap("recipes")
    geometry_rows, _ = geometry_phase()
    lap("geometry")
    archs_launches = archs_phase(CLI_DIR / "data" / "mot17")
    lap("archs")
    bench_launches = bench_phase(CLI_DIR / "data" / "mot17",
                                 BUILD_DIR.parent / "checkpoint"
                                 / "model_mot.pth")
    lap("bench")
    visual_launches = visual_phase(CLI_DIR / "weights" / "mot" / "model.pth")
    lap("visual")
    coco_launches = coco_phase()
    lap("coco")
    bench_dcn_phase(rows)
    lap("bench_dcn")
    emit({"phase": "seconds", **seconds})

    print(smi, flush=True)
    emit(kernels_line(rows, kernel_launches, slice_launches,
                      runner_rows["test.py"]["launches"]["dcn_sample_tap"],
                      nuscenes_launches, kitti_launches,
                      kitti_runner_launches, public_launches, cli_launches,
                      train_launches, recipe_launches, geometry_rows,
                      ddp_launches, archs_launches, bench_launches,
                      visual_launches, coco_launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
