"""Per-layer DCNv2 kernel timing on the card, the counterpart of the JAX
repo's ``tools/bench_dcn.py``:

    python3 -m deft_tpu_torch.tools.bench_dcn [--iters 30]
        [--impls sample,sample_tap,fused,onehot,conv]
        [--regimes zero,trained,uniform] [--radius 4 2] [--layers 0 3]
        [--dtype float32]

Times each DLA-34 DCNv2 layer shape of a 544x960 frame (``LAYERS``)
through the port's routes:

  sample      T1, ``cuda_dcn.deform_sample`` (``csrc/dcn_sample.cu``)
  sample_tap  T2, ``cuda_dcn.deform_sample_tap`` (the same file)
  fused       T3, ``cuda_dcn.deform_conv_fused`` (``csrc/dcn_fused.cu``)
  onehot      T4, ``cuda_dcn.deform_sample_onehot`` (``csrc/dcn_onehot.cu``),
              on a bfloat16 x, as the bf16 hybrid and trainer run it
  conv        cuDNN's plain 3x3 convolution at the same shape (the floor)

T1, T2 and T3 take x in ``--dtype``.  The offset regimes are the JAX
tool's (``make_offsets``, the same draws for a seed): ``zero``,
``trained`` (N(0, 0.5) on a smooth ramp, within +-2 px, as trained
checkpoints give) and ``uniform`` (U(-4, 4)); each sampler clamps at every
``--radius``.  Each call is checked once against its plain version (float32
1e-5, bfloat16 one step, relative to the largest value), then ``--iters``
calls are captured back to back in a CUDA graph, each reading what the one
before wrote (the next call's x is the first elements of the last output,
or, where the output is narrower or of another type, its mask), and the
graph is replayed three times between CUDA events: the median over the
replays, per call, is the row's ``ms``.  A row also has its bound (the
larger of the bytes read and written once at 3.35 TB/s and the operations
at the units' rate, ``bound_times``) and its library call's time
(``grid_sample`` of the 9-tap grid, for T3 also the ``addmm``).

One JSON line per row, then the model-weighted per-frame totals per
(impl, regime, radius) as ``#`` lines, then the card's ``nvidia-smi`` name
and power limit.  The totals weigh each shape by the layers of that shape
in the model (``LAYERS``' last column, 16 layers); the JAX tool's table
counts each shape twice (32 layers, ROADMAP C.3).  It times the kernels
on the card only: without CUDA it raises, and it runs no plain version in
a kernel's place.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 on the tensor cores
KK = 9
# DLA-34 DCNv2 layers at 544x960 input: (H, W, Cin, Cout, layers per frame)
LAYERS = [
    (136, 240, 64, 64, 5),
    (68, 120, 128, 64, 4),
    (68, 120, 128, 128, 2),
    (34, 60, 256, 128, 2),
    (34, 60, 256, 256, 1),
    (34, 60, 256, 64, 1),
    (17, 30, 512, 256, 1),
]
IMPLS = ("sample", "sample_tap", "fused", "onehot", "conv")
# impl -> the kernel it times (chip_smoke.py's names)
KERNEL_OF = {"sample": "dcn_sample", "sample_tap": "dcn_sample_tap",
             "fused": "dcn_fused", "onehot": "dcn_sample_onehot"}


def make_offsets(rng, h, w, kk, regime: str):
    """The JAX tool's offsets [h, w, kk, 2] of a regime (module
    docstring)."""
    if regime == "zero":
        return np.zeros((h, w, kk, 2), np.float32)
    if regime == "trained":
        yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None, None, None]
        xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :, None, None]
        ramp = np.concatenate([yy + 0 * xx, xx + 0 * yy], axis=-1)
        noise = rng.normal(0.0, 0.5, (h, w, kk, 2)).astype(np.float32)
        return np.clip(noise + 0.7 * ramp, -2.0, 2.0)
    if regime == "uniform":
        return rng.uniform(-4.0, 4.0, (h, w, kk, 2)).astype(np.float32)
    raise ValueError(regime)


def bound_times(h, w, c, in_bytes, out_bytes, cout=0):
    """Least time for one call, as (bytes_ms, ffma_ms, route_ms): the inputs
    read once and the output written once over the memory rate; 8 flops per
    sampled patch element plus ~40 per (pixel, tap), plus 2 per
    multiply-add of the [9C, Cout] product when ``cout`` (the fused kernel,
    whose output is [H*W, Cout] instead of the patches).  ``ffma_ms`` counts
    all of them at the float32 rate outside the tensor cores; ``route_ms``
    counts them on the units the kernels use: the sampling at the float32
    rate, the fused kernel's product three times (3xTF32) at the TF32
    tensor-core rate, whichever takes longer.  The bound is the larger of
    the bytes and the route's operations."""
    nbytes = h * w * c * in_bytes + h * w * 9 * 2 * 4 + h * w * 9 * 4
    sample_ms = h * w * 9 * (8 * c + 40) / FP32_FLOPS_PER_S * 1e3
    ffma_ms = route_ms = sample_ms
    if cout:
        nbytes += 9 * c * cout * 4 + cout * 4 + h * w * cout * in_bytes
        product = 2 * h * w * 9 * c * cout
        ffma_ms += product / FP32_FLOPS_PER_S * 1e3
        route_ms = max(sample_ms, 3 * product / TF32_FLOPS_PER_S * 1e3)
    else:
        nbytes += h * w * 9 * c * out_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, ffma_ms, route_ms


def yardstick_inputs(x, offsets, mask, radius):
    """``grid_sample``'s operands for the 9-tap sampling: x as NCHW, the
    [1, 9, H*W, 2] grid (corner-aligned) and the mask as [1, 1, 9, H*W]; a
    bf16 x keeps bf16 (``grid_sample`` takes one dtype), grid and mask
    included."""
    h, w, c = x.shape
    dev = x.device
    off = offsets.clamp(-radius, radius) if radius >= 0 else offsets
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    yy = (torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
          + ky.reshape(1, 1, 9) + off[..., 0])
    xx = (torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
          + kx.reshape(1, 1, 9) + off[..., 1])
    grid = torch.stack([2.0 * xx / (w - 1) - 1.0, 2.0 * yy / (h - 1) - 1.0],
                       dim=-1).permute(2, 0, 1, 3).reshape(1, 9, h * w, 2)
    x_nchw = x.permute(2, 0, 1)[None].contiguous()
    if x.dtype != torch.bfloat16:
        x_nchw = x_nchw.float()
    grid = grid.to(x_nchw.dtype)
    m = mask.permute(2, 0, 1).reshape(1, 1, 9, h * w).to(x_nchw.dtype)
    return x_nchw, grid, m


def grid_sample_yardstick(x, offsets, mask, radius):
    """The same sampling through one library call: ``grid_sample`` of the
    9-tap grid (zeros padding, corner-aligned), times the mask.  Returns the
    timed closure, whose result is [1, C, 9, H*W]; the grid is built once
    outside it.  A bf16 x is sampled in bf16, grid and mask included
    (``grid_sample`` takes one dtype); a yardstick of time only."""
    x_nchw, grid, m = yardstick_inputs(x, offsets, mask, radius)

    def run():
        s = torch.nn.functional.grid_sample(
            x_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)                              # [1, C, 9, HW]
        return s * m

    return run


def _chained(out, x, mask):
    """The next call's (x, mask): x from the first elements of ``out``
    where it has x's type and as many elements, else the mask from them
    (``out``'s bytes read as float32)."""
    flat = out.reshape(-1)
    if flat.dtype == x.dtype and flat.numel() >= x.numel():
        return flat[:x.numel()].view(x.shape), mask
    if flat.dtype != torch.float32:
        flat = flat.view(torch.float32)
    return x, flat[:mask.numel()].view(mask.shape)


@functools.lru_cache(maxsize=None)
def _capture_stream() -> torch.cuda.Stream:
    """One side stream for every capture (each stream that runs a GEMM
    keeps a cuBLAS workspace)."""
    return torch.cuda.Stream()


def graph_ms(call, x, mask, iters: int, reps: int = 3) -> float:
    """Median device ms of one call: ``iters`` chained calls (each on the
    x or mask the one before wrote, ``_chained``) captured in a CUDA graph
    on a side stream, replayed ``reps`` times between CUDA events."""
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call(x, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        cx, cm = x, mask
        for _ in range(iters):
            cx, cm = _chained(call(cx, cm), x, mask)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def _calls(impl, offsets, weight, bias, radius):
    """(kernel call, plain call, tolerance relative to max|plain|, output
    bytes per element or None for the fused output): each a function of
    (x, mask)."""
    from deft_tpu_torch.ops import cuda_dcn

    bf16_tol = 2.0 ** -7
    if impl == "fused":
        return (lambda x, m: cuda_dcn.deform_conv_fused(
                    x, offsets, m, weight, bias, radius),
                lambda x, m: cuda_dcn.deform_conv_fused_reference(
                    x, offsets, m, weight, bias, radius),
                lambda x: 1e-4 if x.dtype == torch.float32 else bf16_tol,
                None)
    kernel, plain = {
        "sample": (cuda_dcn.deform_sample, cuda_dcn.deform_sample_reference),
        "sample_tap": (cuda_dcn.deform_sample_tap,
                       cuda_dcn.deform_sample_tap_reference),
        "onehot": (cuda_dcn.deform_sample_onehot,
                   cuda_dcn.deform_sample_onehot_reference),
    }[impl]
    return (lambda x, m: kernel(x, offsets, m, radius),
            lambda x, m: plain(x, offsets, m, radius),
            lambda x: (1e-5 if x.dtype == torch.float32 and impl != "onehot"
                       else bf16_tol),
            2 if impl == "onehot" else 0)


def bench_layer(rng, li, impls, regimes, radii, iters: int, dtype):
    """The rows of one layer of ``LAYERS`` (module docstring)."""
    h, w, c, cout, count = LAYERS[li]
    dev = torch.device("cuda")
    x32 = torch.from_numpy(rng.normal(0, 1, (h, w, c)).astype(np.float32)
                           ).to(dev)
    weight = torch.from_numpy((rng.normal(0, 0.05, (KK * c, cout))
                               ).astype(np.float32)).to(dev)
    bias = torch.zeros(cout, dtype=torch.float32, device=dev)
    mask = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.normal(
        0, 0.3, (h, w, KK))))).astype(np.float32)).to(dev)
    shape = f"{h}x{w}x{c}->{cout}"
    rows = []
    if "conv" in impls:
        xc = x32.to(dtype).permute(2, 0, 1)[None].contiguous()
        wc = (weight.reshape(3, 3, c, cout).permute(3, 2, 0, 1).contiguous()
              .to(dtype))

        def conv(xx, m):
            return torch.nn.functional.conv2d(xx, wc, padding=1)

        rows.append({"layer": li, "shape": shape, "impl": "conv",
                     "dtype": str(dtype).replace("torch.", ""),
                     "ms": graph_ms(conv, xc, mask, iters), "count": count})
    for regime in regimes:
        offsets = torch.from_numpy(make_offsets(rng, h, w, KK, regime)
                                   ).to(dev)
        for radius in radii:
            for impl in impls:
                if impl == "conv":
                    continue
                x = x32.to(torch.bfloat16 if impl == "onehot" else dtype)
                kernel, plain, tol_of, out_bytes = _calls(
                    impl, offsets, weight, bias, radius)
                got = kernel(x, mask)
                ref = plain(x, mask)
                err = (got.float() - ref.float()).abs().max().item()
                tol = tol_of(x) * ref.float().abs().max().item()
                if not err <= tol:
                    raise AssertionError(
                        f"{impl} disagrees with its plain version at "
                        f"{shape} {regime} r={radius}: {err} > {tol}")
                sample = grid_sample_yardstick(x, offsets, mask, radius)
                if out_bytes is None:
                    def library(sample=sample):
                        patches = sample().permute(0, 3, 2, 1).reshape(
                            h * w, KK * c)
                        return torch.addmm(bias, patches.float(), weight)
                    bounds = bound_times(h, w, c, x.element_size(), 0, cout)
                else:
                    def library(sample=sample):
                        return sample()
                    bounds = bound_times(h, w, c, x.element_size(),
                                         out_bytes or x.element_size())
                t_bytes, _, t_ops = bounds
                rows.append({
                    "layer": li, "shape": shape, "impl": impl,
                    "kernel": KERNEL_OF[impl], "regime": regime,
                    "radius": radius,
                    "dtype": str(x.dtype).replace("torch.", ""),
                    "ms": graph_ms(kernel, x, mask, iters),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": graph_ms(lambda xx, m: library(), x, mask,
                                           iters),
                    "max_abs_err": err, "count": count})
    return rows


def model_weighted(rows):
    """{(impl, regime, radius): ms per frame} over the model's 16 layers."""
    tot = defaultdict(float)
    for r in rows:
        if r["impl"] != "conv":
            tot[(r["impl"], r["regime"], r["radius"])] += r["ms"] * r["count"]
    return dict(tot)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--impls", default=",".join(IMPLS))
    ap.add_argument("--regimes", default="zero,trained,uniform")
    ap.add_argument("--radius", type=int, nargs="+", default=[4, 2])
    ap.add_argument("--layers", type=int, nargs="+", default=None,
                    help="indices into the layer table (default all)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="x of T1, T2, T3 and conv")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_dcn times the CUDA kernels and needs a "
                           "card: torch.cuda.is_available() is False")
    impls = args.impls.split(",")
    unknown = set(impls) - set(IMPLS)
    if unknown:
        raise ValueError(f"unknown impls {sorted(unknown)}; known: {IMPLS}")
    from deft_tpu_torch.csrc.build import build_all

    build_all()
    rng = np.random.RandomState(0)
    dtype = getattr(torch, args.dtype)
    rows = []
    for li in (args.layers if args.layers else range(len(LAYERS))):
        for row in bench_layer(rng, li, impls, args.regimes.split(","),
                               args.radius, args.iters, dtype):
            print(json.dumps(row), flush=True)
            rows.append(row)
    for (impl, regime, radius), ms in sorted(model_weighted(rows).items()):
        print(f"# model-weighted {impl} regime={regime} r={radius}: "
              f"{ms:.4f} ms per frame (16 layers)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
