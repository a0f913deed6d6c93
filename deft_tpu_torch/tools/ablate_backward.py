"""Where T5's time goes on the card: ``dcn_backward.cu``'s two routes side by
side, its tiled kernel built whole and with its phases taken out, and run
under every tile and channel slice that ``plan_backward`` could pick, at the
7 DLA-34 DCNv2 layer shapes of a 544x960 frame.

    python3 -m deft_tpu_torch.tools.ablate_backward [--no-sweep]

Routes (both checked against ``deform_sample_backward_reference``, on a
float32 and on a bfloat16 x and g): ``entry``, the unclamped route
(``dcn_backward``: a warp per (pixel, tap), four global atomics per sampled
element), and ``tiled`` (``dcn_backward_tiled`` on ``plan_backward``'s
plan).  Variants of the tiled kernel, float32 (an ``#ifdef`` return at the
top of a phase's lambda, as ``ablate_onehot.py`` does for T4, or a macro):

* ``full``: the kernel as it is;
* ``no_flush``: the dx window is not added into dx (no global write of dx
  at all);
* ``no_fill``: the x window is not staged (the sums read whatever shared
  memory holds);
* ``no_sums``: g is not read: no sums, no rows of g staged (the scatter
  adds whatever shared memory holds);
* ``no_scatter``: nothing is added into the dx window (the bins are still
  built);
* ``scalar_flush``: the flush adds four scalar float atomics per cell and 4
  channels in place of one float4 ``atomicAdd`` (``red.global.add.v4.f32``).

Only ``full`` and ``scalar_flush`` compute the function.  The sweep runs
the tiled kernel under every (tile, slice) of ``cuda_dcn.BACKWARD_TILES`` x
``BACKWARD_SLICES`` whose shared memory fits, each with 1, 2, 4 and 8
slices a block (and the planner's number), checks each against the plain
version, and marks the planner's choice.  'Trained' offsets (N(0, 0.5)
clipped to +-2 px), radius 4, g N(0, 1).  Times are device ms per call,
dx's zeroing included (the wrapper allocates it zeroed): 20 calls captured
in a CUDA graph, replayed 7 times, median.  Prints one JSON line per route
and dtype, per variant and per swept layer, with per-layer times and the
per-frame sum over the 16 layers, a summary line, then the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from deft_tpu_torch.csrc import build
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.tools.ablate_fused import (LAYERS, RADIUS, SEED, build_all,
                                               graph_ms, layer_inputs)

PHASES = {"fill": "ABLATE_NO_FILL", "sums": "ABLATE_NO_SUMS",
          "scatter": "ABLATE_NO_SCATTER", "flush": "ABLATE_NO_FLUSH"}
VARIANTS = {"full": (), "no_flush": ("ABLATE_NO_FLUSH",),
            "no_fill": ("ABLATE_NO_FILL",), "no_sums": ("ABLATE_NO_SUMS",),
            "no_scatter": ("ABLATE_NO_SCATTER",),
            "scalar_flush": ("ABLATE_SCALAR_FLUSH",)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def entries(lib_path: Path):
    """(``dcn_backward``, ``dcn_backward_tiled``) of a library built from
    ``dcn_backward.cu``."""
    lib = ctypes.CDLL(str(lib_path))
    fns = []
    for name in ("dcn_backward", "dcn_backward_tiled"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_dcn._SIGNATURES["dcn_backward"][name]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def launcher(fn, g, x, offsets, mask, plan=None):
    """A closure that zeroes dx and runs one call of ``fn`` (the tiled
    entry on ``plan``, a ``BackwardPlan``; the unclamped one for None) into
    buffers allocated once, as ``cuda_dcn.deform_sample_backward`` does."""
    h, w, c = x.shape
    dev = x.device
    dx = torch.zeros((h, w, c), dtype=torch.float32, device=dev)
    doffsets = torch.empty((h, w, 9, 2), dtype=torch.float32, device=dev)
    dmask = torch.empty((h, w, 9), dtype=torch.float32, device=dev)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=dev)
          if plan is not None and plan.workspace else None)
    dt = (cuda_dcn._DTYPES[x.dtype], cuda_dcn._DTYPES[g.dtype])
    ptrs = (g.data_ptr(), x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            dx.data_ptr(), doffsets.data_ptr(), dmask.data_ptr())

    def run():
        dx.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan is None:
            err = fn(*ptrs, h, w, c, RADIUS, *dt, stream)
        else:
            err = fn(*ptrs, None if ws is None else ws.data_ptr(), h, w, c,
                     RADIUS, *dt, plan.tile_h, plan.tile_w, plan.slice_c,
                     plan.slice_run, plan.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dcn_backward launch failed: CUDA error {err}")
        return dx, doffsets, dmask

    return run


def check(run, args, what):
    """The worst error against the plain version; doffsets and dmask within
    1e-5 x max|plain|, dx within 1e-5 x max|plain| in float32 and one bf16
    step (2^-7 x max|plain|) where x is bf16, as ``chip_smoke.py``'s
    ``backward_row``."""
    got = [t.float() for t in run()]
    ref = cuda_dcn.deform_sample_backward_reference(*args, RADIUS)
    bf16 = args[1].dtype == torch.bfloat16
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        b = b.float()
        err = (a - b).abs().max().item()
        tol = (2.0 ** -7 if i == 0 and bf16 else 1e-5) * b.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{what}: output {i} disagrees with the "
                                 f"plain version: {err} > {tol}")
        worst = max(worst, err)
    return worst


def frame_line(kind, rows, **extra):
    return {"kind": kind, **extra,
            "ms_per_frame": sum(r["ms"] * r["count"] for r in rows),
            "layers": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-sweep", action="store_true",
                        help="skip the sweep over tiles and slices")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_backward: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_all({"backward": build.CSRC / "dcn_backward.cu"},
                     list(VARIANTS), PHASES, VARIANTS)
    rng = np.random.RandomState(SEED)
    inputs = []
    for h, w, c, cout, _ in LAYERS:
        x, offsets, mask = layer_inputs(rng, h, w, c, cout, dev)[:3]
        g = torch.from_numpy(rng.normal(0, 1, (h * w, 9 * c)).astype(
            np.float32)).to(dev)
        inputs.append((g, x, offsets, mask))

    def layer_args(i, dtype):
        g, x, offsets, mask = inputs[i]
        return g.to(dtype), x.to(dtype), offsets, mask

    def plan_of(i, dtype):
        h, w, c, _, _ = LAYERS[i]
        return cuda_dcn.plan_backward(h, w, c, RADIUS, sms,
                                      torch.finfo(dtype).bits // 8)
    c8 = lambda c: -(-c // 8) * 8                          # noqa: E731

    entry_fn, tiled_fn = entries(libs["backward", "full"])
    per_route = {}
    for dname, dtype in DTYPES.items():
        for route in ("entry", "tiled"):
            rows = []
            for i, (h, w, c, cout, count) in enumerate(LAYERS):
                a = layer_args(i, dtype)
                plan = plan_of(i, dtype) if route == "tiled" else None
                run = launcher(entry_fn if plan is None else tiled_fn, *a,
                               plan=plan)
                row = {"shape": [h, w, c, cout], "count": count,
                       "max_abs_err": check(run, a, f"{route} {dname} at "
                                                    f"{(h, w, c)}"),
                       "ms": graph_ms(run)}
                if plan is not None:
                    row["plan"] = dict(plan._asdict(), blocks=plan.blocks,
                                       smem_bytes=plan.smem_bytes,
                                       resident=plan.resident)
                rows.append(row)
            per_route[route, dname] = rows
            print(json.dumps(frame_line("route", rows, route=route,
                                        dtype=dname)), flush=True)

    for variant in VARIANTS:
        _, fn = entries(libs["backward", variant])
        rows = []
        for i, (h, w, c, cout, count) in enumerate(LAYERS):
            a = layer_args(i, torch.float32)
            run = launcher(fn, *a, plan=plan_of(i, torch.float32))
            row = {"shape": [h, w, c, cout], "count": count}
            if variant in ("full", "scalar_flush"):
                row["max_abs_err"] = check(run, a, f"{variant} at "
                                                   f"{(h, w, c)}")
            row["ms"] = graph_ms(run)
            rows.append(row)
        print(json.dumps(frame_line("variant", rows, variant=variant,
                                    dtype="float32")), flush=True)

    for i, (h, w, c, cout, count) in enumerate([] if args.no_sweep
                                               else LAYERS):
        a = layer_args(i, torch.float32)
        chosen = plan_of(i, torch.float32)
        rows = []
        for cs in cuda_dcn.BACKWARD_SLICES:
            for th, tw in cuda_dcn.BACKWARD_TILES:
                planned = cuda_dcn._backward_plan(h, w, c, RADIUS, th, tw, cs,
                                                  sms=sms)
                if (cs > c8(c)
                        or planned.smem_bytes > cuda_dcn.SMEM_PER_BLOCK):
                    continue
                for plan in {planned._replace(slice_run=n) for n in
                             (1, 2, 4, 8, planned.slice_run)
                             if n <= planned.slices}:
                    run = launcher(tiled_fn, *a, plan=plan)
                    check(run, a, f"plan {plan} at {(h, w, c)}")
                    rows.append({"tile": [th, tw], "slice_c": cs,
                                 "slice_run": plan.slice_run,
                                 "blocks": plan.blocks,
                                 "resident": plan.resident,
                                 "smem_bytes": plan.smem_bytes,
                                 "cost": cuda_dcn.backward_busiest_sm(
                                     plan, RADIUS, sms),
                                 "chosen": plan == chosen,
                                 "ms": graph_ms(run)})
        best = min(rows, key=lambda r: r["ms"])
        print(json.dumps({"kind": "sweep", "dtype": "float32",
                          "shape": [h, w, c, cout], "count": count,
                          "best": best, "plans": rows}), flush=True)

    faster = {dname: all(t["ms"] < e["ms"] for t, e in zip(
        per_route["tiled", dname], per_route["entry", dname]))
        for dname in DTYPES}
    frame = {f"{route} {dname}": sum(r["ms"] * r["count"] for r in rows)
             for (route, dname), rows in per_route.items()}
    print(json.dumps({"kind": "summary", "ms_per_frame": frame,
                      "tiled_faster_at_every_layer": faster,
                      "tiled_over_entry_float32":
                          frame["tiled float32"] / frame["entry float32"]}),
          flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
