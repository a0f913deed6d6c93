"""Where T4's time goes on the card: ``dcn_onehot.cu`` built whole and with
its phases taken out, and run under every tile and channel slice that
``plan_onehot`` could pick, at the 7 DLA-34 DCNv2 layer shapes.

    python3 -m deft_tpu_torch.tools.ablate_onehot [--no-sweep]

Variants (an ``#ifdef`` return at the top of a phase's lambda, as
``ablate_fused.py`` does for T3):

* ``full``: the kernel as it is, checked against the plain version;
* ``no_fill``: the window is not staged (the samples read whatever shared
  memory holds); entries, blends and stores stay;
* ``no_sample``: no blend and no store; the window fill and the entries
  stay;
* ``overhead``: both, leaving the entries, the barriers and the launch.

Only ``full`` computes the function.  The sweep runs ``full`` under every
(tile, slice) of ``cuda_dcn.ONEHOT_TILES`` x ``ONEHOT_SLICES`` whose window
fits, checks each against the plain version, and marks the planner's
choice.  Float32 x, 'trained' offsets, radius 4.  Times are device ms per
call: 20 calls captured in a CUDA graph, replayed 7 times, median.  Prints
one JSON line per variant, with per-layer times and the per-frame sum over
the 16 layers, then one per swept layer, then the card's ``nvidia-smi``
name and power limit.
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

PHASES = {"fill": "ABLATE_NO_FILL", "blend_store": "ABLATE_NO_SAMPLE"}
VARIANTS = {"full": (), "no_fill": ("ABLATE_NO_FILL",),
            "no_sample": ("ABLATE_NO_SAMPLE",),
            "overhead": ("ABLATE_NO_FILL", "ABLATE_NO_SAMPLE")}


def entry(lib_path: Path):
    """``dcn_sample_onehot`` of a library built from ``dcn_onehot.cu``."""
    fn = ctypes.CDLL(str(lib_path)).dcn_sample_onehot
    fn.argtypes = cuda_dcn._SIGNATURES["dcn_onehot"]["dcn_sample_onehot"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, x, offsets, mask, plan):
    """A closure that runs one call of ``fn`` on ``plan`` (an
    ``OnehotPlan``) into a bf16 buffer allocated once."""
    h, w, c = x.shape
    out = torch.empty((h * w, 9 * c), dtype=torch.bfloat16, device=x.device)

    def run():
        err = fn(x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), h, w, c, RADIUS, 0, plan.tile_h, plan.tile_w,
                 plan.slice_c, plan.smem_bytes,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"dcn_sample_onehot launch failed: CUDA "
                               f"error {err}")
        return out

    return run


def check(run, args, what):
    got = run().float()
    ref = cuda_dcn.deform_sample_onehot_reference(*args, RADIUS).float()
    err = (got - ref).abs().max().item()
    if not err <= 2.0 ** -7 * ref.abs().max().item():
        raise AssertionError(f"{what} disagrees with the plain version: {err}")
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-sweep", action="store_true",
                        help="skip the sweep over tiles and slices")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_onehot: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_all({"onehot": build.CSRC / "dcn_onehot.cu"}, list(VARIANTS),
                     PHASES, VARIANTS)
    rng = np.random.RandomState(SEED)
    inputs = [layer_inputs(rng, h, w, c, cout, dev)[:3]
              for h, w, c, cout, _ in LAYERS]
    plans = [cuda_dcn.plan_onehot(h, w, c, RADIUS, sms)
             for h, w, c, _, _ in LAYERS]

    for variant in VARIANTS:
        fn = entry(libs["onehot", variant])
        rows = []
        for (h, w, c, cout, count), layer_args, plan in zip(LAYERS, inputs,
                                                             plans):
            run = launcher(fn, *layer_args, plan)
            row = {"shape": [h, w, c, cout], "count": count,
                   "plan": plan._asdict()}
            if variant == "full":
                row["max_abs_err"] = check(run, layer_args,
                                           f"full at {(h, w, c)}")
            row["ms"] = graph_ms(run)
            rows.append(row)
        print(json.dumps({"kind": "variant", "variant": variant,
                          "ms_per_frame": sum(r["ms"] * r["count"]
                                              for r in rows),
                          "layers": rows}), flush=True)

    fn = entry(libs["onehot", "full"])
    for (h, w, c, cout, count), layer_args, chosen in zip(
            [] if args.no_sweep else LAYERS, inputs, plans):
        rows = []
        for cs in cuda_dcn.ONEHOT_SLICES:
            for th, tw in cuda_dcn.ONEHOT_TILES:
                plan = cuda_dcn._onehot_plan(h, w, c, RADIUS, th, tw, cs)
                if plan.smem_bytes > cuda_dcn.SMEM_PER_BLOCK:
                    continue
                run = launcher(fn, *layer_args, plan)
                check(run, layer_args, f"plan {plan} at {(h, w, c)}")
                rows.append({"tile": [th, tw], "slice_c": cs,
                             "blocks": plan.blocks,
                             "smem_bytes": plan.smem_bytes,
                             "chosen": plan == chosen, "ms": graph_ms(run)})
        best = min(rows, key=lambda r: r["ms"])
        print(json.dumps({"kind": "sweep", "build": "full",
                          "shape": [h, w, c, cout], "count": count,
                          "best": best, "plans": rows}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
