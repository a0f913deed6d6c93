"""Readings that set a cell's comparison limits, several seeds in one
process (every seed is a fresh set-up; the kernels build once):

    python3 -m benchmarks.control --workload <cell> --mode <mode> \\
        --seeds <n,n,...> [--seconds S]

* ``program``: a run of the cell as the benchmark makes it, with a window
  of ``--seconds``: the sound program's readings (the lower ones);
* ``control``: the plain reference at float8 (``reference/precision.py``)
  in the program's place, judged by the float32 reference as the program
  is: the readings of the nearest precision below the configuration's
  bfloat16 (the upper ones);
* ``<fault>``: a run with a fault of ``benchmarks/faults.py`` planted
  under the timed path (``stale_ring``, ``half_chunk``, ``empty_half``,
  ``swapped_ids``, ``altered_score``).

The control hands no tracks: its readings have no ``id_misses``.

Prints, per seed, one JSON line ``{"seed", "mode", "readings"}`` last on
standard output; a run's own result line comes before it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import torch

from benchmarks import compare, faults, run, scenes
from benchmarks.program import (calibration_indices, make_weights,
                                program_config)
from benchmarks.reference.deft_ref import Reference, dla34_spec
from benchmarks.reference.precision import fp8
from benchmarks.spec import Spec


def track_control(config, traffic, seed, dev, n_frames):
    """The float8 reference's readings over ``n_frames`` of a track cell's
    scene, played as a run plays it."""
    from deft_tpu_torch.models.factory import create_model

    cfg = program_config(config, "test_line")
    spec = dla34_spec(config)
    frames, _ = scenes.make_scene(traffic["scene"], seed, dev)
    n_src = frames.shape[0]
    model = create_model(cfg.arch, cfg, dev)
    sd = make_weights(model, config, spec, frames[calibration_indices(
        n_src, traffic["calibration_frames"])], seed, dev, run.log)
    del model
    geom = compare.Geometry.of(config, frames.shape[1], frames.shape[2])
    judge = compare.TrackJudge(Reference(sd, spec), config, geom)
    low = compare.TrackJudge(Reference(sd, spec, quant=fp8), config, geom)
    order = [scenes.pingpong(j, n_src) for j in range(n_frames)]
    records = compare.records_from_reference(low, frames, order, n_frames,
                                             config["sim_window"])
    cmp = traffic["compare"]
    blocks = compare.choose_blocks(
        n_frames, config["sim_window"] + cmp["sim_frames"], cmp["blocks"],
        seed)
    return judge.judge(frames, order, records, blocks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    spec = Spec(Path.cwd())
    cell = spec.cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "control":
            config = spec.config(cell["config"])
            traffic = spec.traffic(cell["traffic"])
            readings = track_control(config, traffic, seed, dev,
                                     int(traffic["control_frames"]))
        else:
            fault = None
            if args.mode != "program":
                fault = faults.TRACK[args.mode]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run.main(["--workload", args.workload, "--seed", str(seed),
                          "--seconds", str(args.seconds), "--trace", "0"],
                         fault=fault)
            line = out.getvalue().strip().splitlines()[-1]
            print(line, flush=True)
            readings = {k: v["value"]
                        for k, v in json.loads(line)["checks"].items()}
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "readings": readings}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
