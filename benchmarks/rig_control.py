"""Readings that set the rig cell's comparison limits, several seeds in one
process (every seed is a fresh set-up; the kernels build once):

    python3 -m benchmarks.rig_control --workload nuscenes-track \\
        --mode <mode> --seeds <n,n,...> [--seconds S]

* ``program``: a run of the cell as the benchmark makes it, with a window
  of ``--seconds``: the sound program's readings (the lower ones);
* ``control``: the plain reference at float8 (``reference/precision.py``)
  in the program's place over ``control_samples`` samples, judged by the
  float32 reference as the program is, and the plain cascade's LSTM at
  float8 against its float32 steps: the readings of the nearest precision
  below the configuration's bfloat16 (the upper ones);
* ``<fault>``: a run with a fault of ``benchmarks/rig_faults.py`` planted
  under the timed path (``wrong_calib``, ``lstm_reset``,
  ``no_pedestrian_cut``).

The control's similarities are its own float8 ring's, and its tracks the
plain cascade's: it has no ``id_misses`` or ``iou3d_gap`` of its own (both
are host float64 arithmetic with no lower precision to run).

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
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmarks import rig_compare, rig_faults, run
from benchmarks.compare import Geometry, TrackJudge
from benchmarks.program import calibration_indices, program_config
from benchmarks.reference import ddd_ref
from benchmarks.reference.cascade3d import (RING_FRAMES, TRACKED,
                                            RigCascade, route)
from benchmarks.reference.deft_ref import Reference, dla34_spec
from benchmarks.reference.precision import fp8
from benchmarks.rig_program import lstm_state_dict, make_rig_weights
from benchmarks.rig_scenes import make_rig
from benchmarks.scenes import pingpong
from benchmarks.spec import Spec


@torch.no_grad()
def control_records(low: TrackJudge, frames: torch.Tensor,
                    order: Sequence[int], infos, config: dict
                    ) -> tuple:
    """What the rig would hand on with ``low``'s reference in the
    program's place: per camera the decode's peaks, the detections made of
    them, and per class the similarity against a ring of its own
    embeddings -> (records, their infos)."""
    m = low.m
    records: List[rig_compare.CameraRecord] = []
    cam_infos: List[dict] = []
    rings: Dict[str, list] = {c: [] for c in TRACKED}
    ptr = {c: 0 for c in TRACKED}
    for j, s in enumerate(order):
        heads, maps = low.forward(frames[s])
        for k in range(frames.shape[1]):
            info = infos[s][k]
            one = {h: v[k] for h, v in heads.items()}
            d = ddd_ref.decode(one, config["K"], config["out_thresh"])
            res = ddd_ref.camera_results(d, low.geom.to_frame,
                                         np.asarray(info["calib"]))
            rec = rig_compare.CameraRecord(
                d["cell"].astype(np.int64), d["cls"], d["score"], d["bbox"],
                d["tracking"],
                {key: res[key] for key in ("score", "cls", "bbox", "loc",
                                           "dim", "rot_y", "dep")})
            emb = rig_compare.embed_all(low, maps, k, d["bbox"])
            for c, slot in route(res, info).items():
                n = min(len(slot["rows"]), m)
                if not n:
                    continue
                cur = torch.zeros((m, emb.shape[-1]), device=emb.device)
                cur[:n] = emb[torch.as_tensor(slot["rows"][:n],
                                              device=emb.device)]
                ring = torch.zeros((RING_FRAMES,) + tuple(cur.shape),
                                   device=emb.device)
                counts = torch.zeros((RING_FRAMES,), dtype=torch.int32,
                                     device=emb.device)
                for at, (e, cnt) in rings[c]:
                    ring[at], counts[at] = e, cnt
                sims = low.ref.similarity(ring, counts, cur, n)
                rec.updates[c] = (n, sims[:, :, : n + 1].cpu().numpy())
                at = ptr[c] % RING_FRAMES
                rings[c] = [r for r in rings[c] if r[0] != at]
                rings[c].append((at, (cur, n)))
                ptr[c] += 1
            records.append(rec)
            cam_infos.append(info)
        del heads, maps
    return records, cam_infos


def rig_control(config: dict, traffic: dict, seed: int, dev,
                n_samples: int) -> Dict[str, float]:
    """The float8 reference's readings over ``n_samples`` of the rig
    cell's scene, played as a run plays it."""
    from deft_tpu_torch.inference.detector import Detector

    cfg = program_config(config, "test_line")
    spec = dla34_spec(config)
    frames, infos = make_rig(traffic["scene"], seed, dev)
    n_src = frames.shape[0]
    det = Detector(cfg, device=dev)
    calib = frames[calibration_indices(n_src, traffic["calibration_samples"])]
    sd = make_rig_weights(det, config, spec, calib.flatten(0, 1), seed, dev,
                          run.log)
    del det, calib
    geom = Geometry.of(config, frames.shape[2], frames.shape[3])
    judge = rig_compare.RigJudge(
        TrackJudge(Reference(sd, spec), config, geom), frames.shape[1])
    low = TrackJudge(Reference(sd, spec, quant=fp8), config, geom)
    order = [pingpong(j, n_src) for j in range(n_samples)]
    records, cam_infos = control_records(low, frames, order, infos, config)
    cmp = traffic["compare"]
    blocks = rig_compare.choose_blocks(n_samples, cmp["block_samples"],
                                       cmp["blocks"], seed)
    readings = judge.judge(frames, order, records, cam_infos, blocks)
    lstm_sd = lstm_state_dict(seed, "cpu")
    rig = RigCascade(lstm_sd, cfg.max_object, quant=fp8)
    for rec, info in zip(records, cam_infos):
        rec.emitted = {t: (rig_compare.track_vector(box, ddd), s)
                       for t, _, box, s, ddd in rig.step(
                           rec.res, info,
                           {c: u[1] for c, u in rec.updates.items()})}
    _, readings["lstm_rel"], _ = rig_compare.cascade_check(
        records, cam_infos, rig.lstm_steps, lstm_sd, cfg.max_object)
    return readings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="nuscenes-track")
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    spec = Spec(Path.cwd())
    cell = spec.cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "control":
            traffic = spec.traffic(cell["traffic"])
            readings = rig_control(spec.config(cell["config"]), traffic,
                                   seed, dev, int(traffic["control_samples"]))
        else:
            fault = (None if args.mode == "program"
                     else rig_faults.RIG[args.mode])
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
