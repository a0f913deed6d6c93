"""The rig cell run end to end on the CPU at a tiny size: a sound program is
judged correct, a traced run reports the rig's per-layer metrics, each
fault the rig can have, planted under the timed path, is judged not
correct by the cell's own limits, and the float8 control fails them.

    python -m pytest -q benchmarks/tests/test_benchmarks_rig.py
"""

from __future__ import annotations

import contextlib
import io
import json

from pathlib import Path

import pytest
import torch

from benchmarks import rig_control, rig_faults, run
from benchmarks.spec import Spec

CELL = "nuscenes-track"
SCENE = {"height": 180, "width": 320, "samples": 3, "cameras": 6,
         "ego_step_m": 3.0, "radius_m": 30.0}
TINY = {
    "config": {"input_h": 96, "input_w": 160, "max_object": 16, "K": 40,
               "camera_share": {"car": 0.9, "truck": 0.35, "bus": 0.12,
                                "trailer": 0.12, "pedestrian": 0.6,
                                "motorcycle": 0.12, "bicycle": 0.12},
               "detections_per_frame": {
                   "car": 1.5, "truck": 0.4, "bus": 0.15, "trailer": 0.15,
                   "pedestrian": 0.8, "motorcycle": 0.15, "bicycle": 0.15,
                   "construction_vehicle": 0.1, "traffic_cone": 0.3,
                   "barrier": 0.3},
               "box_prior_cells": [3, 3],
               "test_line": ["tracking,ddd", "--dataset", "nuscenes",
                             "--nuscenes_att", "--velocity",
                             "--track_thresh", "0.1", "--nms",
                             "--max_object", "16", "--K", "40"]},
    "traffic": {"warmup_samples": 1, "calibration_samples": 2,
                "trace_seconds": 1, "control_samples": 4,
                "compare": {"blocks": 1, "block_samples": 2}}}
RIG_METRICS = {"pre_ms.rig", "detect_ms.rig", "track_ms.rig",
               "iou3d_us_per_pair.rig", "lstm_ms.rig", "device_idle.track",
               "mfu.track", "dcn_fwd_roofline.track"}
SEED = 2 ** 33 + 7


def cell_files():
    """(configuration, traffic, limits) of the cell as its files give
    them."""
    spec = Spec(Path(__file__).resolve().parents[2])
    entry = spec.cell(CELL)
    return (spec.config(entry["config"]), spec.traffic(entry["traffic"]),
            spec.limits(CELL))


def overrides():
    _, traffic, _ = cell_files()
    scene = {**traffic["scene"], **SCENE}
    return {"config": TINY["config"],
            "traffic": {**TINY["traffic"], "scene": scene}}


def run_rig(seconds=6.0, trace=0, fault=None, seed=SEED) -> dict:
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      device=torch.device("cpu"), overrides=overrides(),
                      fault=fault)
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_rig_is_correct():
    line = run_rig()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"track_fps", "setup_s"}
    assert line["metrics"]["track_fps"]["value"] > 0
    assert set(line["checks"]) == set(cell_files()[2])


def test_traced_rig_reports_per_layer_metrics():
    line = run_rig(trace=1)
    assert line["correct"], line["checks"]
    # no kernel runs on the CPU: the roofline reader finds nothing
    assert set(line["metrics"]) == RIG_METRICS - {"dcn_fwd_roofline.track"}
    assert line["metrics"]["iou3d_us_per_pair.rig"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(rig_faults.RIG))
def test_rig_fault_is_not_correct(fault):
    line = run_rig(fault=rig_faults.RIG[fault])
    assert not line["correct"], line["checks"]


def test_rig_control_fails():
    torch.set_num_threads(2)
    config, traffic, limits = cell_files()
    o = overrides()
    readings = rig_control.rig_control({**config, **o["config"]},
                                       {**traffic, **o["traffic"]}, SEED,
                                       torch.device("cpu"), 4)
    assert readings["frames"] > 0
    assert any(readings[k] > limit for k, limit in limits.items()
               if k in readings), (readings, limits)
