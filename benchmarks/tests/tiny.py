"""Tiny sizes at which the benchmark's tests run a cell on the CPU: the
cell's own files, with the input, the scene, the objects per frame and the
ring cut down, and the program in float32 (the CPU has no fast bfloat16)."""

from __future__ import annotations

import contextlib
import io
import json

import torch

from benchmarks import run

SCENE = {"height": 240, "width": 400, "objects": 12,
         "size": {"mode": "pixels", "height": [20, 80], "aspect": [0.35, 0.5]},
         "speed": [1.0, 3.0]}
CELLS = {
    "mot17-track": {
        "config": {"input_h": 128, "input_w": 192, "max_object": 16,
                   "sim_window": 3, "detections_per_frame": [5],
                   "box_prior_cells": [3, 8],
                   "test_line": ["tracking", "--dataset", "mot",
                                 "--ltrb_amodal", "--track_thresh", "0.4",
                                 "--pre_thresh", "0.5", "--max_object", "16",
                                 "--sim_window", "3"]},
        "traffic": {"scene": {**SCENE, "frames": 8}, "warmup_chunks": 1,
                    "trace_seconds": 1, "control_frames": 12,
                    "compare": {"blocks": 1, "sim_frames": 3}}}
}


def run_cell(cell: str, seconds: float = 4.0, trace: int = 0, fault=None,
             seed: int = 2 ** 33 + 5) -> dict:
    """One run of ``cell`` at its tiny size on the CPU -> its result line
    (the harness's look for a chip skipped, the rest as a run)."""
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      device=torch.device("cpu"), overrides=CELLS[cell],
                      fault=fault)
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cell_files(cell: str):
    """(configuration, traffic, limits) of ``cell`` at its tiny size."""
    from pathlib import Path

    from benchmarks.spec import Spec

    spec = Spec(Path(__file__).resolve().parents[2])
    entry = spec.cell(cell)
    config = {**spec.config(entry["config"]), **CELLS[cell]["config"]}
    traffic = {**spec.traffic(entry["traffic"]), **CELLS[cell]["traffic"]}
    return config, traffic, spec.limits(cell)
