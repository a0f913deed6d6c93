"""The harness finds a cell's configuration, traffic, limits, driver and
metric readers by the names in ``BENCHMARK.json``, and a cell added as
files alone runs; the benchmark file keeps to its contract's shape."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from benchmarks import run
from benchmarks.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def test_every_piece_is_found_by_name():
    spec = Spec(ROOT)
    for cell in spec.bench["workloads"]:
        config = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
        limits = spec.limits(cell["name"])
        assert config["name"] == cell["config"]
        assert hasattr(spec.driver(traffic["kind"]), "run")
        assert limits and all(v >= 0 for v in limits.values())
        for trace in (False, True):
            metrics = spec.metrics(cell, trace)
            assert metrics
            if trace:
                for m in metrics:
                    assert callable(spec.reader(m["name"]))
        assert "setup_s" in [m["name"] for m in spec.metrics(cell, False)]


def test_benchmark_file_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    assert all(set(n) <= NAME_CHARS and len(n) <= 64 for n in names)
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert len(cell["why"]) <= 200 and cell["chips"] == 1
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
    used = {c["config"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmarks/")


DUMMY_DRIVER = '''
from types import SimpleNamespace


def run(ctx):
    return {"end_to_end": {"dummy_rate": 2.5, "setup_s": 0.5},
            "layer": SimpleNamespace(value=ctx.traffic["value"]),
            "checks": {"gap": 0.1}, "attempted": 3, "failed": 0,
            "memory_peak_bytes": 0,
            "trace": {"busy_s": 0.25, "window_s": 1.0},
            "breakdown": {"device_ops": [], "idle_gaps": []}}
'''
DUMMY_READER = '''
def read(run):
    return run.value * 2
'''


def test_cell_added_as_files_alone(tmp_path, monkeypatch, capsys):
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy", "config": "mot17-dla34-bf16",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a cell of files alone"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy"]})
    bench["per_layer"].append({"name": "dummy_layer", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "dummy", "moves": "dummy_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = tmp_path / "benchmarks"
    (pkg / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"kind": "dummy", "value": 21}))
    (pkg / "cells" / "dummy.py").write_text(DUMMY_DRIVER)
    (pkg / "limits" / "dummy.json").write_text(json.dumps({"gap": 0.2}))
    (pkg / "metrics" / "dummy_layer.py").write_text(DUMMY_READER)
    monkeypatch.chdir(tmp_path)
    for trace, metric, value in ((0, "dummy_rate", 2.5),
                                 (1, "dummy_layer", 42)):
        rc = run.main(["--workload", "dummy", "--seed", "1", "--seconds",
                       "1", "--trace", str(trace)],
                      device=torch.device("cpu"))
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metrics"][metric]["value"] == value
        assert line["correct"] and line["checks"]["gap"]["limit"] == 0.2


def test_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload", "mot17-track",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
