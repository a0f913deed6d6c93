"""The per-layer metrics that read the program's spans and counters
(``deft_tpu_torch/utils/spans.py``): each reader on hand-made runs, with
None where its key or the trace is missing, and a traced tiny run of the
cell, whose line holds all five.

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmarks import trace
from benchmarks.spec import Spec
from benchmarks.tests.tiny import run_cell

ROOT = Path(__file__).resolve().parents[2]
SPANS = ("dispatch_wait_ms.track", "casc_us_per_track.track",
         "idle_program.track", "idle_casc_wait.track",
         "idle_frame_in.track")
TIMINGS = {"dispatch": 30.0, "dispatch.cpu": 22.5, "casc_track": 12.0,
           "n.tracks_held": 80.0}
IDLE = {"gaps under 50 us": 1.0,
        "host: submit": 0.05,
        "host: dispatch / aten::conv2d": 0.4,
        "host: program.forward": 0.3,
        "host: runner.fetch / aten::cat": 0.1,
        "host: casc_wait": 0.6,
        "host: warp": 0.2,
        "host: runner.slab_wait": 0.1,
        "host: upload / aten::to": 0.06,
        "host: outside the benchmark's spans": 0.04}
WANT = {"dispatch_wait_ms.track": 7.5, "casc_us_per_track.track": 150.0,
        "idle_program.track": 20.0, "idle_casc_wait.track": 15.0,
        "idle_frame_in.track": 9.0}


def reader(name):
    return Spec(ROOT).reader(name)


def run_of(timings=TIMINGS, idle=IDLE, window_s=4.0):
    trace = None if idle is None else {"window_s": window_s, "busy_s": 0.5,
                                       "idle": dict(idle), "kernels": {}}
    return SimpleNamespace(window={"timings": dict(timings)}, trace=trace)


@pytest.mark.parametrize("name", SPANS)
def test_reader_values(name):
    assert reader(name)(run_of()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPANS)
def test_reader_none_where_missing(name):
    read = reader(name)
    assert read(run_of(timings={}, idle=None)) is None
    if name.startswith("idle_"):
        # a program without spans: every gap under the cell's own span
        parent = {"gaps under 50 us": 1.0, "host: submit": 1.4,
                  "host: submit / aten::to": 0.2}
        assert read(run_of(idle=parent)) is None
        assert read(run_of(idle=IDLE, window_s=0.0)) is None
    else:
        key = "dispatch.cpu" if name.startswith("dispatch") else (
            "n.tracks_held")
        timings = {k: v for k, v in TIMINGS.items() if k != key}
        assert read(run_of(timings=timings)) is None


def test_entries_read_the_spans():
    spec = Spec(ROOT)
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    for name in SPANS:
        m = entries[name]
        assert m["workloads"] == ["mot17-track"]
        assert m["moves"] == "track_fps"
    cell = spec.cell("mot17-track")
    assert set(SPANS) <= {m["name"] for m in spec.metrics(cell, True)}


def test_traced_tiny_run_prints_all_five(monkeypatch):
    """The CPU's trace has no device events, so its one gap would be named
    by whatever span lies at the stretch's middle: a device is simulated
    that runs each operator as the host calls it, and idles between
    them."""
    reduce_events = trace.reduce_events

    def with_device(events, window_s):
        device = [{"ph": "X", "cat": "kernel", "name": "simulated",
                   "ts": e["ts"], "dur": e["dur"]} for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
        return reduce_events(events + device, window_s)

    monkeypatch.setattr(trace, "reduce_events", with_device)
    line = run_cell("mot17-track", seconds=6.0, trace=1)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    assert set(SPANS) <= set(metrics), set(SPANS) - set(metrics)
    assert metrics["dispatch_wait_ms.track"]["value"] >= 0
    assert metrics["casc_us_per_track.track"]["value"] > 0
    idle = sum(metrics[n]["value"] for n in SPANS if n.startswith("idle_"))
    assert 0 < idle <= metrics["device_idle.track"]["value"] + 1e-6
