"""Each cell run end to end on the CPU at a tiny size: a sound program is
judged correct, and each fault the cell can have, planted under the timed
path, is judged not correct by the cell's own limits.

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import pytest

from benchmarks import faults
from benchmarks.tests.tiny import run_cell

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_sound_program_is_correct():
    line = run_cell("mot17-track")
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    metrics = line["metrics"]
    assert set(metrics) == {"track_fps", "setup_s"}
    assert metrics["track_fps"]["value"] > 0
    assert metrics["setup_s"]["value"] > 0
    assert line["device"]["count"] == 1
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_traced_run_reports_per_layer_metrics():
    line = run_cell("mot17-track", seconds=6.0, trace=1)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # no kernel runs on the CPU: the roofline reader finds nothing
    assert set(line["metrics"]) == {"dispatch_ms.track", "cascade_ms.track",
                                    "mfu.track", "device_idle.track"}


@pytest.mark.parametrize("fault", sorted(faults.TRACK))
def test_track_fault_is_not_correct(fault):
    line = run_cell("mot17-track", fault=faults.TRACK[fault])
    assert not line["correct"], line["checks"]
