"""The device trace of a traced run, reduced to what the metrics read.

``DeviceTrace`` wraps ``torch.profiler`` (CPU and CUDA activity) around a
stretch of the measured window.  ``summary()`` exports the chrome trace to a
temporary file, reads it and removes it, and returns:

* ``window_s``: the traced stretch, by the host's clock;
* ``busy_s``: the union of the device's kernel, copy and memset intervals
  inside it (a union, so that overlapping streams count once), over the
  traced stretch and not over the first-to-last device event, so idle time
  at the stretch's ends counts as idle;
* ``kernels``: seconds per kernel name;
* ``idle``: the device's idle seconds by what the host was doing
  meanwhile: the innermost span (the benchmark's own ``record_function``,
  or one of PyTorch's, such as the optimizer's step) and the outermost
  operator of the spans' threads at the gap's middle (gaps under 50 us, the
  launch-to-launch spacing of a busy queue, are lumped together).
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120
SHORT_GAP_US = 50.0    # idle gaps shorter than this are lumped, not named


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    def __init__(self):
        self.cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return reduce_events(events, self.t1 - self.t0)


def reduce_events(events: List[dict], window_s: float) -> dict:
    """The summary of the module docstring from chrome-trace events."""
    device, kernels = [], defaultdict(float)
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("cpu_op", "user_annotation")]
    for e in events:
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") in DEVICE_CATEGORIES):
            s = float(e["ts"])
            device.append((s, s + float(e["dur"])))
            if e.get("cat") == "kernel":
                kernels[e.get("name", "?")[:NAME_CHARS]] += (
                    float(e["dur"]) * 1e-6)
    busy = union(device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # the traced stretch on the trace's clock: from the first to the last
    # host or device event, widened to the host clock's length
    stamps = [float(e["ts"]) for e in host] + [s for s, _ in device]
    ends = ([float(e["ts"]) + float(e["dur"]) for e in host]
            + [e for _, e in device])
    start = min(stamps) if stamps else 0.0
    end = max(max(ends) if ends else 0.0, start + window_s * 1e6)
    gaps, prev = [], start
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if end > prev:
        gaps.append((prev, end))
    return {"window_s": window_s, "busy_s": busy_s,
            "kernels": dict(kernels), "idle": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the main thread's span and outermost operator at
    each gap's middle."""
    spans = [e for e in host if e.get("cat") == "user_annotation"]
    tids = {e.get("tid") for e in spans}
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "?")) for e in host
                 if e.get("cat") == "cpu_op" and e.get("tid") in tids)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")) for e in spans)
    op_starts = [s for s, _, _ in ops]
    span_starts = [s for s, _, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_US:
            out[f"gaps under {SHORT_GAP_US:.0f} us"] += (g1 - g0) * 1e-6
            continue
        mid = 0.5 * (g0 + g1)
        # the innermost span covering mid: the latest-starting one
        j = bisect.bisect_right(span_starts, mid)
        span = next((n for s, e, n in reversed(spans[max(0, j - 64): j])
                     if e >= mid), None)
        op = None
        i = bisect.bisect_right(op_starts, mid)
        # the outermost operator covering mid: the earliest-starting one
        for s, e, n in ops[max(0, i - 200): i]:
            if e >= mid:
                op = n
                break
        name = "host: " + (span or "outside the benchmark's spans")
        if op:
            name += " / " + op
        out[name[:NAME_CHARS]] += (g1 - g0) * 1e-6
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
