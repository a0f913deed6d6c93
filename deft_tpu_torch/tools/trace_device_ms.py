"""Device-busy time per frame from the chrome trace that ``python -m
deft_tpu_torch.bench --profile DIR`` writes (``DIR/trace.json``, a
``torch.profiler`` trace), the counterpart of ``tools/trace_device_ms.py``:

    python -m deft_tpu_torch.tools.trace_device_ms DIR --frames 60

For each device lane of the trace (its ``pid``), the union of the
intervals of its CUDA kernels, memory copies and memsets (union, not sum, so
that kernels overlapping on several streams count once), as the JAX tool
takes the union of each device's 'X' events.  ``--frames`` is the number of
frames the trace covers: the bench traces its timed passes, three of
``--frames`` each (one under ``--smoke``).  Prints one JSON line:
``busy_ms[device <pid>]`` per lane, ``device_busy_ms_total``,
``device_span_ms`` (first to last device event), ``busy_share`` (busy over
span) and, with ``--frames``, ``device_ms_per_frame``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, in
    ms (``tools/trace_device_ms.py::union_ms``)."""
    total = 0.0
    end = -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1000.0


def load_trace(path: str) -> dict:
    """The trace of ``path``: a chrome-trace file (``.json`` or
    ``.json.gz``) or a directory holding ``trace.json``."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_busy(trace: dict, frames: int = 0) -> dict:
    """The JSON record of the module docstring for a loaded trace."""
    lanes = defaultdict(list)
    for e in trace.get("traceEvents", []):
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") in DEVICE_CATEGORIES):
            lanes[e["pid"]].append((float(e["ts"]),
                                    float(e["ts"]) + float(e["dur"])))
    out = {"frames": frames}
    busy_total, first, last = 0.0, None, None
    for pid, iv in sorted(lanes.items(), key=lambda kv: str(kv[0])):
        busy = union_ms(iv)
        out[f"busy_ms[device {pid}]"] = round(busy, 3)
        busy_total += busy
        lo, hi = min(s for s, _ in iv), max(e for _, e in iv)
        first = lo if first is None else min(first, lo)
        last = hi if last is None else max(last, hi)
    out["device_busy_ms_total"] = round(busy_total, 3)
    span = (last - first) / 1000.0 if lanes else 0.0
    out["device_span_ms"] = round(span, 3)
    out["busy_share"] = round(busy_total / span, 4) if span else 0.0
    if frames and busy_total:
        out["device_ms_per_frame"] = round(busy_total / frames, 3)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="the --profile directory or a trace file")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames the trace covers (for the per-frame ms)")
    args = ap.parse_args(argv)
    out = device_busy(load_trace(args.trace), args.frames)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
