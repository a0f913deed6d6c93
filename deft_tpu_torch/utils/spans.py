"""Spans and counters of the port's tracking loop: one recorder that
``PipelinedRunner`` owns and hands to its model and tracker, and that
``Detector`` keeps for its own stages (``Detector.timers``).

    spans = Spans()
    with spans.span("dispatch", chunk=7):
        ...
    spans.add("dets", 31)

* Always on.  A span adds its wall ms (``perf_counter_ns``) and the ms its
  thread spent on the CPU (``thread_time_ns``) to its name's totals, and
  one to its name's ``count``; a counter (``add``) adds its n.  The lock
  is taken once per span and once per counter.  ``per_frame(n)`` returns
  the totals over n frames (``<span>`` wall ms, ``<span>.cpu`` CPU ms,
  ``n.<counter>``), ``mean_ms()`` each span's mean wall ms, and
  ``reset()`` clears them; ``names`` are reported from zero.  A span's
  wall time less its CPU time is time its thread waited: on a lock, an
  event, the interpreter lock or the host's scheduler.
* On the device trace's clock.  On the thread that made the recorder, and
  only while ``torch.profiler`` records there, a span also opens
  ``record_function(name)``, so that the trace's idle gaps can be named by
  the program's spans.  The name carries no id, so that gaps with the same
  cause add up under one name.  Without a profiler no ``record_function``
  is made: one costs 10-16 us even when nothing records.
* Kept spans.  With ``keep`` set, every span of every thread is also kept
  in memory with its name, chunk and frame ids (a span given none takes
  its parent's), its parent, thread, start, end and CPU ms.  ``export(d)``
  writes them as ``d/spans.jsonl`` on the clock of the profiler's
  ``d/trace.json`` (``torch.profiler`` does not stamp events with
  ``perf_counter``): a span that opened a ``record_function`` takes its
  twin's times, the others are shifted by the median offset of the twins.

``NO_SPANS`` records nothing: a model or tracker outside a runner holds it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled


def _warm_up():
    """The first ``record_function`` of a profiler's run spends 0.1-1 ms in
    its own set-up around stamping its start: a throwaway one, before any
    span's clock is read, takes that cost."""
    torch.profiler.record_function("spans.warmup").__enter__().__exit__(
        None, None, None)


class _Kept:
    """One kept span; times in ns of ``perf_counter_ns``."""

    __slots__ = ("id", "name", "chunk", "frame", "parent", "thread", "t0",
                 "t1", "cpu_ns", "twin")

    def record(self, offset_us: float, twin: Optional[dict] = None) -> dict:
        """The span on the trace's clock: its twin's times where it has
        one, else its own shifted by ``offset_us``."""
        if twin is not None:
            start = float(twin["ts"])
            end = start + float(twin["dur"])
        else:
            start = self.t0 / 1e3 + offset_us
            end = self.t1 / 1e3 + offset_us
        return {"id": self.id, "name": self.name, "chunk": self.chunk,
                "frame": self.frame, "parent": self.parent,
                "thread": self.thread, "start_us": start, "end_us": end,
                "cpu_ms": self.cpu_ns / 1e6}


class _Span:
    __slots__ = ("spans", "name", "chunk", "frame", "rf", "kept", "t0", "c0")

    def __init__(self, spans, name, chunk, frame):
        self.spans = spans
        self.name = name
        self.chunk = chunk
        self.frame = frame

    def __enter__(self):
        spans = self.spans
        twin = False
        # only the thread that made the recorder (the runner's main thread)
        # marks the trace: the benchmark names a device gap by the
        # latest-opened span of any thread that has spans
        # (benchmarks/trace.py::_name_gaps), so a cascade worker's span
        # would take over the labels of the main thread's gaps
        if threading.get_ident() == spans.thread:
            twin = _profiling()
            if twin is not spans._profiled:
                spans._profiled = twin
                if twin:
                    _warm_up()
        # the clocks are read before record_function, which hands the
        # interpreter lock over after stamping its start, and the CPU clock
        # inside the wall clock's interval
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        self.rf = None
        if twin:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.kept = spans._open(self) if spans.keep else None
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        spans = self.spans
        kept = self.kept
        if kept is not None:
            kept.t0, kept.t1, kept.cpu_ns = self.t0, t1, c1 - self.c0
            spans._local.stack.pop()
        with spans._lock:
            total = spans.totals.get(self.name)
            if total is None:
                total = spans.totals[self.name] = [0, 0, 0]
            total[0] += t1 - self.t0
            total[1] += c1 - self.c0
            total[2] += 1
        return False


class Spans:
    """The recorder of the module docstring."""

    def __init__(self, names=()):
        self.names = tuple(names)
        self.thread = threading.get_ident()
        self.keep = False
        self._profiled = False      # a profiler recorded the last span
        self.kept: List[_Kept] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def span(self, name: str, chunk: Optional[int] = None,
             frame: Optional[int] = None) -> _Span:
        return _Span(self, name, chunk, frame)

    def add(self, name: str, n: float = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def reset(self):
        """Clear the totals and counters (not the kept spans)."""
        with self._lock:
            # name -> [wall ns, CPU ns, spans closed]
            self.totals: Dict[str, List[int]] = {n: [0, 0, 0]
                                                 for n in self.names}
            self.counters: Dict[str, float] = {}

    def per_frame(self, frames: int) -> Dict[str, float]:
        frames = max(frames, 1)
        ns = frames * 1e6               # ns per ms, over the frames
        with self._lock:
            out = {k: t[0] / ns for k, t in self.totals.items()}
            out.update({f"{k}.cpu": t[1] / ns
                        for k, t in self.totals.items()})
            out.update({f"n.{k}": v / frames
                        for k, v in self.counters.items()})
        return dict(sorted(out.items()))

    def mean_ms(self) -> Dict[str, float]:
        with self._lock:
            return {k: t[0] / 1e6 / max(t[2], 1)
                    for k, t in self.totals.items()}

    @property
    def count(self) -> Dict[str, int]:
        """Spans closed per name."""
        with self._lock:
            return {k: t[2] for k, t in self.totals.items()}

    # ---- the spans' bookkeeping ----------------------------------------------

    def _open(self, span: _Span) -> _Kept:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        k = _Kept()
        k.id = next(self._ids)
        k.name = span.name
        k.chunk = (span.chunk if span.chunk is not None or parent is None
                   else parent.chunk)
        k.frame = (span.frame if span.frame is not None or parent is None
                   else parent.frame)
        k.parent = None if parent is None else parent.id
        k.thread = threading.current_thread().name
        k.twin = span.rf is not None
        k.t0 = k.t1 = None
        k.cpu_ns = 0
        stack.append(k)
        self.kept.append(k)
        return k

    # ---- the operator's view -------------------------------------------------

    def _twins(self, trace: dict) -> List[tuple]:
        """(kept span, its ``record_function`` event) pairs: per name in
        order of start, for the names whose closed kept spans with a twin
        and whose events in ``trace`` agree in number."""
        mine: Dict[str, List[_Kept]] = {}
        for k in self.kept:
            if k.twin and k.t1 is not None:
                mine.setdefault(k.name, []).append(k)
        theirs: Dict[str, List[dict]] = {}
        for e in trace.get("traceEvents", []):
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") in mine):
                theirs.setdefault(e["name"], []).append(e)
        pairs = []
        for name, kept in mine.items():
            events = sorted(theirs.get(name, []), key=lambda e: e["ts"])
            if len(events) == len(kept):
                pairs += zip(sorted(kept, key=lambda k: k.t0), events)
        return pairs

    def export(self, directory: str, trace: Optional[dict] = None) -> dict:
        """Write the closed kept spans to ``directory/spans.jsonl`` on the
        clock of ``trace`` (``directory/trace.json`` loaded when not
        given): a span with a twin takes the twin's times, the others
        their own shifted by the median offset of the twins (the stamps of
        a pair part by the interpreter lock's hand-overs, so that no one
        pair serves).  Without twins the times stay on ``perf_counter``'s
        clock.  Returns {"spans": n, "offset_us": the offset or None}."""
        if trace is None:
            with open(os.path.join(directory, "trace.json")) as f:
                trace = json.load(f)
        pairs = self._twins(trace)
        offset = (statistics.median(float(e["ts"]) - k.t0 / 1e3
                                    for k, e in pairs) if pairs else None)
        twin = {id(k): e for k, e in pairs}
        done = [k for k in self.kept if k.t1 is not None]
        with open(os.path.join(directory, "spans.jsonl"), "w") as f:
            for k in done:
                f.write(json.dumps(k.record(offset or 0.0, twin.get(id(k))))
                        + "\n")
        return {"spans": len(done), "offset_us": offset}


class _NoSpans:
    """A recorder that records nothing."""

    _none = contextlib.nullcontext()

    def span(self, name: str, chunk: Optional[int] = None,
             frame: Optional[int] = None):
        return self._none

    def add(self, name: str, n: float = 1):
        pass


NO_SPANS = _NoSpans()
