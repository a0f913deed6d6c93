"""The traced stretch's idle share by the program's span that the trace
named each gap after (``benchmarks/trace.py``: ``host: <span>`` or
``host: <span> / <operator>``, the innermost span at the gap's middle).

The program's tracking loop opens its spans (``deft_tpu_torch/utils/
spans.py``) inside the cell's ``submit``; a program that opens none leaves
every gap under ``submit`` and its readers find nothing to read.
"""

from __future__ import annotations

from typing import Iterable, Optional

# the main thread's spans of the tracking loop, by the layer they time
FRAME_IN = ("warp", "runner.slab_wait", "host_prep", "upload", "stage_wait")
PROGRAM = ("dispatch", "runner.fetch")
PROGRAM_PREFIX = "program."
CASC_WAIT = ("casc_wait",)
LOOP = FRAME_IN + PROGRAM + CASC_WAIT


def span_of(gap: str) -> Optional[str]:
    """The span a gap's name gives, or None for a gap named otherwise."""
    if not gap.startswith("host: "):
        return None
    return gap[len("host: "):].split(" / ", 1)[0]


def in_loop(span: Optional[str]) -> bool:
    return span is not None and (span in LOOP
                                 or span.startswith(PROGRAM_PREFIX))


def idle_share(run, names: Iterable[str],
               prefix: Optional[str] = None) -> Optional[float]:
    """100 x the idle seconds whose span is one of ``names`` or starts with
    ``prefix``, over the traced stretch; None without a trace or where no
    gap is named by a span of the loop."""
    trace = run.trace
    if not trace or trace.get("window_s", 0) <= 0 or "idle" not in trace:
        return None
    spans = {k: span_of(k) for k in trace["idle"]}
    if not any(in_loop(s) for s in spans.values()):
        return None
    names = set(names)
    idle = sum(v for k, v in trace["idle"].items()
               if spans[k] is not None and (
                   spans[k] in names
                   or (prefix is not None and spans[k].startswith(prefix))))
    return 100.0 * idle / trace["window_s"]
