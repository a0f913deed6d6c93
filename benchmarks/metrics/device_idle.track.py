"""The device's idle share of the traced stretch, in percent: one minus the
union of its kernel, copy and memset intervals over the stretch's length
(``benchmarks/trace.py``)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
