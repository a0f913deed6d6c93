"""The device's idle share of the traced stretch, in percent, while the
main thread brought frames in: gaps named by the runner's ``warp``,
``runner.slab_wait``, ``host_prep``, ``upload`` and ``stage_wait`` spans
(``benchmarks/idle.py``)."""

from benchmarks.idle import FRAME_IN, idle_share


def read(run):
    return idle_share(run, FRAME_IN)
