"""The device's idle share of the traced stretch, in percent, while the
main thread waited for the cascade worker: gaps named by the runner's
``casc_wait`` span (``benchmarks/idle.py``)."""

from benchmarks.idle import CASC_WAIT, idle_share


def read(run):
    return idle_share(run, CASC_WAIT)
