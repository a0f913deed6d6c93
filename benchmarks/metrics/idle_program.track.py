"""The device's idle share of the traced stretch, in percent, while the
main thread queued the frame programs: gaps named by the runner's
``dispatch`` span or one inside it (``runner.fetch``, ``program.*``;
``benchmarks/idle.py``)."""

from benchmarks.idle import PROGRAM, PROGRAM_PREFIX, idle_share


def read(run):
    return idle_share(run, PROGRAM, PROGRAM_PREFIX)
