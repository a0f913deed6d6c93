"""The window's share of the card's dense peak, in percent: the frame
program's FLOPs (``benchmarks/counts.py::frame_flops``, from the
configuration's shapes) times the frames tracked in the window, over the
window's seconds and the peak of the compute dtype."""

from benchmarks.counts import PEAK_FLOPS


def read(run):
    if not run.window["frames"]:
        return None
    rate = run.flops_per_frame * run.window["frames"] / run.window["seconds"]
    return 100.0 * rate / PEAK_FLOPS[run.dtype]
