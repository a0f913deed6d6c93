"""The 3-D IoU's cost per box pair, in us: the trackers' ``tracker.iou3d``
span over the pairs they counted (``n.iou3d_pairs``) in the window; None
where no pair was counted."""


def read(run):
    t = run.window["timings"]
    pairs = t.get("n.iou3d_pairs")
    if not pairs or not run.window["counts"].get("tracker.iou3d"):
        return None
    return 1000.0 * t["tracker.iou3d"] / pairs
