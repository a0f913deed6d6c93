"""Main-thread ms per sample in the rig's 3-D cascade: the detector's
``track`` span (per camera the camera -> global boxes, the per-class NMS
and the seven class trackers, their ring similarities and LSTM steps)
over the window."""


def read(run):
    if not run.window["counts"].get("track"):
        return None
    return run.window["timings"]["track"]
