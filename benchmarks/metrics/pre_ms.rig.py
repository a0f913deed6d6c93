"""Main-thread ms per sample bringing the rig's frames in: the detector's
``pre`` span inside ``run_multi`` (the six frames to the device, warped and
normalized) over the window; None where ``run_multi`` opens no such
span."""


def read(run):
    if not run.window["counts"].get("pre"):
        return None
    return run.window["timings"]["pre"]
