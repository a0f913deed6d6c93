"""Main-thread ms per sample in the rig's batched frame program: the
detector's ``net`` span (one ``detect`` of the six cameras, their decode
fetched to the host) over the window."""


def read(run):
    if not run.window["counts"].get("net"):
        return None
    return run.window["timings"]["net"]
