"""Main-thread ms per frame inside the runner's ``dispatch`` span off the
CPU: its wall ms less its thread's CPU ms (``PipelinedRunner.timings()``'s
``dispatch`` and ``dispatch.cpu``) over the window, the time the thread
waited for the interpreter lock or the host's scheduler while it queued
the frame programs."""


def read(run):
    t = run.window["timings"]
    if "dispatch" not in t or "dispatch.cpu" not in t:
        return None
    return t["dispatch"] - t["dispatch.cpu"]
