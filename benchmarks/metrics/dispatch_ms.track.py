"""Main-thread ms per frame spent queueing the frame programs: the
runner's ``dispatch`` bucket (``PipelinedRunner.timings()``) over the
window."""


def read(run):
    return run.window["timings"].get("dispatch")
