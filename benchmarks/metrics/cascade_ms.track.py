"""Cascade-worker ms per frame: post-processing and the tracker, the
runner's ``cascade`` bucket (``PipelinedRunner.timings()``) over the
window."""


def read(run):
    return run.window["timings"].get("cascade")
