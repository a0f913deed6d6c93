"""Main-thread ms per sample in the LSTM motion model: the trackers'
``tracker.lstm`` span around each batched step over the window; None
where no step opened it."""


def read(run):
    if not run.window["counts"].get("tracker.lstm"):
        return None
    return run.window["timings"]["tracker.lstm"]
