"""The share of the window's frame-program dispatches that replayed a
captured CUDA graph, in percent: the runner's counter ``graph_replays``
over ``graph_replays`` + ``graph_captures`` + ``eager_programs``
(``PipelinedRunner.timings()``'s ``n.*``, each per frame, so that their
ratio is the dispatches'); None where the program keeps none of them."""

KEYS = ("n.graph_replays", "n.graph_captures", "n.eager_programs")


def read(run):
    t = run.window["timings"]
    total = sum(t.get(k, 0.0) for k in KEYS)
    if not total:
        return None
    return 100.0 * t.get("n.graph_replays", 0.0) / total
