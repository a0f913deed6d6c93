"""Faults planted under the timed path, to show that the comparison catches
them (``benchmarks/tests``, and ``python -m benchmarks.control --mode
<fault>``).  Each takes the program object a cell driver hands its
``fault`` hook after set-up: the ``PipelinedRunner`` of a track cell."""

from __future__ import annotations


def stale_ring(runner):
    """The frame programs leave the embedding ring as they found it: a step
    that returns its state unchanged."""
    model = runner.det.model
    inner = model._sim_and_record

    def sim_and_record(emb, n_valid, state, *args, **kw):
        kept = {k: v.clone() for k, v in state.items()}
        out = inner(emb, n_valid, state, *args, **kw)
        for k, v in kept.items():
            state[k].copy_(v)
        return out

    model._sim_and_record = sim_and_record


def half_chunk(runner):
    """The second half of every chunk gets the first half's outputs: half
    of the batch left out."""
    inner = runner.run_program

    def run_program(images, meta):
        packed, sims = inner(images, meta)
        half = (images.shape[0] + 1) // 2
        packed[half:] = packed[: images.shape[0] - half]
        sims[half:] = sims[: images.shape[0] - half]
        return packed, sims

    runner.run_program = run_program


def empty_half(runner):
    """The second half of every chunk finds nothing: its frames' detections
    score 0, so they write no ring rows and emit no tracks (half of the
    batch left out)."""
    model = runner.det.model
    inner = model.detect

    def detect(images, *args, **kw):
        dets, emb = inner(images, *args, **kw)
        half = (images.shape[0] + 1) // 2
        if images.shape[0] > 1:
            dets["scores"][half:] = 0.0
        return dets, emb

    model.detect = detect


def swapped_ids(runner):
    """Every 5th frame the cascade swaps the ids of the first two tracks
    it emits, for good: an answer altered where it is produced."""
    tracker = runner.det.tracker
    inner = tracker.update

    def update(*args, **kw):
        out = inner(*args, **kw)
        if tracker.frame_id % 5 == 0 and len(out) >= 2:
            out[0].track_id, out[1].track_id = out[1].track_id, out[0].track_id
        return out

    tracker.update = update


def altered_score(runner):
    """Every detection scores 0.25 more than computed: an answer altered
    where it is produced."""
    inner = runner.det.post_process

    def post_process(dets, meta):
        results = inner(dets, meta)
        for d in results:
            d["score"] += 0.25
        return results

    runner.det.post_process = post_process


TRACK = {"stale_ring": stale_ring, "half_chunk": half_chunk,
         "empty_half": empty_half, "swapped_ids": swapped_ids,
         "altered_score": altered_score}
