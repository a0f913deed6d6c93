"""The plain cascade (``benchmarks/reference/cascade.py``) against hand-worked
sequences and against the program's tracker on the same detections and
similarities, and ``emitted_misses`` against hand counts.

    python -m pytest -q benchmarks/tests/test_benchmarks_cascade.py
"""

from __future__ import annotations

import numpy as np
import pytest

from benchmarks.reference.cascade import Cascade, emitted_misses

M = 8           # max_object
W = 4           # the similarity's ring frames


def _sequence(seed: int, frames: int = 40):
    """Boxes drifting with noise, some leaving and some arriving, in
    shuffled order, and similarities that favour the true pairs."""
    rng = np.random.default_rng(seed)
    n_obj = 6
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform(20, 60, (n_obj, 2))
    alive = np.ones(n_obj, bool)
    seq, history = [], []
    for _ in range(frames):
        pos += vel + rng.normal(0, 0.5, pos.shape)
        alive ^= rng.random(n_obj) < 0.05
        ids = rng.permutation(np.flatnonzero(alive))
        boxes = np.hstack([pos[ids] - size[ids] / 2, pos[ids] + size[ids] / 2])
        scores = np.round(rng.uniform(0.4, 0.95, len(ids)), 4)
        sims = np.zeros((W, M, M + 1), np.float32)
        for r, prev in enumerate(history[:W]):
            for a, pa in enumerate(prev):
                row = rng.uniform(0.0, 0.2, M + 1)
                row[list(ids).index(pa) if pa in ids else M] = 0.9
                row[len(ids) + 1: M] = 0.0
                sims[r, a] = (row / row.sum()).astype(np.float32)
        if len(ids):
            history.insert(0, list(ids))
        seq.append((boxes, scores, sims))
    return seq


def _program_tracks(seq):
    from deft_tpu_torch.tracking.tracker import Tracker

    tracker = Tracker("mot", M, 16, similarity_fn=None, track_buffer=30,
                      device="cpu")
    out = []
    for boxes, scores, sims in seq:
        dets = [{"bbox": b, "score": float(s)} for b, s in zip(boxes, scores)]
        tracks = tracker.update(dets, None, sims=sims)
        out.append({t.track_id: (t.tlbr, float(t.score)) for t in tracks})
    return out


def _reference_tracks(seq):
    cascade = Cascade(track_buffer=30)
    return [{t: (b, s) for t, b, s in cascade.update(boxes, scores, sims, M)}
            for boxes, scores, sims in seq]


def test_one_box_keeps_its_id():
    cascade = Cascade(track_buffer=30)
    ids = set()
    for f in range(10):
        box = np.array([[10.0 + 2 * f, 20.0, 40.0 + 2 * f, 80.0]])
        sims = np.zeros((W, M, M + 1), np.float32)
        sims[:, 0, 0] = 0.9 if f else 0.0
        out = cascade.update(box, np.array([0.8]), sims, M)
        assert len(out) == 1 and out[0][2] == 0.8
        ids.add(out[0][0])
    assert ids == {1}


def test_two_boxes_far_apart_are_two_tracks():
    cascade = Cascade(track_buffer=30)
    boxes = np.array([[0.0, 0, 10, 30], [300.0, 0, 310, 30]])
    first = cascade.update(boxes, np.array([0.9, 0.7]),
                           np.zeros((W, M, M + 1), np.float32), M)
    assert [t for t, _, _ in first] == [1, 2]
    sims = np.zeros((W, M, M + 1), np.float32)
    sims[0, 0, 1] = sims[0, 1, 0] = 0.9      # order swapped in frame 2
    second = cascade.update(boxes[::-1].copy(), np.array([0.7, 0.9]), sims,
                            M)
    assert {t: s for t, _, s in second} == {1: 0.9, 2: 0.7}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reference_cascade_matches_program(seed):
    seq = _sequence(seed)
    prog, ref = _program_tracks(seq), _reference_tracks(seq)
    assert sum(len(f) for f in ref) > 100
    assert emitted_misses(prog, ref, 1e-3) == 0


def test_emitted_misses_counts():
    a, b = np.zeros(4), np.ones(4)
    ref = [{1: (a, 0.5), 2: (b, 0.6)}, {1: (a, 0.5), 2: (b, 0.6)}]
    assert emitted_misses([{7: (a, 0.5), 8: (b, 0.6)}] * 2, ref, 1e-3) == 0
    # ids swapped in the second frame: both tracks miss
    swapped = [{7: (a, 0.5), 8: (b, 0.6)}, {8: (a, 0.5), 7: (b, 0.6)}]
    assert emitted_misses(swapped, ref, 1e-3) == 2
    # a track the program left out in the first frame (it pairs where it
    # first shows), and one it added
    assert emitted_misses([{7: (a, 0.5)}, {7: (a, 0.5), 9: (b, 0.6)}],
                          ref, 1e-3) == 1
    c = np.full(4, 5.0)
    assert emitted_misses([{7: (a, 0.5), 8: (b, 0.6)},
                           {7: (a, 0.5), 8: (b, 0.6), 9: (c, 0.6)}],
                          ref, 1e-3) == 1
    # a score off
    assert emitted_misses([{7: (a, 0.5), 8: (b, 0.6)},
                           {7: (a, 0.5), 8: (b, 0.7)}], ref, 1e-3) == 1
