"""Public detections: the public ``Detector.run`` as a whole against the
JAX package's, and ``track_videos_detector`` with ``public_dets``, on the
CPU.  The scene, the weights (the ``setup`` fixture) and the tolerances are
``test_torch_port_public.py``'s; these tests live in a file of their own so
that they run on a worker of their own.
"""

import numpy as np

from deft_tpu_torch.track import track_videos_detector
from deft_tpu_torch.tracking.basetrack import IdAllocator
from test_torch_port_public import (BOX_TOL, FRAMES, SIZE,  # noqa: F401
                                    setup)


def _canon(tracks):
    return [(t.track_id, np.asarray(t.tlbr)) for t in tracks]


def test_detector_run_public_matches_jax(setup):
    """``Detector.run`` under ``public_det`` on the JAX package's
    prefetched inputs: ids exact and boxes within BOX_TOL per frame.
    Frame 3 carries no ``cur_dets`` and takes the model path in both."""
    jdet, pdet = setup["jdet"], setup["pdet"]
    jdet.reset_tracking()
    pdet.ids = IdAllocator()          # ids from 1, as the fresh JAX one's
    pdet.reset_tracking()
    pdet.timers.reset()
    n_tracks = []
    for f, inp in enumerate(setup["inputs"]):
        want = _canon(jdet.run(inp))
        got = _canon(pdet.run(inp))
        assert [i for i, _ in got] == [i for i, _ in want], f
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=BOX_TOL)
        n_tracks.append(len(got))
    dets = setup["dets"]
    assert all(n <= min(len(d), SIZE["max_object"])
               for n, d in zip(n_tracks, dets) if d is not None), n_tracks
    assert n_tracks[3] > 0 and min(n_tracks[4:]) >= 4, n_tracks
    # the public frames ran no post stage; the model-path frame did
    assert pdet.timers.count == {"pre": 6, "net": 6, "post": 1, "track": 6,
                                 "tot": 6}


def test_track_videos_detector_public(setup):
    """``track_videos_detector(public_dets=...)`` injects each frame's
    boxes as ``cur_dets`` into the prefetched inputs' meta."""
    inputs = [{"images": i["images"],
               "meta": {k: v for k, v in i["meta"].items()
                        if k != "cur_dets"}} for i in setup["inputs"]]
    ids = list(range(100, 100 + FRAMES))
    by_image = {i: d for i, d in zip(ids, setup["dets"]) if d is not None}
    pdet = setup["pdet"]
    runs = []
    for frames, by in ((setup["inputs"], None), (inputs, by_image)):
        pdet.ids = IdAllocator()
        runs.append(track_videos_detector(pdet, [(1, list(zip(ids, frames)))],
                                          public_dets=by))
    plain, injected = runs
    for i in ids:
        assert ([it["tracking_id"] for it in injected[i]]
                == [it["tracking_id"] for it in plain[i]]), i
        for a, b in zip(injected[i], plain[i]):
            np.testing.assert_array_equal(a["bbox"], b["bbox"])
    assert min(len(injected[i]) for i in ids[4:]) >= 4
