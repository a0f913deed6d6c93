"""Faults planted under the rig's timed path, to show that its comparison
catches them (``benchmarks/tests/test_benchmarks_rig.py``, and ``python -m
benchmarks.rig_control --mode <fault>``).  Each takes the program object
the rig cell hands its ``fault`` hook after set-up: the ``Detector``."""

from __future__ import annotations

import numpy as np

# the camera that gets another's projection, and the camera it comes from:
# the back camera's wide lens takes the front camera's matrix
WRONG_CAMERA, CALIB_FROM = 3, 0


def wrong_calib(det):
    """One camera's detections are unprojected through another camera's
    ``calib``: the back camera takes the front camera's."""
    inner = det.run_multi

    def run_multi(frames, metas=None, infos=None, materialize=None):
        metas = [dict(m) for m in metas]
        metas[WRONG_CAMERA]["calib"] = metas[CALIB_FROM]["calib"]
        return inner(frames, metas, infos, materialize=materialize)

    det.run_multi = run_multi


def lstm_reset(det):
    """The LSTM's state is not carried between samples: every track's
    hidden and cell state are zeroed before each sample."""
    inner = det.run_multi

    def run_multi(*args, **kw):
        for tracker in det.tracker.values():
            for t in tracker.tracked_stracks + tracker.lost_stracks:
                t.hn = np.zeros_like(t.hn)
                t.cn = np.zeros_like(t.cn)
        return inner(*args, **kw)

    det.run_multi = run_multi


class _PastPedestrianCut(float):
    """A score that is never below the pedestrians' cut of 0.35 in a
    comparison, and is its own value everywhere else."""

    def __lt__(self, other):
        return False if other == 0.35 else float(self) < other


def no_pedestrian_cut(det):
    """The pedestrians' score cut (0.35) is dropped: a pedestrian is taken
    from 0.3, as every other class."""
    inner = det.post_process
    ped = 1 + det.info.class_name.index("pedestrian")

    def post_process(dets, meta):
        results = inner(dets, meta)
        for d in results:
            if d["class"] == ped and 0.3 <= d["score"] < 0.35:
                d["score"] = _PastPedestrianCut(d["score"])
        return results

    det.post_process = post_process


RIG = {"wrong_calib": wrong_calib, "lstm_reset": lstm_reset,
       "no_pedestrian_cut": no_pedestrian_cut}
