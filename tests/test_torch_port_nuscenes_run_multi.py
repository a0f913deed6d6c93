"""nuScenes ``Detector.run_multi`` against the JAX package's, on the CPU:
the tool's two-camera scene and the port's six-camera rig.  The scene, the
detectors (the ``nus_scene`` and ``detectors`` fixtures), the helpers and
the tolerances are ``test_torch_port_nuscenes.py``'s; these two cases live
in a file of their own so that they run on a worker of their own.
"""

import numpy as np
import pytest

from test_torch_port_nuscenes import (BOX_TOL, SCORE_TOL,  # noqa: F401
                                      JaxIds, check_cameras, detectors,
                                      few_threads, make_scene, nus_scene,
                                      samples, snapshot)


@pytest.mark.parametrize("rig", ["tool, 2 cameras", "port, 6 cameras"])
def test_run_multi_matches_jax(nus_scene, detectors, rig):
    """Per sample, the JAX ``run_multi`` on the frames and the port's on
    the JAX-warped inputs (the two packages warp differently by design):
    the same tracks per camera, boxes within BOX_TOL.  The scenes: the
    tool's, and the port's six-camera rig."""
    jdet, port = detectors
    jdet.ids = JaxIds()                 # ids from 1, as the fresh port's
    jdet.reset_tracking()
    pdet = port()
    frames = (nus_scene[1] if rig.startswith("tool") else
              make_scene(n_samples=3, cameras=6, height=180, width=320,
                         n_objects=16, seed=4))
    n_tracks = []
    for sample in samples(frames):
        infos = [info for info, _ in sample]
        metas = [{"calib": info["calib"]} for info in infos]
        prepared = [dict(zip(("images", "meta"),
                             jdet.pre_process(frame, 1.0, meta)))
                    for (_, frame), meta in zip(sample, metas)]
        dets, _ = jdet.process(np.concatenate([p["images"] for p in prepared]))
        scores = dets["scores"]
        # the order and the cuts are stable only with margins above the
        # score tolerance
        for cut in (jdet.cfg.out_thresh, 0.3, 0.35):
            assert np.abs(scores - cut).min() > 10 * SCORE_TOL
        want = jdet.run_multi([f for _, f in sample], metas, infos,
                              materialize=snapshot)
        got = pdet.run_multi(prepared, None, infos, materialize=snapshot)
        check_cameras(got, want, BOX_TOL)
        n_tracks.append(sum(len(c) for c in want))
    assert min(n_tracks) >= 2 and sum(n_tracks) >= 4 * len(n_tracks), n_tracks
