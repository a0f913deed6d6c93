"""KITTI under test-time geometry: the port's ``Detector.run`` and
``PipelinedRunner`` against the JAX package's on the CPU
(``tests/torch_port_geometry_setup.py`` says what the scenes, the weights
and the checks are): 96x312 frames of the port's numpy generator through
``kitti_config`` (three classes, cars tracked) under ``flip_test``
(64x192), ``keep_res`` (128x320) and ``fix_short`` 64 (64x256), and the
runner at chunk 1 under ``keep_res`` (host warp, integer shifts).
"""

import pytest

import torch_port_geometry_setup as G
from test_torch_port_geometry import run_and_compare
from torch_port_geometry_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def kitti():
    return G.kitti_frames()


@pytest.mark.parametrize("geometry", sorted(G.GEOMETRIES))
def test_detector_run_matches_jax(kitti, geometry):
    weights = G.geometry_weights("kitti", geometry, kitti)
    n_tracks = run_and_compare(weights, "kitti", G.GEOMETRIES[geometry],
                               kitti)
    assert sum(n_tracks) >= len(kitti), n_tracks


def test_runner_keep_res_matches_jax(kitti):
    weights = G.geometry_weights("kitti", "keep_res", kitti)
    want = G.check_runner(weights, "kitti", "keep_res", 1, kitti)
    assert sum(len(fr) for fr in want) >= len(kitti)
