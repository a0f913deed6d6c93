"""The pipelined runner under ``keep_res`` and ``fix_short``: the port's
``PipelinedRunner`` against the JAX package's on the CPU, MOT
(``tests/torch_port_geometry_setup.py`` says what the scenes, the weights
and the checks are).  The input size follows the frame's, so both runners
warp on the host, the JAX one with cv2 and the port with
``ops/warp.py::warp_affine_uint8``:

* ``keep_res`` at chunk 1 and chunk 4: integer shifts, the same frames;
  10 frames, so chunk 4 ends in a padded partial chunk;
* ``fix_short`` at chunk 1: the JAX runner's host-warped frames go into
  both runners through ``submit_warped`` (the two warps differ by up to
  one uint8 step; ``test_torch_port_geometry.py`` holds them to that).
"""

import pytest

import torch_port_geometry_setup as G
from torch_port_geometry_setup import few_threads  # noqa: F401

FRAMES = 10


@pytest.fixture(scope="module")
def mot():
    frames = G.mot_frames(FRAMES)
    return {geometry: G.geometry_weights("mot", geometry, frames)
            for geometry in ("keep_res", "fix_short")}, frames


@pytest.mark.parametrize("geometry, chunk", [("keep_res", 1),
                                             ("keep_res", 4),
                                             ("fix_short", 1)])
def test_runner_host_warp_matches_jax(mot, geometry, chunk):
    weights, frames = mot
    want = G.check_runner(weights[geometry], "mot", geometry, chunk, frames)
    assert sum(len(fr) for fr in want) >= FRAMES
