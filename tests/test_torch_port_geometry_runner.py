"""The pipelined runner under ``flip_test``: the port's ``PipelinedRunner``
against the JAX package's on the CPU, MOT at chunk 1 and chunk 4
(``tests/torch_port_geometry_setup.py`` says what the scenes, the weights
and the checks are).  Both runners warp on the device (``device_warp``,
fix_res), and every frame program runs the trunk at batch 2 on the frame
and its mirror.  10 frames: at chunk 4 two chunks and a padded partial one.
``keep_res`` and ``fix_short`` are in ``test_torch_port_geometry_runner_host.py``.
"""

import pytest

import torch_port_geometry_setup as G
from torch_port_geometry_setup import few_threads  # noqa: F401

FRAMES = 10


@pytest.fixture(scope="module")
def mot():
    frames = G.mot_frames(FRAMES)
    return G.geometry_weights("mot", "flip_test", frames), frames


@pytest.mark.parametrize("chunk", [1, 4])
def test_runner_flip_matches_jax(mot, chunk):
    weights, frames = mot
    want = G.check_runner(weights, "mot", "flip_test", chunk, frames)
    assert sum(len(fr) for fr in want) >= FRAMES
