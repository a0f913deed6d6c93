"""KITTI 2-D vehicle tracking through the ``PipelinedRunner`` at chunk 4
(``dcn_impl="pallas"``: the JAX T2 kernel in interpret mode), the port's
against the JAX package's, on the CPU (``tests/torch_port_kitti_setup.py``):
per frame the items, the KITTI txt and the scores; and the port's chunk 4
equal to its chunk 1.
"""

import pytest

import torch_port_kitti_setup as K
from torch_port_kitti_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return K.build_setup(tmp_path_factory.mktemp("kitti"),
                         ("chunk_4", "port_chunk_1"))


@pytest.mark.parametrize("path", ["chunk_4"])
def test_kitti_matches_jax(setup, path):
    K.check_kitti_matches_jax(setup, path)


def test_port_chunk_4_equals_chunk_1(setup):
    K.check_port_chunk_4_equals_chunk_1(setup)


@pytest.mark.parametrize("path", ["chunk_4"])
def test_kitti_txt_and_scores_match_jax(setup, path, tmp_path):
    K.check_kitti_txt_and_scores_match_jax(setup, path, tmp_path)
