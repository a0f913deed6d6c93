"""KITTI 2-D vehicle tracking through the ``PipelinedRunner`` at chunk 1
(``dcn_impl="pallas"``: the JAX T2 kernel in interpret mode, the JAX runner
with ``device_warp=True``), the port's against the JAX package's, on the
CPU (``tests/torch_port_kitti_setup.py``): per frame the items, the KITTI
txt of both writers and ``tools/eval_kitti.py``'s scores; and the two
writers on one results dict.
"""

import pytest

import torch_port_kitti_setup as K
from torch_port_kitti_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return K.build_setup(tmp_path_factory.mktemp("kitti"), ("chunk_1",))


@pytest.mark.parametrize("path", ["chunk_1"])
def test_kitti_matches_jax(setup, path):
    K.check_kitti_matches_jax(setup, path)


def test_kitti_writer_matches_jax_on_one_dict(setup, tmp_path):
    K.check_kitti_writer_matches_jax_on_one_dict(setup, tmp_path)


@pytest.mark.parametrize("path", ["chunk_1"])
def test_kitti_txt_and_scores_match_jax(setup, path, tmp_path):
    K.check_kitti_txt_and_scores_match_jax(setup, path, tmp_path)
