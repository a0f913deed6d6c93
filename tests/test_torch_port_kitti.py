"""KITTI 2-D vehicle tracking: the port's ``Detector.run`` vs the JAX
package's, on the CPU (``tests/torch_port_kitti_setup.py`` says what the
scene, the weights and the checks are).  This file holds the
``Detector.run`` path (``dcn_impl="hybrid"``), the car filter and the
numpy generator; ``test_torch_port_kitti_chunk_1.py`` and
``test_torch_port_kitti_chunk_4.py`` hold the runner's paths, each on a
worker of its own.
"""

import pytest

import torch_port_kitti_setup as K
from torch_port_kitti_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return K.build_setup(tmp_path_factory.mktemp("kitti"), ("detector",))


@pytest.mark.parametrize("path", ["detector"])
def test_kitti_matches_jax(setup, path):
    K.check_kitti_matches_jax(setup, path)


def test_car_filter_drops_other_classes(setup):
    K.check_car_filter_drops_other_classes(setup)


@pytest.mark.parametrize("path", ["detector"])
def test_kitti_txt_and_scores_match_jax(setup, path, tmp_path):
    K.check_kitti_txt_and_scores_match_jax(setup, path, tmp_path)


def test_synthetic_kitti_generator(tmp_path):
    K.check_synthetic_kitti_generator(tmp_path)
