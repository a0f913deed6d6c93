"""The pipelined tracking path: the port's ``PipelinedRunner`` vs the JAX
package's, on the CPU (``tests/torch_port_runner_setup.py`` says what the
scene, the weights and the checks are).  This file holds the ``step`` case
(chunk 1, test.py's runner) and the MOT txt and scores, which reuse its JAX
runner; ``test_torch_port_runner_chunk_quant.py`` and
``test_torch_port_runner_batched.py`` hold the other two cases, the latter
with what checks the port alone (its modes against each other, the ring,
submit after ``submit_warped``, the cascade worker), each on a worker of
its own.
"""

import pytest

import torch_port_runner_setup as R
from torch_port_runner_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    yield from R.build_setup(("step",))


@pytest.mark.parametrize("case", ["step"])
def test_runner_matches_jax(setup, case):
    R.check_runner_matches_jax(setup, case)


def test_mot_txt_and_scores_match_jax(setup, tmp_path):
    R.check_mot_txt_and_scores_match_jax(setup, tmp_path)
