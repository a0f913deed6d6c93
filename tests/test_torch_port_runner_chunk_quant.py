"""The pipelined tracking path at chunk 4 with the similarity in uint8
(``sims_quant``): the port's ``PipelinedRunner`` vs the JAX package's, on
the CPU (``tests/torch_port_runner_setup.py``).
"""

import pytest

import torch_port_runner_setup as R
from torch_port_runner_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    yield from R.build_setup(("chunk_quant",))


@pytest.mark.parametrize("case", ["chunk_quant"])
def test_runner_matches_jax(setup, case):
    R.check_runner_matches_jax(setup, case)
