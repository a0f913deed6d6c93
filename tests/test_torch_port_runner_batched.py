"""The pipelined tracking path at chunk 4 with one batched ``detect`` per
chunk (``frame_chunk_batched``, bench.py's runner): the port's
``PipelinedRunner`` vs the JAX package's, on the CPU
(``tests/torch_port_runner_setup.py``); and what checks the port alone:
chunk 4 and chunk 4 batched against chunk 1, the ring after a run, submit
after ``submit_warped``, and the cascade worker under thread switching.
"""

import pytest

import torch_port_runner_setup as R
from torch_port_runner_setup import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    yield from R.build_setup(("batched",), port_only=("step",))


@pytest.mark.parametrize("case", ["batched"])
def test_runner_matches_jax(setup, case):
    R.check_runner_matches_jax(setup, case)


def test_port_modes_agree(setup):
    R.check_port_modes_agree(setup)


def test_ring_and_flags(setup):
    R.check_ring_and_flags(setup)


def test_submit_after_submit_warped(setup):
    R.check_submit_after_submit_warped(setup)


def test_cascade_worker_under_thread_switching(setup):
    R.check_cascade_worker_under_thread_switching(setup)
