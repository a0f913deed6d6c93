"""The control: the plain reference at float8, the nearest precision below
the configurations' bfloat16, put in the program's place, is judged not
correct by each cell's limits (at a tiny size on the CPU; on the card, at
the cells' own sizes, ``python -m benchmarks.control --mode control``)."""

from __future__ import annotations

import pytest
import torch

from benchmarks import control
from benchmarks.tests.tiny import cell_files

SEEDS = (5, 6, 7)


def _fails(readings, limits):
    # the control runs no cascade: it has no ``id_misses``
    return any(readings[k] > limit for k, limit in limits.items()
               if k in readings)


@pytest.mark.parametrize("seed", SEEDS)
def test_track_control_fails(seed):
    torch.set_num_threads(2)
    config, traffic, limits = cell_files("mot17-track")
    readings = control.track_control(config, traffic, seed,
                                     torch.device("cpu"),
                                     traffic["control_frames"])
    assert readings["frames"] > 0
    assert _fails(readings, limits), (readings, limits)
