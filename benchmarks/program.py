"""What the cells share of the program under test: its configuration
from a recipe line, its launch counters, and seeded weights for it."""

from __future__ import annotations

import torch

from benchmarks import weights
from benchmarks.reference.deft_ref import input_image

LAUNCH_COUNTERS = {"t1": "LAUNCHES", "t4": "LAUNCHES_ONEHOT"}


def launches() -> dict:
    from deft_tpu_torch.ops import cuda_dcn

    return {k: getattr(cuda_dcn, v) for k, v in LAUNCH_COUNTERS.items()}


def program_config(config: dict, line: str, extra=()):
    """The program's ``Config`` from the configuration's recipe line, at
    the configuration's input size."""
    from deft_tpu_torch.cli import parse_config

    cfg, _ = parse_config(list(config[line]) + list(extra) + [
        "--input_h", str(config["input_h"]), "--input_w",
        str(config["input_w"]), "--gpus", "0"])
    return cfg


def make_weights(model, config, spec, frames, seed, device, log):
    """The seeded, calibrated ``state_dict`` (``weights.py``)."""
    sd = weights.make_state_dict(weights.state_shapes(model), seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 2)
    calib = input_image(frames, config["input_h"], config["input_w"])
    info = weights.calibrate(sd, spec, calib, config, gen)
    log(f"# calibration: {info}")
    return sd


def calibration_indices(n: int, count: int) -> list:
    """``count`` frames spread evenly over a scene of ``n``."""
    if count <= 1:
        return [0]
    return [round(i * (n - 1) / (count - 1)) for i in range(count)]
