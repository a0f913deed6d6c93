"""Command-line front end, the counterpart of ``deft_tpu/cli.py``: the
reference's flags -> the port's typed ``Config``.

Every ``Config`` field is a flag of its own name (``_SKIP`` leaves out the
derived ones), with the reference's aliases (``--AFE``,
``--max_frame_dist_AFE``), comma-separated tuple fields and the runtime
options that are not ``Config`` fields (``--gpus``, ``--num_workers``,
``--exp_dir``, ``--data_dir``).  ``parse_config`` finalizes the config,
sets ``save_dir = exp_dir/task/exp_id`` and wires in the dataset's heads
and resolution, exactly as the JAX package's.

``--gpus`` keeps the reference's meaning and picks the devices: ``-1`` is
the CPU, otherwise one card per id (``extras["devices"]``).  Training runs
one rank per card (``train/run.py``); the test and motion-model lines run
on the first (``extras["device"]``).  Asking for the card where there is
none raises (``resolve_device``); nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence

import torch

from deft_tpu_torch.config import Config, finalize, wire_dataset
from deft_tpu_torch.data.datasets import get_dataset_info

_TUPLE_FIELDS = {"lr_step", "save_point", "test_scales"}
_SKIP = {"heads", "weights", "head_convs", "output_h", "output_w",
         "input_res", "output_res", "num_stacks", "pad", "mesh_shape",
         "mesh_axis_names"}


def _flag_bool(s: str) -> bool:
    return s.lower() not in ("0", "false", "no")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("deft_tpu_torch")
    p.add_argument("task", default="tracking", nargs="?",
                   help="tracking | ddd | comma-combinable (e.g. tracking,ddd)")
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name in _SKIP or f.name == "task":
            continue
        flag = f"--{f.name}"
        default = getattr(defaults, f.name)
        if f.name in _TUPLE_FIELDS:
            p.add_argument(flag, type=str,
                           default=",".join(str(x) for x in default))
        elif isinstance(default, bool):
            if default:
                p.add_argument(flag, type=_flag_bool, default=True)
            else:
                p.add_argument(flag, action="store_true")
        elif isinstance(default, (int, float, str)):
            p.add_argument(flag, type=type(default), default=default)
    # reference-compatible aliases
    p.add_argument("--AFE", dest="afe", type=_flag_bool, default=True)
    p.add_argument("--max_frame_dist_AFE", dest="max_frame_dist_afe",
                   type=int, default=defaults.max_frame_dist_afe)
    p.add_argument("--gpus", type=str, default="0",
                   help="-1 runs on the CPU; otherwise the CUDA devices, "
                        "one training rank each (the reference's flag)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--exp_dir", type=str, default="exp")
    p.add_argument("--data_dir", type=str, default="data")
    return p


def device_of(gpus: str) -> List[torch.device]:
    """``--gpus`` -> the devices: ``-1`` ``[cpu]``, ``"2,3"`` ``[cuda:2,
    cuda:3]``."""
    try:
        ids = [int(g) for g in str(gpus).split(",") if g.strip() != ""]
    except ValueError:
        ids = []
    if ids == [-1]:
        return [torch.device("cpu")]
    if not ids or min(ids) < 0 or len(set(ids)) != len(ids):
        raise SystemExit(f"error: --gpus expects distinct ids or -1, got "
                         f"{gpus!r}")
    return [torch.device("cuda", i) for i in ids]


def parse_config(argv: Optional[Sequence[str]] = None):
    """Returns (cfg, extras); extras carries the runtime options that are
    not ``Config`` fields, ``devices`` (from ``--gpus``) and ``device``
    (the first of them) among them."""
    args = build_parser().parse_args(argv)
    d = vars(args).copy()
    devices = device_of(d.pop("gpus"))
    extras = {
        "num_workers": d.pop("num_workers"),
        "exp_dir": d.pop("exp_dir"),
        "data_dir": d.pop("data_dir"),
        "device": devices[0],
        "devices": devices,
    }
    for tf in _TUPLE_FIELDS:
        try:
            d[tf] = tuple(float(x) if tf == "test_scales" else int(x)
                          for x in str(d[tf]).split(",") if x != "")
        except ValueError:
            raise SystemExit(
                f"error: --{tf} expects a comma-separated list of numbers, "
                f"got {d[tf]!r}")
    valid = {f.name for f in dataclasses.fields(Config)}
    cfg = finalize(Config(**{k: v for k, v in d.items() if k in valid}))
    cfg = cfg.replace(save_dir=os.path.join(extras["exp_dir"], cfg.task,
                                            cfg.exp_id))
    return wire_dataset(cfg, get_dataset_info(cfg.dataset)), extras
