"""Reference PyTorch checkpoints into the port's modules, the counterpart of
the ``.pth`` route of ``deft_tpu/train/checkpoint.py::load_checkpoint``.

A reference DEFT checkpoint is ``{"epoch", "state_dict", "optimizer"}`` as
its trainer saves it (or a bare ``state_dict``), its keys prefixed with
``module.`` when the model was wrapped for data parallelism.  The port's
modules carry the reference's key names, so its tensors load as they are:

* ``load_torch_state_dict`` reads one such file on the CPU;
* ``load_tolerant`` overlays it onto a seeded module as the reference's
  ``load_model`` does (and the JAX package's ``_merge_tolerant``): a key of
  matching shape loads, a mis-shaped or missing key keeps the seeded value,
  an unexpected key is dropped, each with a message.

The JAX package's own orbax checkpoints need orbax, which the port does not
use; they are refused.
"""

from __future__ import annotations

import pickle
from collections import OrderedDict
from typing import Dict, List, NamedTuple

import torch
import torch.nn as nn


class TolerantLoad(NamedTuple):
    """The module's keys that loaded and that kept their seeded value, and
    the file's keys the module has no place for."""
    loaded: List[str]
    kept: List[str]
    dropped: List[str]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> its ``state_dict`` on the CPU, with any
    ``module.`` prefix stripped (``deft_tpu/train/torch_convert.py:30-40``).
    Loaded with ``weights_only=True``: a reference checkpoint holds only
    tensors, numbers and the optimizer's dict, and a file that needs more is
    refused."""
    if not str(path).endswith(".pth"):
        raise NotImplementedError(
            f"{path}: only reference PyTorch checkpoints (.pth) load in the "
            "port; the JAX package's orbax checkpoints need orbax")
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a reference checkpoint of tensors, "
                         f"numbers and dicts ({e})") from e
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return OrderedDict(
        (k[len("module."):] if k.startswith("module.") else k, v)
        for k, v in sd.items())


def load_tolerant(module: nn.Module, sd: Dict[str, torch.Tensor]
                  ) -> TolerantLoad:
    """Overlay ``sd`` onto ``module``'s seeded parameters and buffers, with
    the messages of ``deft_tpu/train/checkpoint.py::_merge_tolerant``."""
    own = module.state_dict()
    take = OrderedDict()
    kept = []
    for key, value in own.items():
        if key not in sd:
            print(f"checkpoint: {key} missing; keeping init")
            kept.append(key)
        elif tuple(sd[key].shape) != tuple(value.shape):
            print(f"checkpoint: shape mismatch at {key} "
                  f"({tuple(sd[key].shape)} vs {tuple(value.shape)}); "
                  "keeping init")
            kept.append(key)
        else:
            take[key] = sd[key]
    dropped = [key for key in sd if key not in own]
    for key in dropped:
        print(f"checkpoint: dropping unexpected key {key}")
    module.load_state_dict(take, strict=False)
    return TolerantLoad(list(take), kept, dropped)
