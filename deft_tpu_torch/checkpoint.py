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

A bare imagenet trunk (a ``dla<d>`` file of ``base_layer.*`` keys, or a
torchvision ``resnet<d>`` of ``conv1`` + ``layer*`` keys without neck or
heads; ``is_imagenet_backbone_sd``, as ``deft_tpu/train/torch_convert.py::
is_imagenet_backbone_sd`` detects it) loads into the trunk alone
(``trunk_state_dict``): its keys move under the module's trunk prefix
(``base.`` of a DEFTNet, ``backbone.`` of a GenericNet, none for PoseResNet
and PoseResDCN), its classifier is left out, and everything else keeps its
seeded value.  ``load_model`` is that route for ``cfg.load_model``.

A path without the ``.pth`` suffix, as the recipes write ``--load_model
exp/tracking/mot17_train/model_last``, names the port trainer's
``model_last.pth`` where that file exists (``resolve_pth``).  The JAX
package's own orbax checkpoints need orbax, which the port does not use;
any other path is refused.
"""

from __future__ import annotations

import os
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


def resolve_pth(path: str) -> str:
    """``path`` if it ends with ``.pth``; ``path + ".pth"`` where that file
    exists (the recipes' ``--load_model .../model_last``, which the port's
    trainer writes as ``model_last.pth``); otherwise raises
    ``NotImplementedError``: the port reads no orbax checkpoint."""
    path = str(path)
    if path.endswith(".pth"):
        return path
    if os.path.isfile(path + ".pth"):
        return path + ".pth"
    raise NotImplementedError(
        f"{path}: only reference PyTorch checkpoints (.pth) load in the "
        "port; the JAX package's orbax checkpoints need orbax")


def load_checkpoint_blob(path: str):
    """The whole ``.pth`` file at ``resolve_pth(path)``, read on the CPU
    with ``weights_only=True``."""
    path = resolve_pth(path)
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a reference checkpoint of tensors, "
                         f"numbers and dicts ({e})") from e


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> its ``state_dict`` on the CPU, with any
    ``module.`` prefix stripped (``deft_tpu/train/torch_convert.py:30-40``).
    Loaded with ``weights_only=True``: a reference checkpoint holds only
    tensors, numbers and the optimizer's dict, and a file that needs more is
    refused.  ``path`` may leave out the suffix (``resolve_pth``)."""
    blob = load_checkpoint_blob(path)
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


# the trunk key that locates a module's trunk prefix, per imagenet layout
_TRUNK_ANCHORS = ("base_layer.0.weight", "layer1.0.conv1.weight")


def is_imagenet_backbone_sd(sd: Dict[str, torch.Tensor]) -> bool:
    """A bare imagenet trunk ``state_dict``: DLA's (``base_layer.*``
    without the ``base.`` prefix) or torchvision ResNet's (``conv1`` and
    ``layer1`` without deconv or head keys)."""
    if "base_layer.0.weight" in sd and "base.base_layer.0.weight" not in sd:
        return True
    return ("conv1.weight" in sd and "layer1.0.conv1.weight" in sd
            and not any(k.startswith("deconv_layers") for k in sd)
            and "hm.0.weight" not in sd and "hm.weight" not in sd)


def trunk_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """An imagenet trunk's keys under ``module``'s trunk prefix, without
    the classifier (``fc.*``); raises ``ValueError`` where ``module`` has
    no trunk of that layout."""
    anchor = next(a for a in _TRUNK_ANCHORS if a in sd)
    own = [k for k in module.state_dict() if k.endswith(anchor)]
    if not own:
        raise ValueError(f"an imagenet trunk with {anchor} has no place in "
                         f"{type(module).__name__}")
    prefix = min(own, key=len)[: -len(anchor)]
    return OrderedDict((prefix + k, v) for k, v in sd.items()
                       if not k.startswith("fc."))


def load_model(module: nn.Module, path: str) -> TolerantLoad:
    """``cfg.load_model``'s file overlaid onto ``module`` (``load_tolerant``),
    an imagenet trunk through ``trunk_state_dict``."""
    sd = load_torch_state_dict(path)
    if is_imagenet_backbone_sd(sd):
        sd = trunk_state_dict(sd, module)
    return load_tolerant(module, sd)
