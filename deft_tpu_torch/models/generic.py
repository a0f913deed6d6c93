"""The generic backbone x neck detectors, the counterpart of
``deft_tpu/models/generic.py``: ``--arch generic`` (``cfg.backbone`` dla34 |
resnet | mobilenet x ``cfg.neck`` dlaup | dlaupv0 | msraup |
msraup_plain), ``res_<d>`` (PoseResNet), ``resdcn_<d>`` (PoseResDCN),
``mobilenet`` and ``dlav0_<d>`` (``factory.py`` maps each arch to a
backbone and a neck).

Like the JAX package and the reference, these carry detection heads only:
no AFE, so no tracking and no training step (``Detector`` and the trainer
refuse them by name).  Entry points, with the JAX layouts at their boundary:

* ``forward(image)`` -> ``({head: [B, H/4, W/4, C]} float32, backbone
  scales + neck taps)``; ``image`` NHWC, maps NCHW;
* ``detect(image, k)`` -> the clamped-sigmoid heatmap's ``generic_decode``
  (``generic.py:93-97``).

No ``pre_img`` / ``pre_hm`` stems: the JAX ``GenericNet`` creates them only
when called with those inputs, which its ``init_model`` and ``Detector``
never do (the ResNet and MobileNetV2 classes build them where asked).

Keys: ``backbone.*``, ``neck.*`` and the head towers (``hm.0``, ``hm.2``
...), except where ``flat``: PoseResNet and PoseResDCN register the
ResNet's and the deconv neck's children at the top, as the reference's
``conv1``, ``bn1``, ``layer*`` and ``deconv_layers.*`` keys are
(``deft_tpu/train/torch_convert.py:226-272``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from deft_tpu_torch.models.backbones import MobileNetV2, ResNet
from deft_tpu_torch.models.deft import HeadTower
from deft_tpu_torch.models.dla import DLA, DLA34_CHANNELS
from deft_tpu_torch.models.necks import DLAUpV0, GenericDLAUp, MSRAUp
from deft_tpu_torch.ops.decode import clamped_sigmoid, generic_decode

BACKBONES = ("dla34", "resnet", "mobilenet")
NECKS = ("dlaup", "dlaupv0", "msraup", "msraup_plain")


def make_backbone(name: str, num_layers: int) -> nn.Module:
    if name == "dla34":
        return DLA()
    if name == "resnet":
        return ResNet(num_layers)
    if name == "mobilenet":
        return MobileNetV2()
    raise ValueError(f"unknown backbone {name!r}; one of {BACKBONES}")


def neck_channels(backbone: nn.Module) -> Sequence[int]:
    """The 5-scale plan the necks consume: DLA-34's levels 1-5 (its 6
    outputs' last 4 feed the neck), the others' own."""
    if isinstance(backbone, DLA):
        return list(DLA34_CHANNELS[1:])
    return list(backbone.channels)


def make_neck(name: str, channels: Sequence[int], node_type: str,
              msra_outchannel: int) -> nn.Module:
    if name == "dlaup":
        return GenericDLAUp(channels, node_type)
    if name == "dlaupv0":
        return DLAUpV0(channels[-4:])
    if name in ("msraup", "msraup_plain"):
        return MSRAUp(channels[-1], msra_outchannel,
                      plain=name == "msraup_plain")
    raise ValueError(f"unknown neck {name!r}; one of {NECKS}")


class GenericNet(nn.Module):
    """Backbone x neck x head towers (module docstring)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 heads: Dict[str, int], head_convs: Dict[str, Sequence[int]],
                 prior_bias: float = -4.6, head_kernel: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 flat: bool = False):
        super().__init__()
        if flat:
            for name, child in list(backbone.named_children()) + list(
                    neck.named_children()):
                self.add_module(name, child)
        else:
            self.backbone = backbone
            self.neck = neck
        # the two parts' forwards; a tuple is no registered submodule
        self._parts = (backbone, neck)
        self.compute_dtype = compute_dtype
        self.heads = dict(heads)
        last_channel = neck.out_channel
        for h, c in self.heads.items():
            setattr(self, h, HeadTower(
                last_channel, c, tuple(head_convs.get(h, ())), head_kernel,
                prior_bias if "hm" in h else None))

    def forward(self, image: torch.Tensor):
        """image [B, H, W, 3] -> ({head: [B, H/4, W/4, C]} float32, the
        backbone's scales + the neck's taps, NCHW in ``compute_dtype``)."""
        backbone, neck = self._parts
        feats = backbone(image.permute(0, 3, 1, 2).to(
            self.compute_dtype).contiguous())
        y, taps = neck(feats)
        outputs = {h: getattr(self, h)(y).float().permute(0, 2, 3, 1)
                   for h in self.heads}
        return outputs, list(feats) + list(taps)

    def detect(self, image: torch.Tensor, k: int = 100):
        """forward -> clamped sigmoid of ``hm`` -> ``generic_decode``: a
        dict of [B, K, ...] detections in output-grid coordinates."""
        outputs, _ = self(image)
        outputs["hm"] = clamped_sigmoid(outputs["hm"])
        return generic_decode(outputs, k=k)
