"""Necks of the generic detectors (NCHW), the counterpart of
``deft_tpu/models/necks.py``.

* ``GenericDLAUp``: DLAUp + a final IDAUp over the last 4 scales of any
  backbone, its nodes of ``NodeSpec`` (``necks.py:22-46``);
* ``DLAUpV0`` / ``IDAUpV0``: the legacy DLASegv0 neck, 1x1 projections,
  cumulative bilinear ups and concat nodes (``necks.py:49-113``);
* ``MSRAUp``: three stages of DCN 3x3 -> BN -> ReLU -> dense 4x4 stride-2
  deconv -> BN -> ReLU (``plain``: the deconv stages alone, PoseResNet's),
  with the reference's ``deconv_layers`` indices (``necks.py:132-162``,
  ``deft_tpu/train/torch_convert.py:249-272``).

Every DCN here is ``DCNv2(impl="gather")``, unclamped, whatever
``cfg.dcn_impl`` says: the JAX package builds ``MSRAUp``'s ``DCNv2(f)``
with ``dcn.py``'s default impl and maps the ``"dcn"`` node of a generic
DLAUp to ``gather`` (``deft_tpu/models/dla.py:283-286``).  On the card that
is T1's ``deform_sample`` at float32 and ``deform_conv_cm`` at bfloat16.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from deft_tpu_torch.models.dcn import DCNv2
from deft_tpu_torch.models.dla import DLAUp, IDAUp, NodeSpec
from deft_tpu_torch.models.layers import (ConvBNReLU, batch_norm,
                                          bilinear_upsampler, full_upsampler)


class GenericDLAUp(nn.Module):
    """DLAUp + final IDAUp over the last 4 backbone scales; returns the
    stride-4 map and the 4 DLAUp and 3 IDAUp outputs as taps.  Its nodes are
    ``node_type``'s (the reference's ``opt.dla_node``), a DCN node
    unclamped through ``gather``."""

    def __init__(self, channels: Sequence[int], node_type: str = "dcn"):
        super().__init__()
        chans = [int(c) for c in channels[-4:]]
        self.out_channel = chans[0]
        spec = NodeSpec(node_type, -1, (), "gather")
        self.dla_up = DLAUp(chans, spec, "neck/dla_up")
        self.ida_up = IDAUp(chans[0], chans[:3], [1, 2, 4], spec,
                            "neck/ida_up")

    def forward(self, feats: List[torch.Tensor]):
        dla_up_out = self.dla_up(list(feats[-4:]))
        y = list(dla_up_out[:3])
        self.ida_up(y, 0, len(y))
        return y[-1], list(dla_up_out) + y


class IDAUpV0(nn.Module):
    """Legacy IDAUp (reference ``networks/dlav0.py:561-631``): per level a
    1x1 conv-BN-ReLU projection (none where the widths match) and a bilinear
    up by the cumulative factor, then sequential 3x3 concat nodes."""

    def __init__(self, out_dim: int, channels: Sequence[int],
                 up_factors: Sequence[int], node_kernel: int = 3):
        super().__init__()
        for i, (c, f) in enumerate(zip(channels, up_factors)):
            setattr(self, f"proj_{i}", ConvBNReLU(c, out_dim, 1)
                    if c != out_dim else nn.Identity())
            setattr(self, f"up_{i}", bilinear_upsampler(out_dim, int(f))
                    if int(f) != 1 else nn.Identity())
        for i in range(1, len(channels)):
            setattr(self, f"node_{i}",
                    ConvBNReLU(2 * out_dim, out_dim, node_kernel))
        self.n = len(channels)

    def forward(self, layers: List[torch.Tensor]):
        ups = [getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(layers[i]))
               for i in range(self.n)]
        x = ups[0]
        y = []
        for i in range(1, self.n):
            x = getattr(self, f"node_{i}")(torch.cat([x, ups[i]], 1))
            y.append(x)
        return x, y


class DLAUpV0(nn.Module):
    """Legacy DLAUp (reference ``networks/dlav0.py:633-656``): IDAUpV0
    stages over the last 4 scales; one stride-4 map of ``channels[0]``."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        chans = [int(c) for c in channels]
        self.out_channel = chans[0]
        scales = [2 ** i for i in range(len(chans))]
        in_channels = list(chans)
        for i in range(len(chans) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUpV0(
                chans[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [chans[j]] * len(in_channels[j + 1:])
        self.n = len(chans)

    def forward(self, feats: List[torch.Tensor]):
        layers = list(feats[-self.n:])
        taps = []
        x = layers[-1]
        for i in range(self.n - 1):
            j = -i - 2
            x, y = getattr(self, f"ida_{i}")(layers[j:])
            layers[j + 1:] = y
            taps.append(x)
        return x, taps


def msra_filters(out_channel: int, plain: bool) -> List[int]:
    """The three stages' widths: [256, 128, 64] for a DCN neck of 64
    output channels, else [256, 256, 256] (PoseResDCN ``resdcn.py:154``;
    PoseResNet always the latter, ``resnet.py:139``)."""
    return [256, 128, 64] if out_channel == 64 and not plain \
        else [256, 256, 256]


class MSRAUp(nn.Module):
    """The CenterNet deconv neck on the last backbone scale: per stage
    ``deconv_layers`` [DCN, BN, ReLU, deconv, BN, ReLU] (``plain``:
    [deconv, BN, ReLU]); returns the last stage's map and each stage's
    output as taps."""

    def __init__(self, cin: int, out_channel: int = 256, plain: bool = False):
        super().__init__()
        filters = msra_filters(out_channel, plain)
        layers = []
        for f in filters:
            if not plain:
                layers += [DCNv2(cin, f, -1, "gather"), batch_norm(f),
                           nn.ReLU(inplace=True)]
                cin = f
            layers += [full_upsampler(cin, f), batch_norm(f),
                       nn.ReLU(inplace=True)]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        self.out_channel = filters[-1]
        self.stage = 3 if plain else 6

    def forward(self, feats: List[torch.Tensor]):
        x = feats[-1]
        taps = []
        mods = list(self.deconv_layers)
        for i in range(0, len(mods), self.stage):
            for m in mods[i: i + self.stage]:
                x = m(x)
            taps.append(x)
        return x, taps
