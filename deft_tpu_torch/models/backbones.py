"""ResNet and MobileNetV2 backbones (NCHW), the counterpart of
``deft_tpu/models/backbones.py``.

Both return 5 feature scales (overall strides 2, 4, 8, 16, 32) and add the
``pre_img`` / ``pre_hm`` conditioning stems to the stem's output where they
are asked for (built) and given (passed).  ``channels`` is the plan the
necks consume.

``ResNet`` carries torchvision's names (``conv1``, ``bn1``, ``layer<s>.<b>``
with ``conv1/bn1 .. conv3/bn3`` and ``downsample.0/.1``), which are the
reference PoseResNet's and an imagenet ``resnet<d>`` file's
(``deft_tpu/train/torch_convert.py:226-247``).  ``MobileNetV2`` keeps the
JAX module names (``stem``, ``block<i>.expand/dw/dw_bn/project``): no
reference layout of it is documented.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deft_tpu_torch.models.layers import (Conv2d, ConvBNReLU, batch_norm,
                                          max_pool_ninf)

# depth -> (block, blocks per stage), torchvision's
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class ResBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = batch_norm(width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = batch_norm(width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            Conv2d(cin, width, 1, stride=stride, bias=False),
            batch_norm(width)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResBottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 at 4x the width."""
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = batch_norm(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = batch_norm(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = batch_norm(width * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            Conv2d(cin, width * 4, 1, stride=stride, bias=False),
            batch_norm(width * 4)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-style ResNet returning the stem's and the 4 stages'
    outputs (``deft_tpu/models/backbones.py:67-107``)."""

    def __init__(self, depth: int = 50, pre_img: bool = False,
                 pre_hm: bool = False):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise ValueError(f"resnet depth {depth}: one of "
                             f"{sorted(RESNET_SPECS)}")
        kind, blocks = RESNET_SPECS[depth]
        block = ResBasicBlock if kind == "basic" else ResBottleneck
        self.channels = [64] + [w * block.expansion
                                for w in (64, 128, 256, 512)]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        if pre_img:
            self.pre_img_layer = ConvBNReLU(3, 64, 7, 2)
        if pre_hm:
            self.pre_hm_layer = ConvBNReLU(1, 64, 7, 2)
        self.maxpool = max_pool_ninf(3, 2)
        cin = 64
        for stage, (w, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            layer = []
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                down = b == 0 and (stride != 1 or cin != w * block.expansion)
                layer.append(block(cin, w, stride, down))
                cin = w * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x, pre_img: Optional[torch.Tensor] = None,
                pre_hm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        if pre_img is not None and hasattr(self, "pre_img_layer"):
            x = x + self.pre_img_layer(pre_img)
        if pre_hm is not None and hasattr(self, "pre_hm_layer"):
            x = x + self.pre_hm_layer(pre_hm)
        outs = [x]
        x = self.maxpool(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            outs.append(x)
        return outs


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand (ReLU), 3x3 depthwise (ReLU6), 1x1
    linear project, residual where the shape allows
    (``deft_tpu/models/backbones.py:110-136``)."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        if expand != 1:
            self.expand = ConvBNReLU(cin, hidden, 1)
        self.dw = Conv2d(hidden, hidden, 3, stride=stride, padding=1,
                         groups=hidden, bias=False)
        self.dw_bn = batch_norm(hidden)
        self.project = ConvBNReLU(hidden, cout, 1, relu=False)

    def forward(self, x):
        out = self.expand(x) if hasattr(self, "expand") else x
        out = F.relu6(self.dw_bn(self.dw(out)))
        out = self.project(out)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    """MobileNetV2 returning the outputs of its 16-, 24-, 32-, 96- and
    320-channel groups (``deft_tpu/models/backbones.py:139-176``)."""

    # (expand, channels, repeats, stride)
    CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    CAPTURE = (16, 24, 32, 96, 320)

    def __init__(self, pre_img: bool = False, pre_hm: bool = False):
        super().__init__()
        self.channels = list(self.CAPTURE)
        self.stem = ConvBNReLU(3, 32, 3, 2)
        if pre_img:
            self.pre_img_layer = ConvBNReLU(3, 32, 3, 2)
        if pre_hm:
            self.pre_hm_layer = ConvBNReLU(1, 32, 3, 2)
        cin = 32
        self._groups = []          # (first block, blocks) of each group
        block_id = 0
        for expand, ch, repeats, stride in self.CFG:
            for r in range(repeats):
                setattr(self, f"block{block_id}", InvertedResidual(
                    cin, ch, stride if r == 0 else 1, expand))
                cin = ch
                block_id += 1
            self._groups.append((ch, block_id))

    def forward(self, x, pre_img: Optional[torch.Tensor] = None,
                pre_hm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.stem(x)
        if pre_img is not None and hasattr(self, "pre_img_layer"):
            x = x + self.pre_img_layer(pre_img)
        if pre_hm is not None and hasattr(self, "pre_hm_layer"):
            x = x + self.pre_hm_layer(pre_hm)
        outs = []
        block_id = 0
        for ch, end in self._groups:
            while block_id < end:
                x = getattr(self, f"block{block_id}")(x)
                block_id += 1
            if ch in self.CAPTURE:
                outs.append(x)
        return outs
