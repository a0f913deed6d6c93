"""Shared building blocks (NCHW), the counterpart of ``deft_tpu/models/layers.py``.

Module and parameter names follow the reference DEFT network, so that a
published DEFT ``state_dict`` loads directly: a conv-BN-ReLU triple is an
``nn.Sequential`` whose children ``0`` and ``1`` are the conv and the BN.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# torch BatchNorm2d(momentum=0.1) == flax BatchNorm(momentum=0.9); only the
# eval-mode running statistics matter for inference
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def torch_pad(kernel: int, dilation: int = 1) -> int:
    """Symmetric padding of a stride-s conv, torch style."""
    return dilation * (kernel // 2)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNReLU(nn.Sequential):
    """Conv -> BN -> optional ReLU (reference ``dla.py:40-44`` pattern);
    children ``0`` (conv), ``1`` (bn), ``2`` (relu)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True):
        layers = [
            nn.Conv2d(cin, cout, kernel, stride=stride,
                      padding=torch_pad(kernel, dilation), dilation=dilation,
                      bias=False),
            batch_norm(cout),
        ]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def bilinear_upsample_kernel(k: int) -> torch.Tensor:
    """The depthwise bilinear kernel the reference writes into its
    ConvTranspose2d upsamplers (``dla.py:565-573`` ``fill_up_weights``)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    row = 1.0 - torch.abs(torch.arange(k, dtype=torch.float32) / f - c)
    return row[:, None] * row[None, :]


def bilinear_upsampler(channels: int, factor: int) -> nn.ConvTranspose2d:
    """Depthwise transposed conv, bilinear-initialized: the reference's own
    ``nn.ConvTranspose2d(o, o, f*2, stride=f, padding=f//2, groups=o,
    bias=False)`` (``dla.py:677-687``).  ``deft_tpu/models/layers.py:92-129``
    is its JAX lowering (input-dilated conv with the kernel flipped)."""
    k = 2 * factor
    up = nn.ConvTranspose2d(channels, channels, k, stride=factor,
                            padding=factor // 2, groups=channels, bias=False)
    with torch.no_grad():
        up.weight.copy_(bilinear_upsample_kernel(k).expand(channels, 1, k, k))
    return up
