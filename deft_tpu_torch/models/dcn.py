"""Deformable convolution v2, the counterpart of ``deft_tpu/models/dcn.py``.

Parameters and their layout are the reference's (CharlesShang's ``dcn_v2.DCN``
as used by every upsampling node of the DLA neck, ``dla.py:646-665``):

* ``weight`` [Cout, Cin, 3, 3] and ``bias`` [Cout];
* ``conv_offset_mask``, a zero-initialized 3x3 conv predicting 27 channels:
  channel ``2k`` is tap k's y-offset, ``2k+1`` its x-offset (the interleaved
  layout of ``o1, o2, mask = chunk(out, 3); offset = cat(o1, o2)``), and
  ``18 + k`` its mask logit.  The JAX package keeps these channels tap-major;
  ``deft_tpu_torch.convert`` permutes between the two.

The sampling runs through ``ops.cuda_dcn.deform_conv``: the hand-written CUDA
kernel on the card, its plain version on the CPU.  Offsets are clamped to the
layer's radius, as every JAX DCN implementation except ``gather`` does.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from deft_tpu_torch.ops.cuda_dcn import KK, deform_conv


def resolve_radius(path: str, offset_range: int,
                   offset_range_map: Sequence[Tuple[str, int]] = ()) -> int:
    """Per-layer clamp radius (``deft_tpu/models/dcn.py:104-110``): the first
    pattern of ``offset_range_map`` (longest first, see
    ``factory.parse_layer_radii``) contained in the layer's JAX module path,
    e.g. ``trunk/dla_up/ida_0/node_1/conv``, else ``offset_range``."""
    for pat, r in offset_range_map:
        if pat in path:
            return int(r)
    return offset_range


class DCNv2(nn.Module):
    """Modulated deformable 3x3 conv (stride 1, one deformable group)."""

    def __init__(self, chi: int, cho: int, radius: int = 4):
        super().__init__()
        self.radius = radius            # negative: no clamp (dcn_impl=gather)
        self.weight = nn.Parameter(torch.empty(cho, chi, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cho))
        self.conv_offset_mask = nn.Conv2d(chi, 3 * KK, 3, padding=1, bias=True)
        # CharlesShang's init: uniform main weight, ZERO offset/mask conv
        stdv = 1.0 / math.sqrt(chi * KK)
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv)
            self.conv_offset_mask.weight.zero_()
            self.conv_offset_mask.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, Cin, H, W] -> [B, Cout, H, W]; samples run one at a time."""
        # offsets in float32: sub-pixel positions need the precision
        om = self.conv_offset_mask(x).float()
        b, _, h, w = om.shape
        offsets = om[:, : 2 * KK].reshape(b, KK, 2, h, w).permute(0, 3, 4, 1, 2)
        mask = torch.sigmoid(om[:, 2 * KK:]).permute(0, 2, 3, 1)
        cho, chi = self.weight.shape[:2]
        wk = self.weight.permute(2, 3, 1, 0).reshape(KK * chi, cho)  # tap-major
        xs = x.permute(0, 2, 3, 1)
        out = torch.stack([
            deform_conv(xs[i].contiguous(), offsets[i].contiguous(),
                        mask[i].contiguous(), wk, self.bias, self.radius)
            for i in range(b)
        ])
        return out.permute(0, 3, 1, 2).contiguous()
