"""Deformable convolution v2, the counterpart of ``deft_tpu/models/dcn.py``.

Parameters and their layout are the reference's (CharlesShang's ``dcn_v2.DCN``
as used by every upsampling node of the DLA neck, ``dla.py:646-665``):

* ``weight`` [Cout, Cin, 3, 3] and ``bias`` [Cout];
* ``conv_offset_mask``, a zero-initialized 3x3 conv predicting 27 channels:
  channel ``2k`` is tap k's y-offset, ``2k+1`` its x-offset (the interleaved
  layout of ``o1, o2, mask = chunk(out, 3); offset = cat(o1, o2)``), and
  ``18 + k`` its mask logit.  The JAX package keeps these channels tap-major;
  ``deft_tpu_torch.convert`` permutes between the two.

``impl`` is the config's ``dcn_impl`` and picks the function as
``deft_tpu/models/dcn.py:144-198`` does, batched route included.  Under a
float32 x:

* ``gather``: ``ops.cuda_dcn.deform_conv`` with no clamp;
* ``hybrid``, ``onehot``, ``shift``: ``deform_conv``, float32, clamped.  This
  is what the JAX package computes on the CPU, where the tests hold the port
  (its hybrid takes the TPU kernel's bf16 slab only on a TPU);
* ``pallas``: ``deform_conv_tap`` (T2's counterpart) for every sample of a
  batch, as the JAX package maps its Pallas kernel over the batch;
* ``pallas_cm``: ``deform_conv_cm`` (T1's bf16 function) for one sample;
  under a batch the float32 ``deform_conv``, as the JAX package routes
  batches through ``deform_conv_onehot_remat``.

Under a bfloat16 x (``compute_dtype="bfloat16"``) the offset conv runs in
bfloat16 (``deft_tpu/models/dcn.py:126``), so the offsets are its rounded
outputs in float32; the weight is rounded to bfloat16 (:179) and the output
is bfloat16 (:198).  Each ``dcn_impl`` samples and multiplies where its JAX
function rounds:

* ``gather`` and ``pallas_cm`` (one sample): ``deform_conv_cm``, float32
  sampling to bfloat16 patches, one float32 product plus bias, rounded once
  (:209-212; ``deform_conv_pallas_cm`` :726-728); ``gather`` unclamped;
* ``shift``: ``deform_sample`` patches (the float32 sampling of
  ``deform_conv_shift_xla``), then ``deform_conv_rounded``'s product;
* ``pallas``: T2's ``deform_sample_tap`` patches, ``deform_conv_rounded``;
* ``onehot``, and ``pallas_cm`` under a batch: ``deform_sample_onehot``
  (T4's function: the hat weights rounded to bfloat16), then
  ``deform_conv_rounded``;
* ``hybrid``: as ``deform_conv_hybrid`` picks on a TPU
  (``pallas_dcn.py:752-765``), on the card one sample with C <= 128 takes
  ``deform_conv_cm`` (the channel-major kernel's function, rounded once);
  every other layer or batch, and every layer off the card (where the JAX
  hybrid takes ``deform_conv_onehot``), the ``onehot`` function.

Any other value raises.  Each function is the hand-written CUDA kernel on the
card and its plain version on the CPU (``ops/cuda_dcn.py``).

Where autograd records (``torch.is_grad_enabled()``, the training step), the
same functions run with their sampler wrapped in ``cuda_dcn.trainable``: the
forward is the same kernel (T1 at float32, T4 on a bfloat16 batch), the
backward of the sampling T5 (``deform_sample_backward``), and the weight and
bias gradients autograd of the product.  The JAX package differentiates the
onehot function there (``deform_conv_onehot_remat``); the two agree away
from integer sampling positions, and at them the port takes DCNv2's
one-sided difference (ROADMAP.md, C.3).  Nothing is rematerialized: the
sampling keeps x, offsets and mask for its backward, the product its
patches.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from deft_tpu_torch.models.layers import Conv2d
from deft_tpu_torch.ops.cuda_dcn import (KK, deform_conv, deform_conv_cm,
                                         deform_conv_rounded, deform_conv_tap,
                                         deform_sample, deform_sample_onehot,
                                         deform_sample_tap, trainable)

DCN_IMPLS = ("gather", "hybrid", "onehot", "shift", "pallas", "pallas_cm")
HYBRID_CM_CHANNELS = 128   # pallas_dcn.py:_hybrid_fastest's crossover
# the sampler each conv function of ``DCNv2._function`` calls
_SAMPLERS = {deform_conv: deform_sample, deform_conv_cm: deform_sample,
             deform_conv_tap: deform_sample_tap}


def with_grad(fn):
    """``fn``, a function of ``DCNv2._function``, with its sampler wrapped
    in ``cuda_dcn.trainable`` (T5 as the sampling's backward)."""
    if isinstance(fn, functools.partial):      # deform_conv_rounded
        return functools.partial(fn.func, trainable(fn.args[0]))
    return functools.partial(fn, sample=trainable(_SAMPLERS[fn]))


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

    def __init__(self, chi: int, cho: int, radius: int = 4,
                 impl: str = "hybrid"):
        super().__init__()
        if impl not in DCN_IMPLS:
            raise ValueError(f"unknown dcn_impl {impl!r}; one of {DCN_IMPLS}")
        self.impl = impl
        self.radius = -1 if impl == "gather" else radius   # -1: no clamp
        self.weight = nn.Parameter(torch.empty(cho, chi, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cho))
        self.conv_offset_mask = Conv2d(chi, 3 * KK, 3, padding=1, bias=True)
        # CharlesShang's init: uniform main weight, ZERO offset/mask conv
        stdv = 1.0 / math.sqrt(chi * KK)
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv)
            self.conv_offset_mask.weight.zero_()
            self.conv_offset_mask.bias.zero_()

    def _function(self, dtype: torch.dtype, channels: int, batch: int,
                  on_card: bool):
        """The function of one sample of a batch of ``batch`` with
        ``channels`` input channels in ``dtype`` (module docstring)."""
        one = batch == 1
        if dtype == torch.float32:
            if self.impl == "pallas":
                return deform_conv_tap
            if self.impl == "pallas_cm" and one:
                return deform_conv_cm
            return deform_conv
        if (self.impl == "gather" or (self.impl == "pallas_cm" and one)
                or (self.impl == "hybrid" and on_card and one
                    and channels <= HYBRID_CM_CHANNELS)):
            return deform_conv_cm
        sample = {"shift": deform_sample, "pallas": deform_sample_tap
                  }.get(self.impl, deform_sample_onehot)
        return functools.partial(deform_conv_rounded, sample)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, Cin, H, W] -> [B, Cout, H, W] in x's dtype; samples run one
        at a time."""
        # offsets in float32: sub-pixel positions need the precision
        om = self.conv_offset_mask(x).float()
        b, _, h, w = om.shape
        offsets = om[:, : 2 * KK].reshape(b, KK, 2, h, w).permute(0, 3, 4, 1, 2)
        mask = torch.sigmoid(om[:, 2 * KK:]).permute(0, 2, 3, 1)
        cho, chi = self.weight.shape[:2]
        wk = self.weight.to(x.dtype).permute(2, 3, 1, 0).reshape(
            KK * chi, cho)                                       # tap-major
        xs = x.permute(0, 2, 3, 1)
        fn = self._function(x.dtype, chi, b, x.is_cuda)
        if torch.is_grad_enabled():
            fn = with_grad(fn)
        out = torch.stack([
            fn(xs[i].contiguous(), offsets[i].contiguous(),
               mask[i].contiguous(), wk, self.bias, self.radius)
            for i in range(b)
        ])
        return out.permute(0, 3, 1, 2).contiguous()
