"""Shared building blocks (NCHW), the counterpart of ``deft_tpu/models/layers.py``.

Module and parameter names follow the reference DEFT network, so that a
published DEFT ``state_dict`` loads directly: a conv-BN-ReLU triple is an
``nn.Sequential`` whose children ``0`` and ``1`` are the conv and the BN.

Compute dtype.  ``Conv2d``, ``ConvTranspose2d`` and ``BatchNorm2d`` compute
in the dtype of their input, the way the JAX package's flax modules compute
in their ``dtype`` (``cfg.compute_dtype``); ``DEFTNet`` casts the normalized
input once, at the trunk's entry.  Parameters stay float32, so a
``state_dict`` keeps its keys and dtypes.  Under a bfloat16 input:

* a convolution takes bfloat16 operands, accumulates in float32 and rounds
  its output to bfloat16, then adds its bias rounded to bfloat16 and rounds
  again, as ``flax.linen.Conv(dtype=bfloat16)`` does (its ``promote_dtype``
  casts input, kernel and bias; ``out += bias``);
* a BatchNorm normalizes the bfloat16 input with the float32 statistics,
  scale and bias and rounds once to bfloat16, as flax's ``_normalize``
  does (``x - mean`` promotes to float32, the result is cast to ``dtype``).
  It is never folded into the convolution, which would round elsewhere.

A float32 input runs the ``torch.nn`` module's own forward in eval mode.

In train mode a BatchNorm is flax's ``BatchNorm(use_running_average=False)``
(``train_batch_norm``): it normalizes with the batch statistics in float32
(the biased variance, taken as E[x^2] - E[x]^2 as flax takes it; over the
global batch under a process group) and updates ``running_mean`` and
``running_var`` with momentum 0.1 in torch's convention (flax's 0.9), the
variance the *biased* one, where ``torch.nn.BatchNorm2d`` takes the unbiased
one.  A module called twice in one step updates its statistics twice, in
call order.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from deft_tpu_torch import distributed

# torch BatchNorm2d(momentum=0.1) == flax BatchNorm(momentum=0.9); only the
# eval-mode running statistics matter for inference
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def torch_pad(kernel: int, dilation: int = 1) -> int:
    """Symmetric padding of a stride-s conv, torch style."""
    return dilation * (kernel // 2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no bias, no ``output_size``) computing in its
    input's dtype: the JAX upsampler casts its kernel to the input's dtype
    (``deft_tpu/models/layers.py:118-128``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class _TrainBatchNorm(torch.autograd.Function):
    """flax's train-mode BatchNorm over every axis of ``x`` but axis 1,
    with its moments over the global batch (``distributed.global_sum``):
    forward (x, weight, bias) -> (y, mean, var); the backward sums dy and
    dy * x_hat over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        count = x.numel() // x.shape[1] * distributed.world_size()
        sums = distributed.global_sum(
            torch.stack([x.sum(dims), (x * x).sum(dims)]))
        mean = sums[0] / count
        # flax's variance: E[x^2] - E[x]^2 in float32, floored at 0
        var = (sums[1] / count - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x - mean.view(shape)) * (invstd * weight).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, mean, invstd, weight = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        x_hat = (x - mean.view(shape)) * invstd.view(shape)
        local = torch.stack([dy.sum(dims), (dy * x_hat).sum(dims)])
        sums = distributed.global_sum(local) / ctx.count
        dx = (dy - sums[0].view(shape) - x_hat * sums[1].view(shape)) \
            * (invstd * weight).view(shape)
        # this rank's parts of the weight's and bias's gradients: the
        # trainer sums those over the ranks
        return dx, local[1], local[0], None


def train_batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax's train-mode BatchNorm over every axis of float32 ``x`` but
    axis 1 (module docstring): the batch-normalized ``x``, and ``bn``'s
    running statistics updated with the batch's biased variance.  Under a
    process group the batch is the global one (``deft_tpu_torch.
    distributed``): the moments and the backward's sums are summed over
    the ranks, and every rank's running statistics get the global
    moments."""
    y, mean, var = _TrainBatchNorm.apply(x, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` in float32 whatever its input, its result in the
    input's dtype; in train mode flax's statistics (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return train_batch_norm(x.float(), self).to(x.dtype)
        if x.dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNReLU(nn.Sequential):
    """Conv -> BN -> optional ReLU (reference ``dla.py:40-44`` pattern);
    children ``0`` (conv), ``1`` (bn), ``2`` (relu)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True):
        layers = [
            Conv2d(cin, cout, kernel, stride=stride,
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


def bilinear_upsampler(channels: int, factor: int) -> ConvTranspose2d:
    """Depthwise transposed conv, bilinear-initialized: the reference's own
    ``nn.ConvTranspose2d(o, o, f*2, stride=f, padding=f//2, groups=o,
    bias=False)`` (``dla.py:677-687``).  ``deft_tpu/models/layers.py:92-129``
    is its JAX lowering (input-dilated conv with the kernel flipped)."""
    k = 2 * factor
    up = ConvTranspose2d(channels, channels, k, stride=factor,
                            padding=factor // 2, groups=channels, bias=False)
    with torch.no_grad():
        up.weight.copy_(bilinear_upsample_kernel(k).expand(channels, 1, k, k))
    return up
