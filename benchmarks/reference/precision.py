"""The control's lower precision: float8 e4m3 below the configurations'
bfloat16.

``fp8(t)`` rounds a tensor to float8 e4m3 with one scale per tensor (its
largest magnitude to e4m3's largest, 448), as a per-tensor-scaled fp8
network holds its operands and activations, and returns it in float32.
The backward passes the gradient straight through the rounding.
``Reference(..., quant=fp8)`` rounds the operands and the result of every
convolution and product so, as the bfloat16 program rounds them to
bfloat16.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()
