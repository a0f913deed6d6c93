"""Affine input warp as two matrix products, the counterpart of
``deft_tpu/ops/warp.py``.

Every transform of DEFT's preprocessing has rotation 0, so the warp is
separable: dst(y, x) = sum_j sum_i Ry[y, j] * src[j, i] * Rx[x, i], with 1-D
bilinear hat matrices Rx[x, i] = max(0, 1 - |a*x + b - i|).  It takes the
place of the reference's ``cv2.warpAffine`` (the port does not use cv2) and
runs on whatever device the frame lies on.  Border semantics match cv2's
BORDER_CONSTANT(0); cv2 quantizes its bilinear weights to 5 bits, so parity
with cv2 is within about one uint8 step, not bit-exact.  The output stays
float, with no uint8 round, as in the JAX package's device warp.
"""

from __future__ import annotations

import numpy as np
import torch

from deft_tpu_torch.ops.affine import get_affine_transform


def hat_matrix(coef_a: float, coef_b: float, out_n: int, src_n: int,
               device=None) -> torch.Tensor:
    """[out_n, src_n] bilinear interpolation matrix for the 1-D affine map
    ``src = coef_a * dst + coef_b`` (pixel indices)."""
    src = (torch.tensor(coef_a, dtype=torch.float32, device=device)
           * torch.arange(out_n, dtype=torch.float32, device=device)
           + torch.tensor(coef_b, dtype=torch.float32, device=device))
    grid = torch.arange(src_n, dtype=torch.float32, device=device)
    return (1.0 - (src[:, None] - grid[None, :]).abs()).clamp(min=0.0)


def warp_affine_separable(image: torch.Tensor, inv_tf, out_h: int,
                          out_w: int) -> torch.Tensor:
    """Batched separable affine warp.

    image: [B, H, W, C] (uint8 or float); inv_tf: [6] flattened 2x3 INVERSE
    transform (dst -> src) with zero off-diagonal terms.  Returns float32
    [B, out_h, out_w, C] on the image's device.
    """
    _, h, w, _ = image.shape
    tf = [float(v) for v in np.asarray(inv_tf, np.float32).reshape(-1)]
    dev = image.device
    rx = hat_matrix(tf[0], tf[2], out_w, w, dev)             # [out_w, W]
    ry = hat_matrix(tf[4], tf[5], out_h, h, dev)             # [out_h, H]
    return warp_affine_with(image, rx, ry)


def warp_affine_with(image: torch.Tensor, rx: torch.Tensor,
                     ry: torch.Tensor) -> torch.Tensor:
    """The warp with its hat matrices given: [B, H, W, C] -> float32
    [B, out_h, out_w, C]."""
    t = torch.einsum("bhwc,ow->bhoc", image.float(), rx)
    return torch.einsum("bhoc,ph->bpoc", t, ry)


def separable_inverse_tf(c, s, out_w: int, out_h: int) -> np.ndarray:
    """The flattened inverse transform for the fix_res geometry, checking
    that it is separable (rotation 0 keeps the off-diagonals ~0)."""
    inv = np.asarray(get_affine_transform(c, s, 0, [out_w, out_h], inv=True),
                     np.float32)
    if abs(inv[0, 1]) >= 1e-5 or abs(inv[1, 0]) >= 1e-5:
        raise ValueError("non-separable affine (rotation != 0)")
    return inv.reshape(-1)
