"""Bilinear point sampling, the counterpart of ``deft_tpu/ops/sampling.py``.

The AFE matching head samples its selector maps at object centers the way the
reference's ``F.grid_sample(..., padding_mode="border")`` does.  Layout is the
JAX function's: ``feat`` [H, W, C], normalized (x, y) points in [-1, 1].
``align_corners`` is explicit because torch 2.x defaults to False while the
reference's pinned torch 1.2 (and ``Config.align_corners``) used True.
"""

from __future__ import annotations

import torch


def _denormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def bilinear_sample(feat: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` [H, W, C] at float pixel coords ``x``, ``y`` (same
    shape), clamping corner indices to the image.  Returns [..., C]."""
    h, w, _ = feat.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def tap(xi, yi):
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        return feat[yc, xc]

    return (tap(x0, y0) * (wx0 * wy0)[..., None]
            + tap(x1, y0) * (wx1 * wy0)[..., None]
            + tap(x0, y1) * (wx0 * wy1)[..., None]
            + tap(x1, y1) * (wx1 * wy1)[..., None])


def grid_sample_points(feat: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = True) -> torch.Tensor:
    """Sample [H, W, C] features at normalized points ``grid`` [N, 2]
    (x, y in [-1, 1]) with border padding.  Returns [N, C]."""
    h, w, _ = feat.shape
    x = _denormalize(grid[:, 0], w, align_corners).clamp(0.0, w - 1.0)
    y = _denormalize(grid[:, 1], h, align_corners).clamp(0.0, h - 1.0)
    return bilinear_sample(feat, x, y)
