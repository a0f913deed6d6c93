"""The benchmark's one traffic generator: synthetic video made from a seed.

``make_scene(params, seed, device)`` draws a sequence of uint8 BGR frames
[N, H, W, 3] on the device and each frame's object boxes, after the port's
``tools/make_synthetic_mot.py --natural`` and ``make_synthetic_kitti.py
--rich`` scenes: a photographic background (smooth low-frequency
luminance, mild desaturated colour, fine grain) and textured rectangles
(a colour per identity, darker stripes of their own period) on linear
paths, far ones drawn first so near ones occlude them.  The parameters
(``benchmarks/traffic/<mix>.json``, key ``scene``):

* ``height``, ``width``, ``frames``, ``objects``;
* ``size``: ``{"mode": "pixels", "height": [lo, hi], "aspect": [lo, hi]}``
  (box height in pixels, width over height), or ``{"mode": "depth",
  "focal": f, "size_m": [w, h], "depth_m": [lo, hi]}`` (a pinhole
  camera's boxes of objects w x h metres at a depth);
* ``speed``: pixels per frame, [lo, hi], horizontal (either direction)
  with a tenth of it vertical.

Every seed draws the same number of objects and frames at the same sizes'
ranges; only where they are and how they look changes.  Boxes are
[x1, y1, x2, y2] in the frame's pixels, clipped, with the object's id;
an object that leaves the frame is left out of that frame's boxes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pingpong(i: int, n: int) -> int:
    """Frame i of a sequence of n frames played forward, then backward,
    and so on (0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...)."""
    period = 2 * (n - 1)
    j = i % period
    return j if j < n else period - j


def make_scene(params: dict, seed: int, device
               ) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """(frames uint8 [N, H, W, 3] on ``device``, per frame an [n, 5]
    float array of boxes and ids)."""
    h, w = int(params["height"]), int(params["width"])
    n_frames, n_obj = int(params["frames"]), int(params["objects"])
    rng = np.random.default_rng(int(seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    size = params["size"]
    if size["mode"] == "depth":
        depth = rng.uniform(*size["depth_m"], n_obj)
        bw = size["focal"] * size["size_m"][0] / depth
        bh = size["focal"] * size["size_m"][1] / depth
    else:
        depth = rng.uniform(1.0, 2.0, n_obj)
        bh = rng.uniform(*size["height"], n_obj)
        bw = bh * rng.uniform(*size["aspect"], n_obj)
    speed = rng.uniform(*params["speed"], n_obj) * rng.choice([-1, 1], n_obj)
    vy = speed * rng.uniform(-0.1, 0.1, n_obj)
    x0 = rng.uniform(-0.2 * w, 1.2 * w, n_obj) - speed * n_frames / 2
    y0 = rng.uniform(0.0, 1.0, n_obj) * (h - bh)
    base = rng.integers(70, 180, (n_obj, 3))
    colour = (0.7 * base.mean(axis=1, keepdims=True) + 0.3 * base)
    stripe = rng.integers(3, 7, n_obj)
    gain = rng.uniform(0.55, 0.85, n_obj)

    frames = _background(h, w, gen, device).expand(n_frames, h, w, 3).clone()
    cols = torch.tensor(colour, dtype=torch.float32, device=device)
    darks = (cols * torch.tensor(gain[:, None], dtype=torch.float32,
                                 device=device)).to(torch.uint8)
    cols = cols.to(torch.uint8)
    boxes = []
    order = np.argsort(-depth)                        # far first
    for f in range(n_frames):
        rows = []
        for i in order:
            x1, y1 = x0[i] + speed[i] * f, y0[i] + vy[i] * f
            x2, y2 = x1 + bw[i], y1 + bh[i]
            ix1, iy1 = max(int(x1), 0), max(int(y1), 0)
            ix2, iy2 = min(int(x2), w), min(int(y2), h)
            if ix2 - ix1 < 4 or iy2 - iy1 < 4:
                continue
            frames[f, iy1:iy2, ix1:ix2] = cols[i]
            frames[f, iy1:iy2:int(stripe[i]), ix1:ix2] = darks[i]
            rows.append((ix1, iy1, ix2, iy2, i))
        boxes.append(np.asarray(rows, np.float32).reshape(-1, 5))
    return frames, boxes


def _background(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """[1, H, W, 3] uint8: smooth luminance with mild colour and grain."""
    coarse = torch.randn((1, 3, h // 16 + 1, w // 16 + 1), generator=gen,
                         device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False)
    img = img + 0.25 * torch.randn((1, 3, h, w), generator=gen,
                                   device=device)
    img = (img - img.min()) / (img.max() - img.min()).clamp(min=1e-6)
    lum = img.mean(dim=1, keepdim=True)
    img = 0.75 * lum + 0.25 * img
    img = (img * 110 + 55).clamp(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1)
