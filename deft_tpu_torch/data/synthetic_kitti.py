"""A synthetic KITTI tracking sequence: cars crossing a road scene at the
size of KITTI's ``image_02`` frames, rendered with numpy.

``make_sequence`` returns the frames and their ground truth as KITTI
``label_02`` rows (``frame track_id Car truncated occluded alpha x1 y1 x2 y2
h w l x y z rot_y``, 0-based frames), which
``tools/eval_kitti.py::load_kitti_file`` reads.  The scene follows
``tools/make_synthetic_kitti.py::make_rich_sequence``: each car has a depth
that sets its on-screen size (f = 700 px, 1.7 x 1.5 m), a lane, a speed and
a direction (30% drive right to left, so paths cross), a time at which it
appears and a life, and a texture of its own (colour, stripes, a bright
centre line).  Cars are drawn far first, so near ones occlude them; a car
off-screen or a sliver narrower than 8 px has no row.  Over the background's
noise run the original's stripes.  Everything comes from ``seed``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FOCAL = 700.0      # px, as tools/make_synthetic_kitti.py's calibration


def make_sequence(n_frames: int = 30, height: int = 375, width: int = 1242,
                  n_objects: int = 20, seed: int = 0
                  ) -> Tuple[List[np.ndarray], List[str]]:
    """(``n_frames`` [height, width, 3] uint8 BGR frames, ``label_02``
    rows).  Cars appear in the first two thirds of the sequence, live at
    least half of it, and start anywhere from just off the frame's edge to
    its far side, so some enter, some leave and some cross."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    cars = []
    for tid in range(n_objects):
        depth = float(rng.uniform(8.0, 45.0))          # m; size ~ 1/depth
        bw, bh = FOCAL * 1.7 / depth, FOCAL * 1.5 / depth
        direction = 1 if rng.random() < 0.7 else -1
        speed = float(rng.uniform(1.5, 7.0)) * direction
        x0 = float(rng.uniform(-bw, w)) - speed * n_frames / 3
        cars.append({
            "tid": tid, "depth": depth, "w": bw, "h": bh, "x0": x0,
            "y": float(rng.uniform(0.35, 0.9)) * (h - bh - 4), "vx": speed,
            "vy": float(rng.uniform(-0.15, 0.15)),
            "t0": int(rng.integers(0, max(1, 2 * n_frames // 3))),
            "life": int(rng.integers(max(n_frames // 2, 1), n_frames + 1)),
            "color": rng.integers(60, 255, 3),
            "stripe": int(rng.integers(2, 6)),
        })
    base = rng.integers(0, 40, (h, w, 3)).astype(np.uint8)
    base[::11, :, 2] = 75
    base[:, ::23, 1] = 55

    frames, rows = [], []
    for f in range(n_frames):
        img = base.copy()
        live = [c for c in cars if c["t0"] <= f < c["t0"] + c["life"]]
        for c in sorted(live, key=lambda c: -c["depth"]):   # far first
            t = f - c["t0"]
            x1, y1 = c["x0"] + c["vx"] * t, c["y"] + c["vy"] * t
            x2, y2 = x1 + c["w"], y1 + c["h"]
            ix1, iy1 = max(int(x1), 0), max(int(y1), 0)
            ix2, iy2 = min(int(x2), w), min(int(y2), h)
            if ix2 - ix1 < 8 or iy2 - iy1 < 8:
                continue
            img[iy1:iy2, ix1:ix2] = c["color"]
            img[iy1:iy2:c["stripe"], ix1:ix2] = c["color"] // 2
            cx = (ix1 + ix2) // 2
            img[iy1:iy2, max(cx - 1, 0):cx + 1] = np.minimum(
                c["color"] + 60, 255)
            rows.append(
                f"{f} {c['tid']} Car 0 0 -1.50 "
                f"{max(x1, 0):.2f} {max(y1, 0):.2f} "
                f"{min(x2, w):.2f} {min(y2, h):.2f} "
                f"1.5 1.7 4.0 {(x1 - w / 2) / 50:.2f} 1.6 "
                f"{c['depth']:.2f} 1.2")
        frames.append(img)
    return frames, rows
