"""Synthetic KITTI-tracking-layout data (cars as moving rectangles) for
end-to-end runs, the port's copy of the JAX repo's
``tools/make_synthetic_kitti.py``:

    python -m deft_tpu_torch.tools.make_synthetic_kitti \\
        --out data/kitti_tracking [--seqs 2] [--frames 30] \\
        [--rich --objects 60] [--seed 0]

Writes ``data_tracking_image_2/training/image_02/<seq>/%06d.png``,
``label_02/<seq>.txt`` and ``calib/<seq>.txt``.  From the same flags it
writes the same files as the JAX tool: the same random draws, label rows
and calib text, and PNG frames that decode to the same pixels (written by
``data/image_io.imwrite_png``, which needs no cv2).  ``data/
synthetic_kitti.py`` is another scene, returned as arrays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from deft_tpu_torch.data.image_io import imwrite_png


def make_sequence(root, seq, n_frames=30, w=512, h=160, n_obj=4, seed=0):
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "data_tracking_image_2", "training",
                           "image_02", seq)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "label_02"), exist_ok=True)
    os.makedirs(os.path.join(root, "calib"), exist_ok=True)

    with open(os.path.join(root, "calib", f"{seq}.txt"), "w") as f:
        f.write("P2: 700.0 0.0 256.0 0.0 0.0 700.0 80.0 0.0 0.0 0.0 1.0 0.0\n")

    objs = []
    for i in range(n_obj):
        objs.append({
            "x": float(rng.randint(5, w // 3)), "y": float(rng.randint(10, h - 60)),
            "vx": float(rng.uniform(2.0, 6.0)), "w": float(rng.randint(30, 50)),
            "h": float(rng.randint(30, 50)),
            "color": tuple(int(c) for c in rng.randint(70, 255, 3)),
        })

    rows = []
    for f in range(n_frames):
        img = np.full((h, w, 3), 30, np.uint8)
        img[::13, :, 2] = 70
        for tid, o in enumerate(objs):
            x = o["x"] + o["vx"] * f
            if x + o["w"] >= w:
                continue
            x1, y1, x2, y2 = int(x), int(o["y"]), int(x + o["w"]), int(o["y"] + o["h"])
            img[y1:y2, x1:x2] = o["color"]
            img[y1:y2:3, x1:x2] = tuple(c // 2 for c in o["color"])
            rows.append(
                f"{f} {tid} Car 0 0 -1.5 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}"
                f" 1.5 1.7 4.0 {x1 / 50:.2f} 1.6 {20 + tid * 5:.2f} 1.2"
            )
        imwrite_png(os.path.join(img_dir, f"{f:06d}.png"), img)
    with open(os.path.join(root, "label_02", f"{seq}.txt"), "w") as fl:
        fl.write("\n".join(rows) + "\n")


def make_rich_sequence(root, seq, n_frames=300, w=1280, h=384, n_obj=60,
                       seed=0):
    """Full-scale soak sequence: KITTI-shaped 384x1280 frames, 50+ cars
    with spawn/despawn, crossing trajectories (real occlusions),
    depth-scaled box sizes, and per-identity texture so the cascade is
    exercised at realistic detection density."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "data_tracking_image_2", "training",
                           "image_02", seq)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "label_02"), exist_ok=True)
    os.makedirs(os.path.join(root, "calib"), exist_ok=True)
    with open(os.path.join(root, "calib", f"{seq}.txt"), "w") as f:
        f.write("P2: 700.0 0.0 640.0 0.0 0.0 700.0 180.0 0.0 "
                "0.0 0.0 1.0 0.0\n")

    objs = []
    for i in range(n_obj):
        depth = float(rng.uniform(8.0, 45.0))          # m; size ~ 1/depth
        bw = 700.0 * 1.7 / depth                       # ~car width on screen
        bh = 700.0 * 1.5 / depth
        lane_y = float(rng.uniform(0.35, 0.9)) * (h - bh - 4)
        direction = 1 if rng.rand() < 0.7 else -1
        speed = float(rng.uniform(1.5, 7.0)) * direction
        span = w + 2 * bw + abs(speed) * 40
        start = (-bw - rng.rand() * span if direction > 0
                 else w + rng.rand() * span)
        objs.append({
            "tid": i, "x0": start, "y": lane_y, "vx": speed,
            "vy": float(rng.uniform(-0.15, 0.15)),
            "w": bw, "h": bh, "depth": depth,
            "t0": int(rng.randint(0, max(1, n_frames - 40))),
            "life": int(rng.randint(min(120, max(n_frames // 2, 1)),
                                    n_frames + 1)),
            "color": tuple(int(c) for c in rng.randint(60, 255, 3)),
            "stripe": int(rng.randint(2, 6)),
        })

    rows = []
    for f in range(n_frames):
        img = np.full((h, w, 3), 28, np.uint8)
        img[::11, :, 2] = 75
        img[:, ::23, 1] = 55
        # painter's order: far (small) first so near cars occlude far ones
        # (a stable sort, as the JAX tool's)
        active = [o for o in objs
                  if o["t0"] <= f < o["t0"] + o["life"]]
        active.sort(key=lambda o: -o["depth"])
        for o in active:
            t_rel = f - o["t0"]
            x = o["x0"] + o["vx"] * t_rel
            y = o["y"] + o["vy"] * t_rel
            x1, y1 = x, y
            x2, y2 = x + o["w"], y + o["h"]
            # int() truncates toward zero before the clamp, as the JAX tool
            ix1, iy1 = max(int(x1), 0), max(int(y1), 0)
            ix2, iy2 = min(int(x2), w), min(int(y2), h)
            if ix2 - ix1 < 8 or iy2 - iy1 < 8:
                continue        # off-screen / sliver: no GT row either
            img[iy1:iy2, ix1:ix2] = o["color"]
            img[iy1:iy2:o["stripe"], ix1:ix2] = tuple(
                c // 2 for c in o["color"])
            cx = (ix1 + ix2) // 2
            img[iy1:iy2, max(cx - 1, 0):cx + 1] = tuple(
                min(255, c + 60) for c in o["color"])
            alpha = -1.5
            # the 3-D x keeps the unclamped x1
            rows.append(
                f"{f} {o['tid']} Car 0 0 {alpha:.2f} "
                f"{max(x1, 0):.2f} {max(y1, 0):.2f} "
                f"{min(x2, w):.2f} {min(y2, h):.2f} "
                f"1.5 1.7 4.0 {(x1 - w / 2) / 50:.2f} 1.6 "
                f"{o['depth']:.2f} 1.2"
            )
        imwrite_png(os.path.join(img_dir, f"{f:06d}.png"), img)
    with open(os.path.join(root, "label_02", f"{seq}.txt"), "w") as fl:
        fl.write("\n".join(rows) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/kitti_tracking")
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--rich", action="store_true",
                    help="full-scale soak sequences (384x1280, 50+ objects)")
    ap.add_argument("--objects", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed (sequence i uses seed+i); the fixture is "
                         "fully deterministic, so soaks regenerate it at run "
                         "time instead of committing it")
    args = ap.parse_args(argv)
    for i in range(args.seqs):
        if args.rich:
            make_rich_sequence(args.out, f"{i:04d}", n_frames=args.frames,
                               n_obj=args.objects, seed=args.seed + i)
        else:
            make_sequence(args.out, f"{i:04d}", n_frames=args.frames,
                          seed=args.seed + i)
    print(f"synthetic KITTI data at {args.out}")


if __name__ == "__main__":
    main()
