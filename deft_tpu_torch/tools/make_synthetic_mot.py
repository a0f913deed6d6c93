"""Synthetic MOTChallenge-layout dataset for end-to-end runs, the port's copy
of the JAX repo's ``tools/make_synthetic_mot.py``:

    python -m deft_tpu_torch.tools.make_synthetic_mot --out data/mot17 \\
        [--seqs 2] [--frames 40] [--size 640x360] [--natural]

Coloured rectangles moving on linear paths with per-object texture;
``train/SYN-<i>/img1/%06d.jpg`` and ``gt/gt.txt`` in the exact MOT layout,
so the whole chain (``convert_mot_to_coco`` -> ``train`` -> ``test`` ->
``eval_mot``) runs without real data.  From the same flags it writes the
same files as the JAX tool: the same random draws in the same order, the
same pixels (colours are BGR triples, as cv2 takes them) and the same
``gt.txt``.  The frames go through ``data/image_io.imwrite_jpeg`` (cv2's
encoder with its defaults, else PIL's at the same settings).  Under
``--natural`` the background's cubic upsampling is ``ops/warp.py::
resize_cubic`` in place of cv2's, within 1e-6 of it before the uint8 cast.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from deft_tpu_torch.data.image_io import imwrite_jpeg
from deft_tpu_torch.ops.warp import resize_cubic


def _natural_bg(rng, w, h):
    """Photographic-statistics background: smooth low-frequency luminance
    (1/f-ish) with mild desaturated colour, the regime that chroma
    subsampling sees in real video."""
    base = rng.normal(0, 1, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    big = resize_cubic(base, w, h)
    fine = rng.normal(0, 0.25, (h, w, 3)).astype(np.float32)
    img = big + fine
    img -= img.min()
    img /= max(float(np.ptp(img)), 1e-6)
    # compress toward gray: mean luminance 110, chroma spread ~25
    lum = img.mean(axis=2, keepdims=True)
    img = 0.75 * lum + 0.25 * img
    return np.clip(img * 110 + 55, 0, 255).astype(np.uint8)


def make_sequence(root, seq, n_frames=40, w=640, h=360, n_obj=5, seed=0,
                  natural=False):
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, seq, "img1")
    gt_dir = os.path.join(root, seq, "gt")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    objs = []
    for i in range(n_obj):
        if natural:
            # desaturated, texture-dominant identities (photographic regime)
            base = rng.randint(70, 180, 3)
            color = tuple(int(c) for c in
                          (0.7 * base.mean() + 0.3 * base).astype(int))
        else:
            color = tuple(int(c) for c in rng.randint(60, 255, 3))
        objs.append({
            "x": float(rng.randint(10, w // 3)),
            "y": float(rng.randint(10, h - 90)),
            "vx": float(rng.uniform(1.5, 5.0)),
            "vy": float(rng.uniform(-1.0, 1.0)),
            "w": float(rng.randint(24, 40)),
            "h": float(rng.randint(48, 80)),
            "color": color,
            "tex_period": int(rng.randint(3, 7)),
            "tex_gain": float(rng.uniform(0.55, 0.85)),
        })

    bg = _natural_bg(rng, w, h) if natural else None
    gt_rows = []
    for f in range(1, n_frames + 1):
        if natural:
            img = bg.copy()
        else:
            img = np.full((h, w, 3), 35, np.uint8)
            # textured background so the detector has something to learn
            # against
            img[::17, :, 1] = 60
        for tid, o in enumerate(objs, start=1):
            x = o["x"] + o["vx"] * (f - 1)
            y = o["y"] + o["vy"] * (f - 1)
            if x + o["w"] >= w or y + o["h"] >= h or y < 0:
                continue
            x1, y1 = int(x), int(y)
            x2, y2 = int(x + o["w"]), int(y + o["h"])
            img[y1:y2, x1:x2] = o["color"]
            # per-identity texture: luminance stripes (natural) or the
            # saturated half-tone rows (default)
            if natural:
                img[y1:y2:o["tex_period"], x1:x2] = tuple(
                    int(c * o["tex_gain"]) for c in o["color"])
            else:
                img[y1:y2:4, x1:x2] = tuple(c // 2 for c in o["color"])
            gt_rows.append(
                f"{f},{tid},{x:.1f},{y:.1f},{o['w']:.1f},{o['h']:.1f},1,1,1"
            )
        imwrite_jpeg(os.path.join(img_dir, f"{f:06d}.jpg"), img)
    with open(os.path.join(gt_dir, "gt.txt"), "w") as fgt:
        fgt.write("\n".join(gt_rows) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/mot17")
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", type=str, default="640x360")
    ap.add_argument("--natural", action="store_true",
                    help="photographic-statistics textures (smooth "
                         "desaturated background, luminance-textured "
                         "objects) -- the regime for the YUV 4:2:0 A/B")
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    train = os.path.join(args.out, "train")
    for i in range(args.seqs):
        make_sequence(train, f"SYN-{i+1:02d}", n_frames=args.frames,
                      w=w, h=h, seed=i, natural=args.natural)
    print(f"synthetic MOT data at {train}")


if __name__ == "__main__":
    main()
