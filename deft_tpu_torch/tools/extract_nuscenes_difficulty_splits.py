#!/usr/bin/env python
"""nuScenes difficulty-split analysis, copied from
``tools/extract_nuscenes_difficulty_splits.py`` (json and numpy only):

    python -m deft_tpu_torch.tools.extract_nuscenes_difficulty_splits \\
        --ann data/nuscenes/annotations/val.json

Equivalent of the reference ``src/extract_nuscenes_difficulty_splits.py``
(372 LoC): scores each validation track by occlusion (visibility gaps in its
camera observations) and motion (global-frame displacement variance), then
partitions tracks into easy/medium/hard splits and writes per-split GT
subsets for targeted evaluation.

Works off the converted annotation json (``deft_tpu_torch/tools/
convert_nuscenes.py``), so no devkit is needed.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def analyze(ann_path: str):
    with open(ann_path) as f:
        dataset = json.load(f)
    images = {im["id"]: im for im in dataset["images"]}

    tracks = defaultdict(list)
    for a in dataset["annotations"]:
        im = images[a["image_id"]]
        tracks[a["track_id"]].append({
            "frame": im["frame_id"],
            "video": im["video_id"],
            "sensor": im.get("sensor_id", 1),
            "loc": a.get("location", [0, 0, 0]),
            "depth": a.get("depth", 0.0),
            "area": a.get("area", 1.0),
        })

    rows = []
    for tid, obs in tracks.items():
        obs.sort(key=lambda o: o["frame"])
        frames = [o["frame"] for o in obs]
        span = frames[-1] - frames[0] + 1
        coverage = len(frames) / max(span, 1)          # 1.0 = never occluded
        locs = np.array([o["loc"] for o in obs], np.float64)
        if len(locs) > 1:
            steps = np.linalg.norm(np.diff(locs, axis=0), axis=1)
            motion = float(steps.mean())
            motion_var = float(steps.std())
        else:
            motion = motion_var = 0.0
        depth = float(np.mean([o["depth"] for o in obs]))
        # difficulty score: occlusion gaps + erratic motion + distance
        difficulty = (1.0 - coverage) * 2.0 + motion_var + depth / 40.0
        rows.append({
            "track_id": tid, "video": obs[0]["video"], "n_obs": len(obs),
            "coverage": coverage, "motion": motion, "motion_var": motion_var,
            "mean_depth": depth, "difficulty": difficulty,
        })
    return rows, dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann", default="data/nuscenes/annotations/val.json")
    ap.add_argument("--out_dir", default="data/nuscenes/annotations")
    args = ap.parse_args(argv)
    rows, dataset = analyze(args.ann)
    if not rows:
        print("no tracks found")
        return

    diffs = np.array([r["difficulty"] for r in rows])
    lo, hi = np.percentile(diffs, [33, 66])
    split_of = {}
    for r in rows:
        split_of[r["track_id"]] = ("easy" if r["difficulty"] <= lo
                                   else "medium" if r["difficulty"] <= hi
                                   else "hard")
    counts = defaultdict(int)
    for v in split_of.values():
        counts[v] += 1
    print(f"tracks: {len(rows)}  easy {counts['easy']} "
          f"medium {counts['medium']} hard {counts['hard']}")
    print(f"difficulty thresholds: easy<={lo:.3f} medium<={hi:.3f}")

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.ann))[0]
    for split in ("easy", "medium", "hard"):
        keep = {tid for tid, s in split_of.items() if s == split}
        sub = dict(dataset)
        sub["annotations"] = [a for a in dataset["annotations"]
                              if a["track_id"] in keep]
        out = os.path.join(args.out_dir, f"{base}_{split}.json")
        with open(out, "w") as f:
            json.dump(sub, f)
        print(f"wrote {out}: {len(sub['annotations'])} annotations")
    with open(os.path.join(args.out_dir, f"{base}_difficulty.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
