"""KITTI tracking evaluation via the CLEAR machinery, copied from
``tools/eval_kitti.py`` (numpy only; the port keeps its own copy).

The reference shells out to ``tools/eval_kitti_track/evaluate_tracking.py``
which it does not ship (kitti_tracking.py:121-126).  This evaluator parses
KITTI label/result files and reports CLEAR-MOT + IDF1 per class using the
same implementation as tools/eval_mot.py (note: the official KITTI devkit
adds truncation/occlusion-based don't-care filtering; numbers here are a
faithful internal benchmark, official numbers come from the KITTI server).

CLI: python -m deft_tpu_torch.tools.eval_kitti <label_02_dir> <results_dir> [--class Car]
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict

import numpy as np

from deft_tpu_torch.tools.eval_mot import combine, evaluate_sequence


def load_kitti_file(path: str, class_name: str = "Car") -> Dict[int, list]:
    out: Dict[int, list] = defaultdict(list)
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 10:
                continue
            frame, tid, ctype = int(parts[0]), int(parts[1]), parts[2]
            if ctype.lower() != class_name.lower():
                continue
            if tid < 0:
                continue
            x1, y1, x2, y2 = map(float, parts[6:10])
            out[frame].append((tid, np.array([x1, y1, x2 - x1, y2 - y1])))
    return out


def evaluate_kitti_dir(gt_dir: str, results_dir: str, class_name: str = "Car"):
    seqs = [f[:-4] for f in os.listdir(results_dir) if f.endswith(".txt")]
    per_seq = {}
    for seq in sorted(seqs):
        gt = load_kitti_file(os.path.join(gt_dir, f"{seq}.txt"), class_name)
        hyp = load_kitti_file(os.path.join(results_dir, f"{seq}.txt"), class_name)
        if not gt:
            print(f"eval_kitti: no GT for {seq}; skipping")
            continue
        per_seq[seq] = evaluate_sequence(gt, hyp)
    if not per_seq:
        return {}
    overall = combine(list(per_seq.values()))
    print(f"KITTI {class_name}: MOTA {overall['mota']*100:.2f} "
          f"MOTP {overall['motp']*100:.2f} IDF1 {overall['idf1']*100:.2f} "
          f"IDs {overall['num_switches']} "
          f"MT {overall['mostly_tracked']}/{overall['num_gt_tracks']} "
          f"ML {overall['mostly_lost']}/{overall['num_gt_tracks']}")
    return {"per_seq": per_seq, "overall": overall}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("gt_dir")
    ap.add_argument("results_dir")
    ap.add_argument("--class", dest="class_name", default="Car")
    args = ap.parse_args()
    evaluate_kitti_dir(args.gt_dir, args.results_dir, args.class_name)


if __name__ == "__main__":
    main()
