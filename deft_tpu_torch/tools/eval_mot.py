"""CLEAR-MOT + identity metrics evaluator, copied from
``tools/eval_mot.py`` (numpy only; the port keeps its own copy).

Replaces the reference's ``src/tools/eval_motchallenge.py`` (a py-motmetrics
wrapper; motmetrics is not available here) with a direct implementation of
the CLEAR rules (Bernardin & Stiefelhagen) and ID metrics (Ristani et al.):

* per-frame: persistent matches kept while IoU >= 0.5, Hungarian on the rest;
* MOTA = 1 - (FN + FP + IDSW) / GT;  MOTP = mean IoU of matches;
* IDF1 via global track-to-track assignment on overlap counts;
* MT / ML at the usual 80% / 20% coverage thresholds.

CLI: python -m deft_tpu_torch.tools.eval_mot <gt_root> <results_dir> [--gt_type _val_half]
where <gt_root>/<seq>/gt/gt{gt_type}.txt are MOTChallenge-format ground-truth
files and <results_dir>/<seq>.txt are tracker outputs.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """tlwh boxes -> IoU (MOTChallenge convention, no +1)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, :2] + a[:, None, 2:4],
                    b[None, :, :2] + b[None, :, 2:4])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def evaluate_sequence(gt: Dict[int, List[Tuple[int, np.ndarray]]],
                      hyp: Dict[int, List[Tuple[int, np.ndarray]]],
                      iou_thresh: float = 0.5) -> Dict[str, float]:
    """gt/hyp: frame -> list of (track_id, tlwh box)."""
    frames = sorted(set(gt) | set(hyp))
    matches: Dict[int, int] = {}          # gt_id -> last known hyp_id
    n_gt = n_fp = n_fn = n_idsw = n_frag = n_match = 0
    sum_iou = 0.0
    gt_frames_per_track = defaultdict(int)
    covered_per_track = defaultdict(int)
    # fragmentation bookkeeping (py-motmetrics semantics: a FRAG is counted
    # when a gt object is re-acquired after >= 1 MISS event since its last
    # match -- i.e. present-but-unmatched frames interrupt the track)
    missed_since_match: Dict[int, bool] = {}
    # for ID metrics
    overlap_count = defaultdict(int)      # (gt_id, hyp_id) -> co-detected frames
    gt_total = defaultdict(int)
    hyp_total = defaultdict(int)

    for f in frames:
        gts = gt.get(f, [])
        hyps = hyp.get(f, [])
        gt_ids = [g[0] for g in gts]
        hyp_ids = [h[0] for h in hyps]
        gt_boxes = np.array([g[1] for g in gts]).reshape(-1, 4)
        hyp_boxes = np.array([h[1] for h in hyps]).reshape(-1, 4)
        n_gt += len(gts)
        for gid in gt_ids:
            gt_frames_per_track[gid] += 1
            gt_total[gid] += 1
        for hid in hyp_ids:
            hyp_total[hid] += 1

        iou = _iou_matrix(gt_boxes, hyp_boxes)
        # ID-metrics overlap bookkeeping (any pair above threshold counts
        # toward the global track assignment)
        for gi, gid in enumerate(gt_ids):
            for hi, hid in enumerate(hyp_ids):
                if iou[gi, hi] >= iou_thresh:
                    overlap_count[(gid, hid)] += 1

        # 1) keep persistent matches still valid
        frame_matches = {}
        used_h = set()
        for gi, gid in enumerate(gt_ids):
            hid = matches.get(gid)
            if hid is not None and hid in hyp_ids:
                hi = hyp_ids.index(hid)
                if iou[gi, hi] >= iou_thresh:
                    frame_matches[gid] = hid
                    used_h.add(hid)
                    sum_iou += iou[gi, hi]

        # 2) Hungarian on the rest
        free_g = [i for i, gid in enumerate(gt_ids) if gid not in frame_matches]
        free_h = [i for i, hid in enumerate(hyp_ids) if hid not in used_h]
        if free_g and free_h:
            cost = 1.0 - iou[np.ix_(free_g, free_h)]
            cost[cost > 1.0 - iou_thresh] = 1e6
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] < 1e6:
                    gid = gt_ids[free_g[r]]
                    hid = hyp_ids[free_h[c]]
                    frame_matches[gid] = hid
                    sum_iou += iou[free_g[r], free_h[c]]
                    if gid in matches and matches[gid] != hid:
                        n_idsw += 1

        n_match += len(frame_matches)
        n_fn += len(gts) - len(frame_matches)
        n_fp += len(hyps) - len(frame_matches)
        for gid, hid in frame_matches.items():
            covered_per_track[gid] += 1
            if missed_since_match.get(gid):
                n_frag += 1
            missed_since_match[gid] = False
            matches[gid] = hid
        for gid in gt_ids:
            if gid not in frame_matches and gid in matches:
                missed_since_match[gid] = True

    # ---- identity metrics (global assignment) ------------------------------
    gt_ids_all = sorted(gt_total)
    hyp_ids_all = sorted(hyp_total)
    ng, nh = len(gt_ids_all), len(hyp_ids_all)
    if ng and nh:
        size = ng + nh
        cost = np.zeros((size, size))
        for i, gid in enumerate(gt_ids_all):
            cost[i, nh:] = gt_total[gid]
            for j, hid in enumerate(hyp_ids_all):
                ov = overlap_count.get((gid, hid), 0)
                cost[i, j] = gt_total[gid] + hyp_total[hid] - 2 * ov
        for j, hid in enumerate(hyp_ids_all):
            cost[ng:, j] = hyp_total[hid]
        rows, cols = linear_sum_assignment(cost)
        idtp = 0
        for r, c in zip(rows, cols):
            if r < ng and c < nh:
                idtp += overlap_count.get((gt_ids_all[r], hyp_ids_all[c]), 0)
    else:
        idtp = 0
    total_gt_frames = sum(gt_total.values())
    total_hyp_frames = sum(hyp_total.values())
    idfn = total_gt_frames - idtp
    idfp = total_hyp_frames - idtp
    idf1 = (2 * idtp / (2 * idtp + idfp + idfn)
            if (2 * idtp + idfp + idfn) else 0.0)

    # py-motmetrics boundaries: MT at ratio >= 0.8, ML STRICTLY < 0.2
    # (a track covered exactly 20% is partially tracked, not mostly lost)
    mt = sum(1 for gid, tot in gt_frames_per_track.items()
             if covered_per_track.get(gid, 0) / tot >= 0.8)
    ml = sum(1 for gid, tot in gt_frames_per_track.items()
             if covered_per_track.get(gid, 0) / tot < 0.2)

    mota = 1.0 - (n_fn + n_fp + n_idsw) / max(n_gt, 1)
    motp = sum_iou / max(n_match, 1)
    return {
        "mota": mota, "motp": motp, "idf1": idf1,
        "num_switches": n_idsw, "num_fragmentations": n_frag,
        "num_false_positives": n_fp,
        "num_misses": n_fn, "num_objects": n_gt, "num_matches": n_match,
        "mostly_tracked": mt, "mostly_lost": ml,
        "num_gt_tracks": len(gt_frames_per_track),
        "idtp": idtp, "idfp": idfp, "idfn": idfn,
    }


def load_mot_file(path: str, is_gt: bool = False,
                  min_conf: float = -1.0) -> Dict[int, List]:
    """frame -> [(id, tlwh)] from a MOTChallenge csv."""
    out: Dict[int, List] = defaultdict(list)
    if not os.path.exists(path):
        return out
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    if data.size == 0:
        return out
    for row in data:
        frame, tid = int(row[0]), int(row[1])
        box = row[2:6].astype(np.float64)
        conf = row[6] if len(row) > 6 else 1.0
        if is_gt and conf == 0:
            continue  # MOTChallenge: conf 0 marks ignore entries
        if not is_gt and conf < min_conf:
            continue
        out[frame].append((tid, box))
    return out


def combine(metrics_list: List[Dict[str, float]]) -> Dict[str, float]:
    agg = {k: sum(m[k] for m in metrics_list)
           for k in ("num_switches", "num_fragmentations",
                     "num_false_positives", "num_misses",
                     "num_objects", "num_matches", "mostly_tracked",
                     "mostly_lost", "num_gt_tracks", "idtp", "idfp", "idfn")}
    agg["mota"] = 1.0 - (
        agg["num_misses"] + agg["num_false_positives"] + agg["num_switches"]
    ) / max(agg["num_objects"], 1)
    wm = sum(m["motp"] * m["num_matches"] for m in metrics_list)
    agg["motp"] = wm / max(agg["num_matches"], 1)
    denom = 2 * agg["idtp"] + agg["idfp"] + agg["idfn"]
    agg["idf1"] = 2 * agg["idtp"] / denom if denom else 0.0
    return agg


def evaluate_mot_dir(gt_root: str, results_dir: str, gt_type: str = ""):
    seqs = [f[:-4] for f in os.listdir(results_dir) if f.endswith(".txt")]
    per_seq = {}
    for seq in sorted(seqs):
        gt_path = os.path.join(gt_root, seq, "gt", f"gt{gt_type}.txt")
        gt = load_mot_file(gt_path, is_gt=True)
        hyp = load_mot_file(os.path.join(results_dir, f"{seq}.txt"))
        if not gt:
            print(f"eval_mot: no GT for {seq} at {gt_path}; skipping")
            continue
        per_seq[seq] = evaluate_sequence(gt, hyp)
    if not per_seq:
        return {}
    overall = combine(list(per_seq.values()))
    header = f"{'seq':20s} {'MOTA':>7s} {'MOTP':>7s} {'IDF1':>7s} {'IDs':>5s} {'FP':>6s} {'FN':>6s}"
    print(header)
    for seq, m in per_seq.items():
        print(f"{seq:20s} {m['mota']*100:7.2f} {m['motp']*100:7.2f} "
              f"{m['idf1']*100:7.2f} {m['num_switches']:5d} "
              f"{m['num_false_positives']:6d} {m['num_misses']:6d}")
    m = overall
    print(f"{'OVERALL':20s} {m['mota']*100:7.2f} {m['motp']*100:7.2f} "
          f"{m['idf1']*100:7.2f} {m['num_switches']:5d} "
          f"{m['num_false_positives']:6d} {m['num_misses']:6d}")
    return {"per_seq": per_seq, "overall": overall}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("gt_root")
    ap.add_argument("results_dir")
    ap.add_argument("--gt_type", default="")
    ap.add_argument("--eval_official", action="store_true",
                    help="accepted for reference-CLI compatibility")
    args = ap.parse_args()
    evaluate_mot_dir(args.gt_root, args.results_dir, args.gt_type)


if __name__ == "__main__":
    main()
