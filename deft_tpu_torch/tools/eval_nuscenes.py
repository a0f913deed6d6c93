"""Devkit-free nuScenes tracking evaluator (AMOTA / AMOTP / MOTAR), copied
from ``tools/eval_nuscenes.py`` (numpy only; the port keeps its own copy).

The reference shells out to nuScenes-devkit evaluators it does not ship
(reference ``src/lib/dataset/datasets/nuscenes.py:269-294`` builds devkit
eval commands); this module implements the published tracking metrics
directly so synthetic / local runs produce numbers without the devkit:

* matching: ground-plane center distance <= 2 m (the official tracking
  gate), persistent CLEAR correspondences + Hungarian on the rest (same
  accumulation semantics as tools/eval_mot.py, distance cost instead of
  IoU);
* recall sweep: for each of L=40 target recall levels r = i/L the minimal
  score threshold whose achieved recall reaches r is selected; metrics are
  computed on the predictions above that threshold;
* MOTAR(r) = max(0, 1 - (IDS + FP + FN - (1 - r_hat) * P) / (r_hat * P))
  with r_hat the ACHIEVED recall at the selected threshold and P the class
  ground-truth count (the recall-normalized MOTA of Weng & Kitani's
  AB3DMOT, which the nuScenes benchmark adopts);
* AMOTA = mean of MOTAR over the 40 levels (unreachable level -> 0);
  AMOTP = mean over levels of the mean matched distance (unreachable
  level -> the 2 m gate);
* headline numbers are averaged over the 7 tracking classes present in
  the ground truth; per-class rows are printed too.

CLI: python -m deft_tpu_torch.tools.eval_nuscenes --submission results.json \
        --data_root data/nuscenes [--version v1.0-trainval] [--scenes a,b]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

TRACKING_CLASSES = ("car", "truck", "bus", "trailer", "pedestrian",
                    "motorcycle", "bicycle")
MATCH_GATE_M = 2.0
N_RECALL_LEVELS = 40


def tracking_name(category_name: str) -> str:
    """nuScenes category -> tracking class (suffix match handles both the
    official dotted names, e.g. vehicle.car / human.pedestrian.adult, and
    plain names used by synthetic tables)."""
    parts = category_name.split(".")
    for piece in reversed(parts):
        if piece in TRACKING_CLASSES:
            return piece
    for cls in TRACKING_CLASSES:
        if cls in parts:
            return cls
    return ""


# ---------------------------------------------------------------------------
# Core accumulation.  A "frame" is one sample; scenes are evaluated
# independently (no cross-scene track continuity).
#   gt frame:   list of (track_id, xy)          xy = global [x, y]
#   pred frame: list of (track_id, xy, score)
# ---------------------------------------------------------------------------

def _dist_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)


def _accumulate(gt_scenes, pred_scenes, thresh: float) -> Dict[str, float]:
    """CLEAR accumulation of one class at one score threshold."""
    n_gt = n_fp = n_fn = n_idsw = n_frag = n_match = 0
    sum_dist = 0.0
    for gt_frames, pred_frames in zip(gt_scenes, pred_scenes):
        matches: Dict = {}
        missed_since: Dict = {}
        for gts, preds in zip(gt_frames, pred_frames):
            preds = [p for p in preds if p[2] >= thresh]
            gt_ids = [g[0] for g in gts]
            pr_ids = [p[0] for p in preds]
            gt_xy = np.array([g[1] for g in gts], np.float64).reshape(-1, 2)
            pr_xy = np.array([p[1] for p in preds], np.float64).reshape(-1, 2)
            n_gt += len(gts)
            dist = _dist_matrix(gt_xy, pr_xy)

            frame_matches = {}
            used = set()
            # 1) persistent correspondences kept while still inside the gate
            for gi, gid in enumerate(gt_ids):
                hid = matches.get(gid)
                if hid is not None and hid in pr_ids:
                    hi = pr_ids.index(hid)
                    if dist[gi, hi] <= MATCH_GATE_M:
                        frame_matches[gid] = hid
                        used.add(hid)
                        sum_dist += dist[gi, hi]
            # 2) Hungarian on the rest (min total distance)
            free_g = [i for i, g in enumerate(gt_ids)
                      if g not in frame_matches]
            free_h = [i for i, h in enumerate(pr_ids) if h not in used]
            if free_g and free_h:
                cost = dist[np.ix_(free_g, free_h)].copy()
                cost[cost > MATCH_GATE_M] = 1e9
                rows, cols = linear_sum_assignment(cost)
                for r, c in zip(rows, cols):
                    if cost[r, c] < 1e9:
                        gid = gt_ids[free_g[r]]
                        hid = pr_ids[free_h[c]]
                        frame_matches[gid] = hid
                        sum_dist += cost[r, c]
                        if gid in matches and matches[gid] != hid:
                            n_idsw += 1
            n_match += len(frame_matches)
            n_fn += len(gts) - len(frame_matches)
            n_fp += len(preds) - len(frame_matches)
            for gid, hid in frame_matches.items():
                if missed_since.get(gid):
                    n_frag += 1
                missed_since[gid] = False
                matches[gid] = hid
            for gid in gt_ids:
                if gid not in frame_matches:
                    missed_since[gid] = True
    return dict(gt=n_gt, fp=n_fp, fn=n_fn, ids=n_idsw, frag=n_frag,
                match=n_match, sum_dist=sum_dist)


def _recall_curve(gt_scenes, pred_scenes) -> List[float]:
    """Scores of true positives under per-frame greedy (score-desc) matching
    with the 2 m gate -- the threshold-free matching that defines the
    score -> recall curve for threshold selection."""
    tp_scores: List[float] = []
    for gt_frames, pred_frames in zip(gt_scenes, pred_scenes):
        for gts, preds in zip(gt_frames, pred_frames):
            gt_xy = np.array([g[1] for g in gts], np.float64).reshape(-1, 2)
            taken = np.zeros(len(gts), bool)
            for tid, xy, score in sorted(preds, key=lambda p: -p[2]):
                if not len(gts):
                    continue
                d = np.linalg.norm(gt_xy - np.asarray(xy, np.float64), axis=1)
                d[taken] = np.inf
                j = int(np.argmin(d))
                if d[j] <= MATCH_GATE_M:
                    taken[j] = True
                    tp_scores.append(float(score))
    return sorted(tp_scores, reverse=True)


def evaluate_class(gt_scenes, pred_scenes,
                   n_levels: int = N_RECALL_LEVELS) -> Dict[str, float]:
    """AMOTA/AMOTP/MOTAR sweep for ONE class.

    gt_scenes: [scene][frame] -> [(track_id, xy)];
    pred_scenes: [scene][frame] -> [(track_id, xy, score)].
    """
    p_total = sum(len(fr) for sc in gt_scenes for fr in sc)
    out = dict(gt=p_total, amota=0.0, amotp=MATCH_GATE_M, motar=0.0,
               mota=0.0, motp=MATCH_GATE_M, recall=0.0, ids=0, frag=0,
               fp=0, fn=0)
    if p_total == 0:
        return out
    tp_scores = _recall_curve(gt_scenes, pred_scenes)
    max_recall = len(tp_scores) / p_total
    out["recall"] = max_recall

    motars, motps, motas = [], [], []
    best = None
    for i in range(1, n_levels + 1):
        r = i / n_levels
        k = int(np.ceil(r * p_total))
        if k > len(tp_scores):
            motars.append(0.0)
            motps.append(MATCH_GATE_M)
            continue
        thresh = tp_scores[k - 1]
        acc = _accumulate(gt_scenes, pred_scenes, thresh)
        r_hat = max((acc["gt"] - acc["fn"]) / p_total, 1e-9)
        motar = max(0.0, 1.0 - (acc["ids"] + acc["fp"] + acc["fn"]
                                - (1.0 - r_hat) * p_total)
                    / (r_hat * p_total))
        mota = 1.0 - (acc["ids"] + acc["fp"] + acc["fn"]) / p_total
        motp = (acc["sum_dist"] / acc["match"] if acc["match"]
                else MATCH_GATE_M)
        motars.append(motar)
        motps.append(motp)
        motas.append(mota)
        if best is None or mota > best[0]:
            best = (mota, motp, acc)
    out["amota"] = float(np.mean(motars))
    out["amotp"] = float(np.mean(motps))
    out["motar"] = float(np.mean([m for m in motars if m > 0]) if any(
        m > 0 for m in motars) else 0.0)
    if best is not None:
        out["mota"] = best[0]
        out["motp"] = best[1]
        out.update({k2: best[2][k2] for k2 in ("ids", "frag", "fp", "fn")})
    return out


# ---------------------------------------------------------------------------
# Schema plumbing: raw nuScenes v1.0 tables -> per-class scene/frame lists.
# ---------------------------------------------------------------------------

def _load_table(root, version, name):
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def load_gt(data_root: str, version: str = "v1.0-trainval",
            scenes: Sequence[str] = ()):  # -> (gt, sample_order)
    """Ground truth per class: {cls: [scene][frame] -> [(instance, xy)]},
    plus the ordered sample tokens per scene (first_sample -> next chain)."""
    tables = {n: _load_table(data_root, version, n) for n in (
        "sample", "sample_annotation", "instance", "category", "scene")}
    cat_of = {c["token"]: c["name"] for c in tables["category"]}
    inst_cat = {i["token"]: cat_of[i["category_token"]]
                for i in tables["instance"]}
    sample_by_token = {s["token"]: s for s in tables["sample"]}
    anns_of = defaultdict(list)
    for a in tables["sample_annotation"]:
        anns_of[a["sample_token"]].append(a)

    gt = {cls: [] for cls in TRACKING_CLASSES}
    sample_order: List[List[str]] = []
    for scene in tables["scene"]:
        if scenes and scene["name"] not in scenes:
            continue
        tokens = []
        tok = scene["first_sample_token"]
        while tok:
            tokens.append(tok)
            tok = sample_by_token[tok]["next"]
        sample_order.append(tokens)
        per_cls = {cls: [] for cls in TRACKING_CLASSES}
        for tok in tokens:
            frames = {cls: [] for cls in TRACKING_CLASSES}
            for a in anns_of.get(tok, []):
                cls = tracking_name(inst_cat[a["instance_token"]])
                if cls:
                    frames[cls].append(
                        (a["instance_token"], a["translation"][:2]))
            for cls in TRACKING_CLASSES:
                per_cls[cls].append(frames[cls])
        for cls in TRACKING_CLASSES:
            gt[cls].append(per_cls[cls])
    return gt, sample_order


def load_submission(path: str, sample_order: List[List[str]]):
    """Submission json -> {cls: [scene][frame] -> [(tid, xy, score)]}."""
    with open(path) as f:
        sub = json.load(f)["results"]
    pred = {cls: [] for cls in TRACKING_CLASSES}
    for tokens in sample_order:
        per_cls = {cls: [] for cls in TRACKING_CLASSES}
        for tok in tokens:
            frames = {cls: [] for cls in TRACKING_CLASSES}
            for d in sub.get(tok, []):
                cls = d.get("tracking_name", d.get("detection_name", ""))
                if cls in frames:
                    frames[cls].append(
                        (d.get("tracking_id", 0), d["translation"][:2],
                         float(d.get("tracking_score",
                                     d.get("detection_score", 0.0)))))
            for cls in TRACKING_CLASSES:
                per_cls[cls].append(frames[cls])
        for cls in TRACKING_CLASSES:
            pred[cls].append(per_cls[cls])
    return pred


def evaluate_submission(submission_path: str, data_root: str,
                        version: str = "v1.0-trainval",
                        scenes: Sequence[str] = ()) -> Dict[str, Dict]:
    gt, order = load_gt(data_root, version, scenes)
    pred = load_submission(submission_path, order)
    per_class = {}
    for cls in TRACKING_CLASSES:
        res = evaluate_class(gt[cls], pred[cls])
        if res["gt"] > 0:
            per_class[cls] = res
    keys = ("amota", "amotp", "motar", "mota", "recall")
    overall = {k: (float(np.mean([c[k] for c in per_class.values()]))
                   if per_class else 0.0) for k in keys}
    overall.update({k: int(sum(c[k] for c in per_class.values()))
                    for k in ("ids", "frag", "fp", "fn", "gt")})
    return {"overall": overall, "classes": per_class}


def format_table(res: Dict[str, Dict]) -> str:
    hdr = (f"{'class':<12}{'AMOTA':>7}{'AMOTP':>7}{'MOTAR':>7}{'MOTA':>7}"
           f"{'recall':>8}{'IDS':>5}{'FRAG':>6}{'GT':>6}")
    lines = [hdr]
    for cls, c in sorted(res["classes"].items()):
        lines.append(f"{cls:<12}{c['amota']:>7.3f}{c['amotp']:>7.3f}"
                     f"{c['motar']:>7.3f}{c['mota']:>7.3f}"
                     f"{c['recall']:>8.3f}{c['ids']:>5d}{c['frag']:>6d}"
                     f"{c['gt']:>6d}")
    o = res["overall"]
    lines.append(f"{'OVERALL':<12}{o['amota']:>7.3f}{o['amotp']:>7.3f}"
                 f"{o['motar']:>7.3f}{o['mota']:>7.3f}{o['recall']:>8.3f}"
                 f"{o['ids']:>5d}{o['frag']:>6d}{o['gt']:>6d}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--submission", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--scenes", default="",
                    help="comma-separated scene names (default: all)")
    args = ap.parse_args()
    scenes = tuple(s for s in args.scenes.split(",") if s)
    res = evaluate_submission(args.submission, args.data_root,
                              args.version, scenes)
    print(format_table(res))


if __name__ == "__main__":
    main()
