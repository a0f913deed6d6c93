"""COCO detection evaluator, copied from the JAX repo's
``tools/eval_coco.py``: AP@[.5:.95] and the standard 12-number summary.

    python -m deft_tpu_torch.tools.eval_coco GT_JSON RESULTS_JSON

It reimplements the pycocotools ``COCOeval`` bbox protocol the reference
invokes from ``coco.py::run_eval`` (pycocotools is not a dependency; numpy
only), which ``data/datasets/coco_det.py::CocoDataset.run_eval`` calls.
Matches COCOeval semantics:

- 10 IoU thresholds .5:.05:.95, 101 recall points 0:.01:1
- area ranges all / small(<32^2) / medium / large(>96^2), maxDets 1/10/100
- crowd GTs use intersection-over-det-area IoU and may match many detections
- ignored GTs (iscrowd or area out of range) absorb detections without
  counting them as FP; unmatched out-of-range detections are ignored too
- greedy per-detection matching in score order, non-ignored GTs preferred
- precision envelope (monotone non-increasing) sampled at the recall grid
- AP averages only over categories present in the ground truth

Summary keys mirror the COCOeval stats vector: AP, AP50, AP75, APs, APm, APl,
AR1, AR10, AR100, ARs, ARm, ARl.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU for xywh boxes; crowd GT -> intersection / det area
    (pycocotools ``maskUtils.iou`` semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def _evaluate_img(dts: List[dict], gts: List[dict], area_rng: Tuple[float, float],
                  max_det: int):
    """Per (image, category) greedy matching for every IoU threshold.

    Returns (dt_scores, dt_matched[T, D], dt_ignore[T, D], n_gt) or None
    when both lists are empty -- the accumulate step concatenates these
    across images (COCOeval.evaluateImg equivalent)."""
    if not dts and not gts:
        return None
    gt_ignore = np.array([
        1 if (g.get("iscrowd", 0) or g.get("ignore", 0)
              or not (area_rng[0] <= _area(g) < area_rng[1])) else 0
        for g in gts], np.int32)
    # ignored GTs last, preserving order within each group (COCOeval sorts
    # by the ignore flag with a stable sort)
    g_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    gt_ignore = gt_ignore[g_order]
    iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gts], np.int32)

    dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
    dt_scores = np.array([d["score"] for d in dts], np.float64)
    dt_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
    gt_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
    ious = bbox_iou_xywh(dt_boxes, gt_boxes, iscrowd)

    T, D, G = len(IOU_THRS), len(dts), len(gts)
    dtm = -np.ones((T, D), np.int64)     # matched gt index or -1
    gtm = -np.ones((T, G), np.int64)
    dt_ig = np.zeros((T, D), np.int32)
    for ti, t in enumerate(IOU_THRS):
        for di in range(D):
            best = min(t, 1.0 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[ti, gi] >= 0 and not iscrowd[gi]:
                    continue
                # ignored GTs come last: once matched to a real GT, stop
                # before the ignored block
                if m > -1 and gt_ignore[_as_int(m)] == 0 and gt_ignore[gi] == 1:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            gtm[ti, m] = di
            dt_ig[ti, di] = gt_ignore[m]
    # unmatched detections outside the area range are ignored, not FP
    d_out = np.array([0 if area_rng[0] <= _det_area(d) < area_rng[1] else 1
                      for d in dts], np.int32)
    dt_ig = np.logical_or(dt_ig, (dtm == -1) & d_out[None]).astype(np.int32)
    return dt_scores, (dtm >= 0).astype(np.int32), dt_ig, int((gt_ignore == 0).sum())


def _area(g):
    if "area" in g:
        return float(g["area"])
    b = g["bbox"]
    return float(b[2] * b[3])


def _det_area(d):
    b = d["bbox"]
    return float(b[2] * b[3])


def _as_int(x):
    return int(x)


def evaluate(gt_index, detections: Sequence[dict],
             img_ids: Sequence[int] = None) -> Dict[str, float]:
    """COCO 12-metric summary.

    gt_index: CocoIndex (or any object with .get_img_ids(),
    .load_anns_for_img(), .cats).  detections: COCO results-format list
    ({image_id, category_id, bbox xywh, score}).
    """
    img_ids = list(img_ids if img_ids is not None else gt_index.get_img_ids())
    cat_ids = sorted(gt_index.cats.keys())
    dts_by_ic = defaultdict(list)
    for d in detections:
        dts_by_ic[(d["image_id"], d["category_id"])].append(d)
    gts_by_ic = defaultdict(list)
    for img_id in img_ids:
        for a in gt_index.load_anns_for_img(img_id):
            gts_by_ic[(img_id, a["category_id"])].append(a)

    K, T, R, A, M = len(cat_ids), len(IOU_THRS), len(REC_THRS), len(AREA_RNG), len(MAX_DETS)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))

    for ki, cat in enumerate(cat_ids):
        for ai, (aname, arng) in enumerate(AREA_RNG.items()):
            for mi, max_det in enumerate(MAX_DETS):
                per_img = [
                    _evaluate_img(dts_by_ic.get((i, cat), []),
                                  gts_by_ic.get((i, cat), []), arng, max_det)
                    for i in img_ids
                ]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                scores = np.concatenate([e[0] for e in per_img])
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate([e[1] for e in per_img], 1)[:, order]
                dt_ig = np.concatenate([e[2] for e in per_img], 1)[:, order]
                n_gt = sum(e[3] for e in per_img)
                if n_gt == 0:
                    continue
                tps = np.logical_and(dtm, np.logical_not(dt_ig))
                fps = np.logical_and(np.logical_not(dtm),
                                     np.logical_not(dt_ig))
                tp_sum = np.cumsum(tps, 1).astype(np.float64)
                fp_sum = np.cumsum(fps, 1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope (monotone from the right), sampled
                    # at the recall grid exactly like COCOeval.accumulate
                    q = np.zeros(R)
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai, mi] = q

    def _ap(t_slice=slice(None), area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        s = precision[t_slice, :, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _ar(area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        s = recall[:, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    t50 = slice(0, 1)
    t75 = slice(5, 6)
    stats = {
        "AP": _ap(), "AP50": _ap(t50), "AP75": _ap(t75),
        "APs": _ap(area="small"), "APm": _ap(area="medium"),
        "APl": _ap(area="large"),
        "AR1": _ar(max_det=1), "AR10": _ar(max_det=10), "AR100": _ar(),
        "ARs": _ar(area="small"), "ARm": _ar(area="medium"),
        "ARl": _ar(area="large"),
    }
    return stats


def print_summary(stats: Dict[str, float]):
    rows = [
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AP"),
        ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", "AP50"),
        ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", "AP75"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "APs"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "APm"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "APl"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", "AR1"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", "AR10"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", "AR100"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", "ARs"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", "ARm"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", "ARl"),
    ]
    for label, key in rows:
        print(f" {label} = {stats[key]:0.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("gt_json", help="COCO instances json")
    ap.add_argument("results_json", help="COCO results-format detections json")
    args = ap.parse_args()
    from deft_tpu_torch.data.coco_index import CocoIndex

    with open(args.results_json) as f:
        dets = json.load(f)
    stats = evaluate(CocoIndex(args.gt_json), dets)
    print_summary(stats)


if __name__ == "__main__":
    main()
