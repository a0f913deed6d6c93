"""Detection post-processing, copied from
``deft_tpu/inference/post_process.py`` (2-D path).

Output-grid detections -> original-image coordinates: one inverse-affine
matmul over all K detections, python dicts only for the thresholded
survivors.  The 3-D heads (rot/dep/dim, amodel_offset) wait for the nuScenes
slice.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deft_tpu_torch.ops.affine import get_affine_transform, transform_preds_with_trans


def generic_post_process(dets: Dict[str, np.ndarray], centers, scales,
                         out_h: int, out_w: int, out_thresh: float
                         ) -> List[List[dict]]:
    """dets: batched decode outputs ([B, K, ...], numpy); centers/scales: the
    pre-process crop spec per image.  Returns per-image lists of detection
    dicts in original-image pixels, score-ordered, cut at ``out_thresh``.
    """
    if "scores" not in dets:
        return [[]]
    if "rot" in dets or "dep" in dets or "hps" in dets:
        raise NotImplementedError(
            "3-D and keypoint post-processing are not ported yet "
            "(ROADMAP.md, queue A)")
    ret = []
    for i in range(len(dets["scores"])):
        trans = get_affine_transform(
            centers[i], scales[i], 0, (out_w, out_h), inv=True
        ).astype(np.float32)
        scores = np.asarray(dets["scores"][i])
        # scores are sorted; detections stop at the first below-threshold one
        n = int(np.searchsorted(-scores, -out_thresh, side="right"))
        if n == 0:
            ret.append([])
            continue

        cts = transform_preds_with_trans(
            np.asarray(dets["cts"][i][:n], np.float32).reshape(-1, 2), trans
        )
        clses = np.asarray(dets["clses"][i][:n]).astype(int) + 1

        tracking = None
        if "tracking" in dets:
            tr = transform_preds_with_trans(
                (np.asarray(dets["tracking"][i][:n])
                 + np.asarray(dets["cts"][i][:n])).reshape(-1, 2).astype(
                     np.float32),
                trans,
            )
            tracking = tr - cts
        bboxes = None
        if "bboxes" in dets:
            bboxes = transform_preds_with_trans(
                np.asarray(dets["bboxes"][i][:n], np.float32).reshape(-1, 2),
                trans,
            ).reshape(-1, 4)

        preds = []
        for j in range(n):
            item = {
                "score": float(scores[j]),
                "class": int(clses[j]),
                "ct": cts[j],
            }
            if tracking is not None:
                item["tracking"] = tracking[j]
            if bboxes is not None:
                item["bbox"] = bboxes[j]
            preds.append(item)
        ret.append(preds)
    return ret
