"""Detection post-processing, copied from
``deft_tpu/inference/post_process.py``.

Output-grid detections -> original-image coordinates: one inverse-affine
matmul over all K detections, python dicts only for the thresholded
survivors.  With the 3-D heads and a calibration, alpha comes from the 8-bin
rot head and ``loc`` / ``rot_y`` from unprojecting the amodal centre at the
decoded depth.  Keypoints (``hps``) are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from deft_tpu_torch.inference.ddd import ddd2locrot, get_alpha
from deft_tpu_torch.ops.affine import get_affine_transform, transform_preds_with_trans


def generic_post_process(dets: Dict[str, np.ndarray], centers, scales,
                         out_h: int, out_w: int, out_thresh: float,
                         calibs: Optional[List[np.ndarray]] = None
                         ) -> List[List[dict]]:
    """dets: batched decode outputs ([B, K, ...], numpy); centers/scales: the
    pre-process crop spec per image; calibs: each image's [3, 4] projection
    (the 3-D location needs it).  Returns per-image lists of detection dicts
    in original-image pixels, score-ordered, cut at ``out_thresh``.
    """
    if "scores" not in dets:
        return [[]]
    if "hps" in dets:
        raise NotImplementedError(
            "keypoint post-processing is not ported yet (ROADMAP.md, queue A)")
    ret = []
    has_ddd = "rot" in dets and "dep" in dets and "dim" in dets
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
        alphas = get_alpha(np.asarray(dets["rot"][i][:n])) if "rot" in dets \
            else None
        amodel_ct = None
        if has_ddd and "amodel_offset" in dets and calibs is not None:
            ct_out = np.asarray(dets["bboxes"][i][:n]).reshape(-1, 2, 2).mean(
                axis=1)
            amodel_ct = transform_preds_with_trans(
                (ct_out + np.asarray(dets["amodel_offset"][i][:n])).astype(
                    np.float32),
                trans,
            )

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
            if "dep" in dets:
                item["dep"] = dets["dep"][i][j]
            if "dim" in dets:
                item["dim"] = dets["dim"][i][j]
            if alphas is not None:
                item["alpha"] = float(alphas[j])
            if has_ddd and calibs is not None:
                ct = (amodel_ct[j].tolist() if amodel_ct is not None
                      else [(item["bbox"][0] + item["bbox"][2]) / 2,
                            (item["bbox"][1] + item["bbox"][3]) / 2])
                item["ct"] = ct
                dep = float(np.ravel(item["dep"])[0])
                item["loc"], item["rot_y"] = ddd2locrot(
                    ct, item["alpha"], item["dim"], dep, calibs[i])
            for extra in ("nuscenes_att", "velocity"):
                if extra in dets:
                    item[extra] = dets[extra][i][j]
            preds.append(item)
        ret.append(preds)
    return ret
