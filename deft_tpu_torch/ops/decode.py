"""CenterNet-style heatmap decoding, the counterpart of
``deft_tpu/ops/decode.py``: every head ``generic_decode`` handles there (hm,
reg, wh and its category-specific form, ltrb, ltrb_amodal, tracking, the
3-D heads dep, rot, dim, amodel_offset, nuscenes_att, velocity, the
keypoints hps with hm_hp and hp_offset) and the previous frame's
``pre_inds``.

Layout is the JAX functions': head maps ``{name: [B, H, W, C]}``.  Every
output is fixed-shape: K detections always come back, ranked by score, and
callers cut at their score threshold.

Ties: ``jax.lax.top_k`` puts the lower index first among equal scores, and
after NMS most scores are tied (zeros).  ``topk`` therefore ranks with a
stable descending sort, which keeps index order among ties on the CPU and on
CUDA alike (``torch.topk`` on CUDA promises no order).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


# heads decoded as their values at the peaks (deft_tpu/ops/decode.py:148-151)
GATHERED = ("tracking", "dep", "rot", "dim", "amodel_offset", "nuscenes_att",
            "velocity")
DECODED = ("hm", "reg", "wh", "ltrb", "ltrb_amodal", "hps", "hm_hp",
           "hp_offset", "pre_inds", *GATHERED)
KPS_THRESH = 0.2           # a keypoint peak's least score (decode.py:17-99)


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``_sigmoid``: sigmoid clamped to [1e-4, 1-1e-4]
    (``deft_tpu/models/deft.py:31-33``)."""
    return torch.sigmoid(x).clamp(1e-4, 1.0 - 1e-4)


def heat_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima: 3x3 max-pool equality mask."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1,
                        padding=pad).permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, lower index first
    among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk(scores: torch.Tensor, k: int = 100):
    """Top-k peaks over an NHWC heatmap.  Returns (score, inds, clses, ys,
    xs), each [B, K]; ``inds`` indexes the flattened H*W plane."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cat_scores, cat_inds = _top_k(flat, k)                     # [B, C, K]
    cat_ys = torch.div(cat_inds, w, rounding_mode="floor").float()
    cat_xs = (cat_inds % w).float()
    top_score, top_ind = _top_k(cat_scores.reshape(b, c * k), k)
    clses = torch.div(top_ind, k, rounding_mode="floor").int()

    def gather(t):
        return torch.gather(t.reshape(b, c * k), 1, top_ind)

    return top_score, gather(cat_inds), clses, gather(cat_ys), gather(cat_xs)


def topk_channel(scores: torch.Tensor, k: int = 100):
    """Per-channel top-k (``deft_tpu/ops/decode.py:58-67``): NHWC scores
    -> (score, inds, ys, xs), each [B, C, K]."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    top_scores, top_inds = _top_k(flat, k)
    ys = torch.div(top_inds, w, rounding_mode="floor").float()
    xs = (top_inds % w).float()
    return top_scores, top_inds, ys, xs


def gather_feat(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C], inds [B, K] in y*W+x -> [B, K, C]."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, inds[..., None].expand(-1, -1, c))


def _boxes(x0, y0, d):
    """[x0 + d0, y0 + d1, x0 + d2, y0 + d3] of [B, K, 1] centres and
    [B, K, 4] distances."""
    return torch.cat([x0 + d[..., 0:1], y0 + d[..., 1:2],
                      x0 + d[..., 2:3], y0 + d[..., 3:4]], dim=2)


def generic_decode(output: Dict[str, torch.Tensor],
                   k: int = 100) -> Dict[str, torch.Tensor]:
    """Decode head maps into top-K detections (``generic_decode``,
    ``deft_tpu/ops/decode.py:80-190``).

    ``output['hm']`` must already be sigmoided.  Returns a dict of [B, K, ...]
    tensors: scores, clses, cts, xs, ys, inds, bboxes and the regression
    heads present.  A ``wh`` of 2 x the classes is category-specific (the
    detected class's pair); ``ltrb`` and then ``ltrb_amodal`` override the
    wh-derived boxes; ``hps`` (centre-relative keypoints) snaps to the
    ``hm_hp`` peaks (``update_kps_with_hm``) and adds ``kps_score``;
    ``output['pre_inds']`` [B, K] flat indices give ``pre_cts``.  Any other
    key raises.
    """
    other = set(output) - set(DECODED)
    if other:
        raise ValueError(f"generic_decode: no decode for heads "
                         f"{sorted(other)}")
    heat = heat_nms(output["hm"])
    b = heat.shape[0]
    scores, inds, clses, ys0, xs0 = topk(heat, k=k)
    cts = torch.stack([xs0, ys0], dim=2)
    ret = {
        "scores": scores,
        "clses": clses.float(),
        "xs": xs0,
        "ys": ys0,
        "cts": cts,
        "inds": inds,
    }
    x0k = xs0[..., None]
    y0k = ys0[..., None]
    if "reg" in output:
        reg = gather_feat(output["reg"], inds)
        xs = x0k + reg[:, :, 0:1]
        ys = y0k + reg[:, :, 1:2]
    else:
        xs = x0k + 0.5
        ys = y0k + 0.5

    if "wh" in output:
        wh = gather_feat(output["wh"], inds).clamp(min=0.0)
        n_cat = output["hm"].shape[-1]
        if wh.shape[2] == 2 * n_cat and n_cat > 1:
            # category-specific wh: the detected class's pair
            wh = wh.reshape(b, -1, n_cat, 2)
            wh = torch.gather(
                wh, 2, clses.long()[:, :, None, None].expand(-1, -1, 1, 2)
            )[:, :, 0, :]
        ret["bboxes"] = torch.cat([xs - wh[..., 0:1] / 2,
                                   ys - wh[..., 1:2] / 2,
                                   xs + wh[..., 0:1] / 2,
                                   ys + wh[..., 1:2] / 2], dim=2)

    if "ltrb" in output:
        ret["bboxes"] = _boxes(x0k, y0k, gather_feat(output["ltrb"], inds))

    for head in GATHERED:
        if head in output:
            ret[head] = gather_feat(output[head], inds)

    if "ltrb_amodal" in output:
        amodal = _boxes(x0k, y0k, gather_feat(output["ltrb_amodal"], inds))
        ret["bboxes_amodal"] = amodal
        ret["bboxes"] = amodal

    if "hps" in output:
        joints = output["hps"].shape[-1] // 2
        kps = gather_feat(output["hps"], inds)                 # [B, K, J*2]
        # centre-relative offsets, x at the even slots
        kps = (kps.reshape(b, -1, joints, 2) + cts[:, :, None, :]).reshape(
            b, -1, joints * 2)
        ret["hps"] = kps
        if "hm_hp" in output:
            ret["hps"], ret["kps_score"] = update_kps_with_hm(
                kps, output, joints, k, bboxes=ret.get("bboxes"),
                scores=scores)

    if output.get("pre_inds") is not None:
        pre_inds = output["pre_inds"]
        w = output["hm"].shape[2]
        ret["pre_cts"] = torch.stack(
            [(pre_inds % w).float(),
             torch.div(pre_inds, w, rounding_mode="floor").float()], dim=2)
    return ret


def update_kps_with_hm(kps, output, joints: int, k: int, bboxes=None,
                       scores=None):
    """Snap regressed keypoints to nearby keypoint-heatmap peaks
    (``deft_tpu/ops/decode.py:193-261``): per joint the top-K peaks of the
    NMS'd ``hm_hp`` (shifted by ``hp_offset``, else ``reg``, else 0.5); each
    keypoint takes its nearest peak unless that scores below
    ``KPS_THRESH`` or lies outside its detection box (without boxes: the
    keypoints' own extent, grown by a quarter, with the reference's
    sequential update).  kps [B, K, J*2] -> ([B, K, J*2], kps_score
    [B, K]: the detection score times the mean of the peaks' scores, a
    rejected keypoint counting the detection's)."""
    b = kps.shape[0]
    hm_hp = heat_nms(output["hm_hp"])                          # [B, H, W, J]
    kps_j = kps.reshape(b, k, joints, 2).permute(0, 2, 1, 3)   # [B, J, K, 2]
    hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k=k)  # [B, J, K]
    off_map = output.get("hp_offset", output.get("reg"))
    if off_map is not None:
        off = gather_feat(off_map, hm_inds.reshape(b, -1)).reshape(
            b, joints, k, 2)
        hm_xs = hm_xs + off[..., 0]
        hm_ys = hm_ys + off[..., 1]
    else:
        hm_xs = hm_xs + 0.5
        hm_ys = hm_ys + 0.5
    conf = hm_score > KPS_THRESH
    hm_score = torch.where(conf, hm_score, torch.full_like(hm_score, -1.0))
    hm_xs = torch.where(conf, hm_xs, torch.full_like(hm_xs, -10000.0))
    hm_ys = torch.where(conf, hm_ys, torch.full_like(hm_ys, -10000.0))
    hm_kps = torch.stack([hm_xs, hm_ys], dim=-1)               # [B, J, K, 2]

    # nearest peak of each regressed keypoint: [B, J, K(reg), K(peak)]
    dist = torch.linalg.norm(kps_j[:, :, :, None, :]
                             - hm_kps[:, :, None, :, :], dim=-1)
    min_ind = torch.argmin(dist, dim=3)                        # [B, J, K]
    sel_score = torch.gather(hm_score, 2, min_ind)[..., None]
    sel_kps = torch.gather(hm_kps, 2, min_ind[..., None].expand(-1, -1, -1, 2))

    reject = sel_score < KPS_THRESH                            # [B, J, K, 1]
    if bboxes is not None:
        box = bboxes[:, None, :, :]                            # [B, 1, K, 4]
        l, t, r, bt = (box[..., 0:1], box[..., 1:2], box[..., 2:3],
                       box[..., 3:4])
    else:
        l = kps_j[..., 0:1].amin(dim=1, keepdim=True)
        t = kps_j[..., 1:2].amin(dim=1, keepdim=True)
        r = kps_j[..., 0:1].amax(dim=1, keepdim=True)
        bt = kps_j[..., 1:2].amax(dim=1, keepdim=True)
        margin = 0.25
        # sequential on purpose: r and b grow from the moved l and t
        l = l - (r - l) * margin
        r = r + (r - l) * margin
        t = t - (bt - t) * margin
        bt = bt + (bt - t) * margin
    reject = (reject | (sel_kps[..., 0:1] < l) | (sel_kps[..., 0:1] > r)
              | (sel_kps[..., 1:2] < t) | (sel_kps[..., 1:2] > bt))
    det_score = scores[:, None, :, None]                       # [B, 1, K, 1]
    kps_score = torch.where(reject, det_score.expand_as(sel_score), sel_score)
    kps_score = scores * kps_score[..., 0].mean(dim=1)         # [B, K]
    fused = torch.where(reject, kps_j, sel_kps)                # [B, J, K, 2]
    return fused.permute(0, 2, 1, 3).reshape(b, k, joints * 2), kps_score
