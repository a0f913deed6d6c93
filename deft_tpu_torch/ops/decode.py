"""CenterNet-style heatmap decoding, the counterpart of
``deft_tpu/ops/decode.py`` for the heads of the MOT model (hm, reg, wh,
tracking, ltrb_amodal).

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


def gather_feat(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C], inds [B, K] in y*W+x -> [B, K, C]."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, inds[..., None].expand(-1, -1, c))


def generic_decode(output: Dict[str, torch.Tensor],
                   k: int = 100) -> Dict[str, torch.Tensor]:
    """Decode head maps into top-K detections (``generic_decode``).

    ``output['hm']`` must already be sigmoided.  Returns a dict of [B, K, ...]
    tensors: scores, clses, cts, xs, ys, inds, bboxes and the regression
    heads present.  ``ltrb_amodal`` overrides the wh-derived boxes.
    """
    other = set(output) - {"hm", "reg", "wh", "tracking", "ltrb_amodal"}
    if other:
        raise NotImplementedError(
            f"decoding heads {sorted(other)} is not ported yet (ROADMAP.md, "
            "queue A)")
    if "wh" in output and output["wh"].shape[-1] != 2:
        raise NotImplementedError("category-specific wh is not ported yet")
    heat = heat_nms(output["hm"])
    scores, inds, clses, ys0, xs0 = topk(heat, k=k)
    ret = {
        "scores": scores,
        "clses": clses.float(),
        "xs": xs0,
        "ys": ys0,
        "cts": torch.stack([xs0, ys0], dim=2),
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
        ret["bboxes"] = torch.cat([xs - wh[..., 0:1] / 2,
                                   ys - wh[..., 1:2] / 2,
                                   xs + wh[..., 0:1] / 2,
                                   ys + wh[..., 1:2] / 2], dim=2)

    if "tracking" in output:
        ret["tracking"] = gather_feat(output["tracking"], inds)

    if "ltrb_amodal" in output:
        ltrb = gather_feat(output["ltrb_amodal"], inds)
        amodal = torch.cat([x0k + ltrb[..., 0:1], y0k + ltrb[..., 1:2],
                            x0k + ltrb[..., 2:3], y0k + ltrb[..., 3:4]], dim=2)
        ret["bboxes_amodal"] = amodal
        ret["bboxes"] = amodal
    return ret
