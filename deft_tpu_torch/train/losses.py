"""Training losses, the counterpart of ``deft_tpu/train/losses.py``.

The reference's ``losses.py`` (penalty-reduced focal loss, masked L1,
weighted BCE, 2-bin rotation loss), the AFE matching loss (``AFE.py:235-328``)
with its quirks, and the joint loss: ``generic_loss`` is 0.05 x the weighted
sum of the head losses, ``joint_loss`` the intended uncertainty weighting
``exp(-s_det) L_det + exp(-s_id) L_id + s_det + s_id`` (the reference's
``ModleWithLoss`` is broken at HEAD; the JAX package implements the intended
semantics, and so does the port).

Targets are fixed-shape [B, M, ...] tensors with validity masks, as the data
pipeline pads them; head outputs are NHWC, as ``DEFTNet.forward`` returns
them.

Under a process group (``deft_tpu_torch.distributed``) each rank holds its
rows of the global batch, and every loss here is that rank's part of the
global loss: its rows' sums over the *global* normalizers.  Each count that
divides a loss or picks a branch (``num_pos``, the mask sums, ``cnt``,
``n_pre`` ... ``n_total``, the accuracy's valid rows) is summed over the
ranks before use (``global_sum``, no gradient: they are sums of targets),
a mean over rows is divided by the world size too, and ``joint_loss``'s
``s_det + s_id`` is counted on rank 0 alone.  So the ranks' values sum to
the one-process value of the global batch, and so do their gradients.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from deft_tpu_torch.distributed import global_sum, rank, world_size
from deft_tpu_torch.ops.decode import clamped_sigmoid, gather_feat


def fast_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                    ind: torch.Tensor, mask: torch.Tensor,
                    cat: torch.Tensor) -> torch.Tensor:
    """CornerNet penalty-reduced focal loss (``losses.py:75-100``).

    pred, target: [B, H, W, C] (pred sigmoided and clamped); ind, mask:
    [B, M]; cat: [B, M] class ids of the peaks."""
    neg_weights = torch.pow(1.0 - target, 4.0)
    neg_loss = torch.sum(torch.log(1.0 - pred) * torch.pow(pred, 2.0)
                         * neg_weights)
    pos_pred_pix = gather_feat(pred, ind)                     # [B, M, C]
    pos_pred = torch.gather(pos_pred_pix, 2, cat[..., None].long())[..., 0]
    num_pos = global_sum(torch.sum(mask))
    pos_loss = torch.sum(torch.log(pos_pred) * torch.pow(1.0 - pos_pred, 2.0)
                         * mask)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Masked L1 at the peak indices (``losses.py:121-130``).  output:
    [B, H, W, F]; mask, target: [B, M, F]; ind: [B, M]."""
    pred = gather_feat(output, ind)
    loss = torch.sum(torch.abs(pred * mask - target * mask))
    return loss / (global_sum(torch.sum(mask)) + 1e-4)


def weighted_bce_loss(output: torch.Tensor, mask: torch.Tensor,
                      ind: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Per-attribute BCE with logits at the peaks (``losses.py:133-146``)."""
    pred = gather_feat(output, ind)                           # [B, M, F]
    bce = (torch.clamp(pred, min=0) - pred * target
           + torch.log1p(torch.exp(-torch.abs(pred))))
    return torch.sum(mask * bce) / (global_sum(torch.sum(mask)) + 1e-4)


def _smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _masked_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """``cross_entropy(logits * mask, labels)`` averaged over every row:
    masked-out rows contribute log(num_classes) (``losses.py:163-166``).
    The rows of the global batch: every rank holds as many."""
    logp = F.log_softmax(logits * mask, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean(nll) / world_size()


def bin_rot_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                 rotbin: torch.Tensor, rotres: torch.Tensor) -> torch.Tensor:
    """2-bin orientation loss (``losses.py:149-204``).  output: [B, H, W,
    8]; rotbin: [B, M, 2] int; rotres: [B, M, 2]; mask: [B, M]."""
    pred = gather_feat(output, ind).reshape(-1, 8)
    rotbin = rotbin.reshape(-1, 2)
    rotres = rotres.reshape(-1, 2)
    m = mask.reshape(-1, 1).to(pred.dtype)
    loss_bin1 = _masked_softmax_ce(pred[:, 0:2], rotbin[:, 0], m)
    loss_bin2 = _masked_softmax_ce(pred[:, 4:6], rotbin[:, 1], m)

    def res_branch(sin_col, cos_col, bin_col):
        valid = (rotbin[:, bin_col] != 0).to(pred.dtype)
        cnt = global_sum(torch.sum(valid))
        s = torch.sum(_smooth_l1(pred[:, sin_col],
                                 torch.sin(rotres[:, bin_col])) * valid)
        c = torch.sum(_smooth_l1(pred[:, cos_col],
                                 torch.cos(rotres[:, bin_col])) * valid)
        return torch.where(cnt > 0, (s + c) / cnt.clamp(min=1.0),
                           torch.zeros((), device=pred.device))

    return loss_bin1 + loss_bin2 + res_branch(2, 3, 0) + res_branch(6, 7, 1)


def afe_loss(affinity: torch.Tensor, target: torch.Tensor,
             mask_pre: torch.Tensor,
             mask_next: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Forward and backward masked softmax CE plus consistency
    (``AFE.py:235-328``), with the reference's quirks: the softmaxes run over
    *masked* (zeroed, not -inf) logits, the false row and column included.

    affinity: [B, N+1, N+1] raw, with the false row and column; target:
    [B, N+1, N+1] binary; mask_pre, mask_next: [B, N+1]."""
    n1 = affinity.shape[-1]
    dt = affinity.dtype
    mask_region = mask_pre[:, :, None].to(dt) * mask_next[:, None, :].to(dt)
    mask_region_pre = mask_region.clone()
    mask_region_pre[:, n1 - 1, :] = 0.0
    mask_region_next = mask_region.clone()
    mask_region_next[:, :, n1 - 1] = 0.0
    mask_region_union = mask_region_pre * mask_region_next

    input_pre = torch.softmax(mask_region_pre * affinity, dim=2)
    input_next = torch.softmax(mask_region_next * affinity, dim=1)
    # input_all: the average of both on the real block, the forward softmax
    # elsewhere
    real = torch.zeros_like(input_pre, dtype=torch.bool)
    real[:, : n1 - 1, : n1 - 1] = True
    input_all = torch.where(real, (input_pre + input_next) / 2.0, input_pre)

    target = target.to(dt)
    target_pre = mask_region_pre * target
    target_next = mask_region_next * target
    target_union = mask_region_union * target
    n_pre, n_next, n_union, n_total = global_sum(torch.stack([
        torch.sum(target_pre), torch.sum(target_next),
        torch.sum(target_union), torch.sum(target)]))

    eps = 1e-12
    loss_pre = -torch.sum(target_pre * torch.log(input_pre + eps))
    loss_pre = torch.where(n_pre > 0, loss_pre / n_pre.clamp(min=1.0),
                           loss_pre)
    loss_next = -torch.sum(target_next * torch.log(input_next + eps))
    loss_next = torch.where(n_next > 0, loss_next / n_next.clamp(min=1.0),
                            loss_next)
    loss_all = -torch.sum(target_pre * torch.log(input_all + eps))
    loss_all = torch.where((n_pre > 0) & (n_next > 0),
                           loss_all / n_pre.clamp(min=1.0), loss_all)
    loss_sim = torch.sum(target_union * torch.abs(input_next - input_pre))
    loss_sim = torch.where(n_union > 0, loss_sim / n_total.clamp(min=1.0),
                           loss_sim)
    total = (loss_pre + loss_next + loss_all + loss_sim) / 4.0

    # accuracy diagnostics (argmax agreement on valid rows and columns)
    with torch.no_grad():
        idx_t = _argmax_first(target_pre, 2)[:, : n1 - 1]
        idx_p = _argmax_first(input_all, 2)[:, : n1 - 1]
        valid_rows = mask_pre[:, : n1 - 1].to(dt)
        idx_t2 = _argmax_first(target_next, 1)[:, : n1 - 1]
        idx_p2 = _argmax_first(input_next, 1)[:, : n1 - 1]
        valid_cols = mask_next[:, : n1 - 1].to(dt)
        n_rows, n_cols = global_sum(torch.stack([valid_rows.sum(),
                                                 valid_cols.sum()]))
        acc_pre = (torch.sum((idx_t == idx_p) * valid_rows)
                   / n_rows.clamp(min=1.0))
        acc_next = (torch.sum((idx_t2 == idx_p2) * valid_cols)
                    / n_cols.clamp(min=1.0))
    return {"loss_pre": loss_pre, "loss_next": loss_next,
            "loss_similarity": loss_sim, "loss": total,
            "accuracy_pre": acc_pre, "accuracy_next": acc_next,
            "accuracy": (acc_pre + acc_next) / 2.0}


def _argmax_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The first index of the maximum along ``dim``, as ``jnp.argmax``
    (``torch.argmax`` does not promise the first of ties)."""
    top = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ids = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == top, ids, n).amin(dim=dim)


HEAD_L1 = ("reg", "wh", "tracking", "ltrb", "ltrb_amodal", "dim",
           "amodel_offset", "velocity")


def generic_loss(outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor],
                 weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Per-head loss dispatch; ``tot`` = 0.05 x sum(w_h * loss_h)
    (``trainer.py:142-146``)."""
    losses: Dict[str, torch.Tensor] = {}
    out = dict(outputs)
    out["hm"] = clamped_sigmoid(out["hm"])
    losses["hm"] = fast_focal_loss(out["hm"], batch["hm"], batch["ind"],
                                   batch["mask"], batch["cat"])
    for head in HEAD_L1:
        if head in out:
            losses[head] = reg_weighted_l1_loss(
                out[head], batch[f"{head}_mask"], batch["ind"], batch[head])
    if "dep" in out:
        # trainer.py:48: dep decoded as 1/(sigmoid+1e-6) - 1 before the L1
        dep_pred = 1.0 / (torch.sigmoid(out["dep"]) + 1e-6) - 1.0
        losses["dep"] = reg_weighted_l1_loss(dep_pred, batch["dep_mask"],
                                             batch["ind"], batch["dep"])
    if "rot" in out:
        losses["rot"] = bin_rot_loss(out["rot"], batch["rot_mask"],
                                     batch["ind"], batch["rotbin"],
                                     batch["rotres"])
    if "nuscenes_att" in out:
        losses["nuscenes_att"] = weighted_bce_loss(
            out["nuscenes_att"], batch["nuscenes_att_mask"], batch["ind"],
            batch["nuscenes_att"])
    total = 0.0
    for head, loss in losses.items():
        total = total + weights.get(head, 1.0) * loss
    losses["tot"] = 0.05 * total
    return losses


def joint_loss(det_total: torch.Tensor, match_total: torch.Tensor,
               s_det: torch.Tensor, s_id: torch.Tensor) -> torch.Tensor:
    """Kendall uncertainty weighting (``trainer.py:168``, intended
    semantics); ``s_det + s_id`` on rank 0 alone (module docstring)."""
    total = torch.exp(-s_det) * det_total + torch.exp(-s_id) * match_total
    return total + s_det + s_id if rank() == 0 else total
