"""AFE: appearance-feature extraction + affinity matching head, the
counterpart of ``deft_tpu/models/afe.py``.

Parameters are the reference's (``AFE.selector.<i>``, ``AFE.stacker2_bn``,
``AFE.final_net.<i>``): one 3x3 selector conv per feature-map scale, a shared
BatchNorm on embeddings, and the pairwise 1x1-conv stack
[2E -> 512 -> 256 -> 128 -> 64 -> 1].  The computation follows the JAX
package:

* the selectors' input widths are the trunk's (``in_channels``; flax
  infers them), DLA-34's by default;
* embeddings are border-padded bilinear samples of the ReLU'd selector maps
  at the object centers, concatenated to E = 416 dims (MOT, KITTI) or 704
  (nuScenes, ``selector_out_channels``);
* the first affinity layer is split into its pre and next halves, so the
  N x N pair grid is materialized only after two [N, 512] products; the
  remaining layers are per-pair matmuls;
* the BN on embeddings runs on the un-tiled [N, E] embeddings (each appears
  N times in the reference's tile, so the statistics are the same);
* the dual softmax pads rows and columns with ZEROS (not -inf), which then
  take part in the softmax denominators, as in the reference;
* ``window_similarity`` evaluates the whole ring window in one batched call.

``forward_train`` is the training forward (``__call__`` of the JAX module,
``afe.py:140-153``): the [B, N+1, N+1] affinity of two centre sets with the
false row and column at ``FALSE_CONSTANT``.  In train mode its BatchNorms
normalize with the batch statistics and update their running statistics as
flax does (``layers.train_batch_norm``): ``stacker2_bn`` over the pre
embeddings first, then over the next ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deft_tpu_torch.models.layers import Conv2d, batch_norm, train_batch_norm
from deft_tpu_torch.ops.sampling import grid_sample_points

# DLA-34's 13 selector input widths; other trunks pass theirs
# (``models/dla.py::selector_widths``)
SELECTOR_INPUT_CHANNELS = (16, 32, 64, 128, 256, 512, 64, 128, 256, 512,
                           64, 64, 64)
SELECTOR_OUT_2D = (32,) * 13
SELECTOR_OUT_NUSCENES = (48, 48, 64, 64, 64, 64, 64, 64, 64, 64, 32, 32, 32)
FINAL_WIDTHS = (512, 256, 128, 64, 1)
FALSE_CONSTANT = 1.0


def selector_out_channels(dataset: str) -> Tuple[int, ...]:
    return SELECTOR_OUT_NUSCENES if dataset == "nuscenes" else SELECTOR_OUT_2D


def _bn_last(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm over the last axis of any-rank ``x``: the running
    statistics in eval mode, flax's train-mode statistics in train mode."""
    if bn.training:
        return train_batch_norm(x.reshape(-1, x.shape[-1]), bn).reshape(
            x.shape)
    return ((x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
            * bn.weight + bn.bias)


class AFE(nn.Module):
    def __init__(self, max_object: int = 100, align_corners: bool = True,
                 dataset: str = "mot",
                 in_channels: Sequence[int] = SELECTOR_INPUT_CHANNELS):
        super().__init__()
        outs = selector_out_channels(dataset)
        self.max_object = max_object
        self.align_corners = align_corners
        self.embed_dim = int(sum(outs))
        self.selector = nn.ModuleList(
            Conv2d(cin, cout, 3, padding=1, bias=True)
            for cin, cout in zip(in_channels, outs))
        self.stacker2_bn = batch_norm(self.embed_dim)
        # reference ModuleList [conv, bn, relu] * 3 + [conv, relu] * 2
        layers = []
        cin = 2 * self.embed_dim
        for li, w in enumerate(FINAL_WIDTHS):
            layers.append(nn.Conv2d(cin, w, 1, bias=True))
            if li < len(FINAL_WIDTHS) - 2:
                layers.append(batch_norm(w))
            layers.append(nn.ReLU(inplace=True))
            cin = w
        self.final_net = nn.ModuleList(layers)
        self._convs = [m for m in layers if isinstance(m, nn.Conv2d)]
        self._bns = [m for m in layers if isinstance(m, nn.BatchNorm2d)]

    # ---- embedding extraction ------------------------------------------------

    def extract(self, feature_maps: Sequence[torch.Tensor],
                centers: torch.Tensor) -> torch.Tensor:
        """13 NCHW maps + [B, N, 2] centers in [-1, 1] -> [B, N, E]."""
        feats = []
        for sel, fm in zip(self.selector, feature_maps):
            s = torch.relu(sel(fm)).permute(0, 2, 3, 1)       # [B, H, W, oc]
            feats.append(torch.stack([
                grid_sample_points(s[b], centers[b], self.align_corners)
                for b in range(s.shape[0])]))
        return torch.cat(feats, dim=-1).float()

    # ---- affinity MLP --------------------------------------------------------

    def affinity(self, e_pre: torch.Tensor, e_next: torch.Tensor) -> torch.Tensor:
        """[..., N, E] x [..., M, E] -> [..., N, M] raw affinity (>= 0)."""
        e = self.embed_dim
        e_pre = _bn_last(e_pre, self.stacker2_bn)
        e_next = _bn_last(e_next, self.stacker2_bn)
        w0 = self._convs[0].weight[:, :, 0, 0]                # [512, 2E]
        pre0 = e_pre @ w0[:, :e].t()
        next0 = e_next @ w0[:, e:].t()
        x = pre0[..., :, None, :] + next0[..., None, :, :] + self._convs[0].bias
        x = torch.relu(_bn_last(x, self._bns[0]))
        for li, conv in enumerate(self._convs[1:], start=1):
            x = F.linear(x, conv.weight[:, :, 0, 0], conv.bias)
            if li < len(self._bns):
                x = _bn_last(x, self._bns[li])
            x = torch.relu(x)
        return x[..., 0]

    def forward_train(self, feature_maps_pre: Sequence[torch.Tensor],
                      feature_maps_next: Sequence[torch.Tensor],
                      centers_pre: torch.Tensor,
                      centers_next: torch.Tensor) -> torch.Tensor:
        """Training forward (``deft_tpu/models/afe.py:140-153``): two sets
        of 13 maps and [B, N, 2] centres -> [B, N+1, N+1] affinity, the
        false row and column at ``FALSE_CONSTANT``."""
        e_pre = self.extract(feature_maps_pre, centers_pre)
        e_next = self.extract(feature_maps_next, centers_next)
        aff = self.affinity(e_pre, e_next)                    # [B, N, M]
        return F.pad(aff, (0, 1, 0, 1), value=FALSE_CONSTANT)

    # ---- inference similarity (dual softmax) ---------------------------------

    def stacker_features(self, e_pre: torch.Tensor, e_next: torch.Tensor,
                         n_pre, n_next) -> torch.Tensor:
        """Fixed-shape ``forward_stacker_features``, batched over leading
        axes.

        e_pre [..., N, E] and e_next [N, E] are zero-padded to N = max_object
        rows; n_pre (scalar or [...]) and n_next count their valid rows.
        Returns [..., N, N+1]: fused similarity for real (i, j) pairs, column
        ``n_next`` holds the unmatched probability, rows >= n_pre and columns
        > n_next are zero.
        """
        n = self.max_object
        dev = e_pre.device
        aff = self.affinity(e_pre, e_next)                    # [..., N, N]
        n_pre = torch.as_tensor(n_pre, device=dev)[..., None, None]
        n_next = torch.as_tensor(n_next, device=dev)
        ids = torch.arange(n, device=dev)
        row_ok = ids[:, None] < n_pre                         # [..., N, 1]
        aff = aff * (ids < n_next)[None, :] * row_ok

        # append the false row/col of 1.0 -> [..., N+1, N+1]
        aff = F.pad(aff, (0, 1, 0, 1), value=FALSE_CONSTANT)
        x_f = torch.softmax(aff, dim=-1)
        x_t = torch.softmax(aff, dim=-2)
        real = torch.maximum(x_f[..., :n, :n], x_t[..., :n, :n])
        last_col_f = x_f[..., :n, n:]                         # [..., N, 1]
        fused = torch.cat([real, last_col_f], dim=-1)         # [..., N, N+1]
        col = torch.arange(n + 1, device=dev)
        unmatched = torch.where(col == n_next, last_col_f,
                                torch.zeros((), device=dev))
        fused = torch.where(col < n_next, fused, unmatched)
        return fused * row_ok

    def window_similarity(self, window_embeds: torch.Tensor,
                          window_counts: torch.Tensor, e_next: torch.Tensor,
                          n_next) -> torch.Tensor:
        """window_embeds [W, N, E], window_counts [W], e_next [N, E] ->
        [W, N, N+1] (slot w = stacker_features(window[w], current))."""
        return self.stacker_features(window_embeds, e_next, window_counts,
                                     n_next)
