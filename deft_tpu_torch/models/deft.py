"""DEFTNet: joint detection + embedding network, the counterpart of
``deft_tpu/models/deft.py`` (inference entry points).

The network is the reference's ``DLASeg`` with its head towers (3x3 conv ->
ReLU -> 1x1 out, heatmap bias = ``prior_bias``) and the AFE head as direct
attributes, so a reference ``state_dict`` loads with its own key names
(``base.*``, ``dla_up.*``, ``ida_up.*``, ``hm.*``, ``AFE.*`` ...).

Entry points, with the JAX layouts at their boundary:

* ``forward(image)`` -> ``({head: [B, H/4, W/4, C]}, feature_maps[13])``;
  ``image`` is NHWC as in the JAX package, feature maps stay NCHW;
* ``detect(image, k)`` -> sigmoided + decoded top-K detections and their AFE
  embeddings (no ``flip_test``, no ``parity_tf`` yet);
* ``extract`` and ``window_similarity`` re-export the AFE head.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from deft_tpu_torch.models.afe import AFE
from deft_tpu_torch.models.dla import DLASeg, NodeSpec
from deft_tpu_torch.ops.decode import clamped_sigmoid, generic_decode


class HeadTower(nn.Sequential):
    """One output head (reference ``base_model.py:36-94``): children
    ``0`` (3x3 conv), ``2`` (1x1 conv) ... with ReLUs between, the 1x1 output
    conv last."""

    def __init__(self, cin: int, out_channels: int, convs: Sequence[int],
                 head_kernel: int = 3, prior_bias=None):
        layers = []
        if len(convs) > 0:
            layers += [nn.Conv2d(cin, convs[0], head_kernel,
                                 padding=head_kernel // 2, bias=True),
                       nn.ReLU(inplace=True)]
            for c_prev, c in zip(convs[:-1], convs[1:]):
                layers += [nn.Conv2d(c_prev, c, 1, bias=True),
                           nn.ReLU(inplace=True)]
            cin = convs[-1]
        out = nn.Conv2d(cin, out_channels, 1, bias=True)
        with torch.no_grad():
            out.bias.fill_(0.0 if prior_bias is None else prior_bias)
        layers.append(out)
        super().__init__(*layers)


class DEFTNet(DLASeg):
    """Trunk + heads + AFE (reference ``DLASeg`` with ``opt.AFE``)."""

    def __init__(self, heads: Dict[str, int], head_convs: Dict[str, Sequence[int]],
                 spec: NodeSpec, max_object: int = 100,
                 prior_bias: float = -4.6, head_kernel: int = 3,
                 align_corners: bool = True):
        super().__init__(spec)
        self.heads = dict(heads)
        last_channel = self.base.channels[self.first_level]
        for h, c in self.heads.items():
            setattr(self, h, HeadTower(
                last_channel, c, tuple(head_convs.get(h, ())), head_kernel,
                prior_bias if "hm" in h else None))
        self.AFE = AFE(max_object, align_corners)

    @property
    def embed_dim(self) -> int:
        return self.AFE.embed_dim

    def forward(self, image: torch.Tensor):
        """image [B, H, W, 3] -> ({head: [B, H/4, W/4, C]}, 13 NCHW maps)."""
        y, feature_maps = super().forward(
            image.permute(0, 3, 1, 2).contiguous())
        outputs = {h: getattr(self, h)(y).float().permute(0, 2, 3, 1)
                   for h in self.heads}
        return outputs, feature_maps

    def extract(self, feature_maps, centers):
        return self.AFE.extract(feature_maps, centers)

    def window_similarity(self, window_embeds, window_counts, e_next, n_next):
        return self.AFE.window_similarity(window_embeds, window_counts,
                                          e_next, n_next)

    def detect(self, image: torch.Tensor, k: int = 100):
        """forward -> sigmoid -> decode -> embedding extract.

        Returns (dets, embeddings): dets is a dict of [B, K, ...] decoded
        tensors in output-grid coordinates; embeddings [B, K, E] are sampled
        at the decoded (amodal) box centers, normalized to [-1, 1] over the
        output grid.
        """
        outputs, feature_maps = self(image)
        outputs["hm"] = clamped_sigmoid(outputs["hm"])
        dets = generic_decode(outputs, k=k)
        bboxes = dets.get("bboxes")
        if bboxes is None:
            cts = dets["cts"]
        else:
            cts = torch.stack([(bboxes[..., 0] + bboxes[..., 2]) / 2.0,
                               (bboxes[..., 1] + bboxes[..., 3]) / 2.0], dim=-1)
        out_h = image.shape[1] // 4
        out_w = image.shape[2] // 4
        centers = torch.stack([2.0 * cts[..., 0] / out_w - 1.0,
                               2.0 * cts[..., 1] / out_h - 1.0], dim=-1)
        return dets, self.extract(feature_maps, centers)
