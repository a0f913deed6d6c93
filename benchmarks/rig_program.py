"""What the rig cells set up of the program: seeded weights for the nuScenes
network, calibrated so that the random network behaves like a trained one
where the cell's load depends on it, and a seeded LSTM motion model.

``make_rig_weights(det, config, spec, frames, seed, device, log)``:
``weights.make_state_dict`` and ``weights.calibrate`` (every BatchNorm, the
offset convs, the AFE, the box heads) on the reference's input of the
calibration frames (uint8, [N, H, W, 3]: the scene's
``calibration_samples``, every camera), then:

* each 3-D head's output conv is scaled so its values spread by
  ``ddd_heads[head]["spread"]`` over the images (one more float32
  reference forward), and its bias set to ``ddd_heads[head]["bias"]``
  (the depth head's bias ``-ln(depth_m)`` gives that depth in metres, as
  the decode takes ``1 / sigmoid - 1``);
* the heatmap head's output conv is scaled so its logits spread by
  ``hm_spread``; then, on the program's own heatmap of the calibration
  frames (``det`` with these weights, its input path and its rounding),
  each class of
  ``camera_share`` takes, of its own output row and ``ROW_CANDIDATES``
  - 1 seeded others scaled to the same spread, the one whose peaks at
  the bias that gives the class its share of the images come nearest
  its ``detections_per_frame`` (``class_rows``); last, the class biases
  are set on the program's logits with those rows: a class of
  ``camera_share`` has a detection in that share of the images, any
  other class its ``detections_per_frame`` (``class_biases``).  Peaks
  count at or above the score the tracker takes a class at
  (``cascade3d.SCORE_CUT``, the pedestrians' ``PEDESTRIAN_CUT``) as the
  program's decode counts them, and a tracked class's as the rig's
  per-class NMS then keeps them (on the boxes the program's decode makes
  at the peaks, ``program_maps``).

Why so: a camera's class tracker updates, and runs its ring similarity on
the card, where the class has a detection, and each detection the
trackers take becomes a track that they keep for the scene; the rig's
load is the class updates with detections and the detections, and a
sample's time follows both.  A random network's peaks of one class
cluster in a few cameras, by a factor that changes from row to row and
seed to seed, so one bias holds either a class's share of the cameras or
its count, not both: the choice of row holds the count where the bias
holds the share.  Counting on the program's logits (the reference's
differ by rounding where the counts are steepest) and after the NMS
(which drops a share of a clustered class's peaks that changes from seed
to seed) holds both to the frames the program takes.  The calibration
samples are spread over the scene, whose traffic stays the same around
the car throughout.

``lstm_state_dict(seed, device)``: ``lstm_ref.make_state_dict`` for the
nuScenes features (18) and futures (4).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks import weights
from benchmarks.reference import lstm_ref
from benchmarks.reference.cascade3d import (CLASS_NAMES, FEATURES, FUTURE,
                                            NMS_DEFAULT, NMS_OVERLAP,
                                            PEDESTRIAN_CUT, SCORE_CUT,
                                            TRACKED, nms)
from benchmarks.reference.deft_ref import Reference, input_image

BIAS_RANGE = 10.0    # the heatmap biases are sought within +-10 spreads
ROW_CANDIDATES = 24  # output rows tried for each class of camera_share


def class_cut(c: int) -> float:
    return PEDESTRIAN_CUT if CLASS_NAMES[c] == "pedestrian" else SCORE_CUT


@torch.no_grad()
def make_rig_weights(det, config: dict, spec: dict, frames: torch.Tensor,
                     seed: int, device, log) -> dict:
    sd = weights.make_state_dict(weights.state_shapes(det.model), seed,
                                 device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 2)
    images = input_image(frames, config["input_h"], config["input_w"])
    # the heatmap's biases this sets are set again below
    info = weights.calibrate(sd, spec, images, {
        **config, "detections_per_frame": [1.0] * len(CLASS_NAMES)}, gen)
    y, _ = Reference(sd, spec).trunk(images)
    del images

    def logits(head):
        t = torch.relu(Reference(sd, spec).conv(y, f"{head}.0", padding=1))
        return F.conv2d(t, sd[f"{head}.2.weight"])

    for head, want in config["ddd_heads"].items():
        gain = want["spread"] / logits(head).std().clamp(min=1e-6).item()
        sd[f"{head}.2.weight"].mul_(gain)
        sd[f"{head}.2.bias"].copy_(torch.tensor(
            [-math.log(b) for b in want["bias"]] if head == "dep"
            else want["bias"], device=device))
        info[f"{head}_gain"] = gain
    gain = config["hm_spread"] / logits("hm").std().item()
    sd["hm.2.weight"].mul_(gain)
    del y
    sd["hm.2.bias"].zero_()
    det.model.load_state_dict(sd)
    _, boxes, hidden = program_maps(det, frames, keep_hidden=True)
    rows, info["hm_rows"] = class_rows(hidden, boxes, sd["hm.2.weight"],
                                       config, seed)
    del hidden
    sd["hm.2.weight"].copy_(rows)
    det.model.load_state_dict(sd)
    z, _, _ = program_maps(det, frames)
    info["hm_gain"] *= gain
    info["hm_bias"], info["hm_share"], info["hm_count"] = class_biases(
        z, boxes, config)
    sd["hm.2.bias"].copy_(torch.tensor(info["hm_bias"], device=device))
    det.model.load_state_dict(sd)
    log(f"# calibration: {info}")
    return sd


def program_maps(det, frames: torch.Tensor, batch: int = 6,
                 keep_hidden: bool = False) -> tuple:
    """The program's heatmap logits [N, C, h, w] of uint8 frames, through
    its own input path and forward; the box its decode makes at each cell,
    [N, h, w, 4] tlbr in output cells (the cell, its ``reg`` offset, its
    ``wh``); with ``keep_hidden``, the heatmap head's input to its output
    conv, [N, head_conv, h, w] at the compute dtype (else None)."""
    hm, boxes, hidden = [], [], []
    out_conv = det.model.hm[-1]
    hook = (out_conv.register_forward_pre_hook(
        lambda _, args: hidden.append(args[0])) if keep_hidden else None)
    try:
        for i in range(0, frames.shape[0], batch):
            images = torch.cat([det.pre_process(f)[0]
                                for f in frames[i: i + batch]])
            out = det.model(images)[0]
            hm.append(out["hm"].permute(0, 3, 1, 2))
            boxes.append(cell_boxes(out["reg"], out["wh"]))
    finally:
        if hook is not None:
            hook.remove()
    return (torch.cat(hm), torch.cat(boxes),
            torch.cat(hidden) if keep_hidden else None)


def cell_boxes(reg: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[B, h, w, 4] tlbr boxes of the ``reg`` and ``wh`` maps [B, h, w, 2]
    at every cell, as the decode makes them at a peak."""
    h, w = reg.shape[1:3]
    ys, xs = torch.meshgrid(torch.arange(h, device=reg.device),
                            torch.arange(w, device=reg.device), indexing="ij")
    cx, cy = xs + reg[..., 0], ys + reg[..., 1]
    half = wh.clamp(min=0.0) / 2
    return torch.stack([cx - half[..., 0], cy - half[..., 1],
                        cx + half[..., 0], cy + half[..., 1]], -1)


def _peaks(z: torch.Tensor, c: int, boxes: torch.Tensor, rnd,
           steps: int = 60) -> "Peaks":
    """Class ``c``'s ``Peaks`` of logits z [N, h, w]; a tracked class's
    counted after its NMS."""
    name = CLASS_NAMES[c]
    if name not in TRACKED:
        return Peaks(z, class_cut(c), rnd, steps=steps)
    return Peaks(z, class_cut(c), rnd, boxes,
                 NMS_OVERLAP.get(name, NMS_DEFAULT), steps)


def row_logits(hidden: torch.Tensor, row: torch.Tensor, rnd,
               chunk: int = 24) -> torch.Tensor:
    """The logits [N, h, w] of one output row [K] over the head's hidden
    maps [N, K, h, w]: the row at the compute dtype, float32 sums, the
    result rounded to the compute dtype, as the program's conv makes
    them."""
    w = rnd(row)
    return torch.cat([rnd(torch.einsum("nkhw,k->nhw", hidden[i: i + chunk]
                                       .float(), w))
                      for i in range(0, hidden.shape[0], chunk)])


def class_rows(hidden: torch.Tensor, boxes: torch.Tensor,
               weight: torch.Tensor, config: dict, seed: int) -> tuple:
    """The heatmap's output conv weight [C, K, 1, 1] with, for each class
    of ``camera_share``, the row among its own and ``ROW_CANDIDATES`` - 1
    seeded others (each scaled to the same logit spread) whose peaks, at
    the bias that gives the class its share of the images, come nearest
    its ``detections_per_frame`` after the NMS; and which candidate each
    class took (0: its own)."""
    rnd = weights._rounding(config["compute_dtype"])
    bound = BIAS_RANGE * config["hm_spread"]
    share, count = config["camera_share"], config["detections_per_frame"]
    rows = weight.clone()
    gen = torch.Generator(device=weight.device)
    gen.manual_seed(int(seed) + 5)
    picked = {}
    for c, name in enumerate(CLASS_NAMES):
        if name not in share:
            continue
        own = weight[c, :, 0, 0]
        spread = row_logits(hidden, own, rnd).std()
        best = None
        for k in range(ROW_CANDIDATES):
            row = own if k == 0 else torch.randn(
                own.shape, generator=gen, device=own.device)
            z = row_logits(hidden, row, rnd)
            if k:
                row = row * (spread / z.std().clamp(min=1e-6))
                z = row_logits(hidden, row, rnd)
            at = _peaks(z, c, boxes, rnd, steps=40)
            miss = abs(at.count(at.bias_for_share(share[name], bound))
                       - count[name])
            if best is None or miss < best[0]:
                best = (miss, k, row)
        rows[c, :, 0, 0] = best[2]
        picked[name] = best[1]
    return rows, picked


def class_biases(z: torch.Tensor, boxes: torch.Tensor, config: dict
                 ) -> tuple:
    """The heatmap's class biases (module docstring) for bias-free logits
    z [N, C, h, w] at the compute dtype and the decode's boxes [N, h, w, 4]
    (``program_maps``), and the share of the images with a detection and
    the detections per image each gives a class."""
    rnd = weights._rounding(config["compute_dtype"])
    bound = BIAS_RANGE * config["hm_spread"]
    share, count = config["camera_share"], config["detections_per_frame"]
    bias, got_share, got_count = [], {}, {}
    for c, name in enumerate(CLASS_NAMES):
        at = _peaks(z[:, c], c, boxes, rnd)
        bias.append(at.bias_for_share(share[name], bound) if name in share
                    else at.bias_for_count(count[name], bound))
        got_share[name] = round(at.share(bias[-1]), 4)
        got_count[name] = round(at.count(bias[-1]), 4)
    return bias, got_share, got_count


class Peaks:
    """One class's peaks at or above ``thr`` over images [N, h, w] of
    bias-free logits, under a bias, rounded as the program rounds (equal
    rounded neighbours all count, as the decode's max-pool keeps them).
    With the decode's ``boxes`` [N, h, w, 4], ``count`` counts what the
    rig's per-class greedy NMS at ``overlap`` keeps of each image's."""

    def __init__(self, z: torch.Tensor, thr: float, rnd, boxes=None,
                 overlap: float = NMS_DEFAULT, steps: int = 60):
        self.z, self.thr, self.rnd, self.steps = z, thr, rnd, steps
        self.boxes, self.overlap = boxes, overlap

    def score(self, bias: float) -> torch.Tensor:
        logit = self.rnd(self.z + self.rnd(torch.tensor(bias,
                                                        device=self.z.device)))
        return torch.sigmoid(logit).clamp(1e-4, 1.0 - 1e-4)

    def mask(self, bias: float) -> torch.Tensor:
        score = self.score(bias)
        mx = F.max_pool2d(score[:, None], 3, 1, 1)[:, 0]
        return ((mx == score) & (score >= self.thr)).flatten(1)

    def count(self, bias: float) -> float:
        m = self.mask(bias)
        if self.boxes is None:
            return float(m.sum()) / self.z.shape[0]
        frame, cell = m.nonzero(as_tuple=True)
        score = self.score(bias).flatten(1)[frame, cell].cpu().numpy()
        box = self.boxes.flatten(1, 2)[frame, cell].cpu().numpy()
        frame = frame.cpu().numpy()
        cuts = np.flatnonzero(np.diff(frame)) + 1
        kept = sum(len(nms(b, s, self.overlap)) for b, s in
                   zip(np.split(box, cuts), np.split(score, cuts)) if len(s))
        return kept / self.z.shape[0]

    def share(self, bias: float) -> float:
        return float(self.mask(bias).any(1).float().mean())

    def _bisect(self, reached, bound: float) -> float:
        lo, hi = -bound, bound
        for _ in range(self.steps):
            mid = 0.5 * (lo + hi)
            if reached(mid):
                hi = mid
            else:
                lo = mid
        return hi

    def bias_for_count(self, n: float, bound: float) -> float:
        return self._bisect(lambda b: self.count(b) >= n, bound)

    def bias_for_share(self, share: float, bound: float) -> float:
        return self._bisect(lambda b: self.share(b) >= share, bound)


def lstm_state_dict(seed: int, device) -> dict:
    return lstm_ref.make_state_dict(int(seed) + 3, FEATURES, FUTURE, device)
