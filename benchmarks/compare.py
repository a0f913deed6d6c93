"""Whether a tracking window's outputs are right: the program against the
float32 reference on the same frames and weights.

What the timed path hands its cascade is recorded for every frame of the
window (``Record``: the detections after post-processing, in the frame's
pixels, the similarity against the ring, and the scores of the tracks the
cascade emitted).  After the window, blocks of consecutive frames drawn
from the seed are worked out again by the reference, and these numbers are
taken, each the worst over the frames compared:

* ``score_gap``: a detection's score against the reference's heatmap at the
  detection's own cell, the worst detection (1 where one lies off the
  output grid);
* ``box_gap``: the box corners and the tracking offset, in output cells,
  against the reference's heads at the detection's cell;
* ``missed``: the share of the reference's peaks ``MISS_MARGIN`` above the
  threshold (``due``) with no detection of the program of their class
  within ``MISS_CELLS`` output cells, over all the frames compared (a
  recall: the numbers above are read only where the program put a
  detection); ``missed_frame``, the worst frame's share, is reported
  beside it;
* ``sim_rel``: each frame's mean relative gap of the similarity against
  the reference's (over the entries of real pairs and the unmatched
  column, each entry's gap over the reference's entry, at least
  ``SIM_FLOOR``), the worst frame; the reference fills the ring with its
  own embeddings of the earlier frames of the block (at its own boxes'
  centres of the program's detections);
* ``ring_misses``: ring rows of the similarity that are live (not all
  zero) where the reference's ring holds no detection, or dead where it
  holds one, over all the frames compared: an exact check that each
  frame's program found the ring the earlier frames wrote;
* ``id_misses`` (``cascade_misses``, over every frame of the window, not
  only the blocks): emitted tracks on which the program's cascade and the
  plain one (``reference/cascade.py``), run from the window's first frame
  on the detections and similarities the program's frame stage handed its
  cascade, disagree in id, box or score (an exact check).

Each cell's limits file says which of these numbers it compares.  A
window whose judged frames hold no detection of the program where the
reference has peaks due is a failed run: its answers never came.

The reference reads the program's detections only to choose where to look,
as a served model's tokens are read to judge them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmarks.reference.cascade import Cascade, emitted_misses
from benchmarks.reference.deft_ref import (Reference, fix_res_affine,
                                           input_image, peaks,
                                           sigmoid_clamped)

OFF_GRID = 0.01       # output cells: a detection's cell is a whole number
MISS_MARGIN = 0.1     # a reference peak this far above the threshold is due
MISS_CELLS = 2        # a due peak is found by a detection this near
REF_BATCH = 4         # frames per reference forward
SIM_FLOOR = 1e-3      # the least similarity ``sim_rel`` divides by
TRACK_BOX_TOL = 1e-3  # pixels: an emitted track's box on both sides


@dataclass
class Record:
    """One frame as the cascade got it, in arrays (a window's worth of
    dicts would grow the program's garbage collections): the detections'
    scores [n], classes [n] (1-based), centres [n, 2], boxes [n, 4] and
    tracking offsets [n, 2] (or None) in the frame's pixels, the
    similarity, and the tracks the cascade emitted: ids [t], tlbr boxes
    [t, 4] and scores [t]."""
    scores: np.ndarray
    classes: np.ndarray
    cts: np.ndarray
    boxes: np.ndarray
    tracking: Optional[np.ndarray]
    sims: Optional[np.ndarray]
    tracks: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @classmethod
    def of(cls, results: List[dict], sims, tracks=None) -> "Record":
        """From the post-processed detection dicts the cascade takes."""
        n = len(results)
        tracking = None
        if n and "tracking" in results[0]:
            tracking = np.array([d["tracking"] for d in results],
                                np.float64).reshape(n, 2)
        return cls(np.array([d["score"] for d in results], np.float64),
                   np.array([d["class"] for d in results], np.int64),
                   np.array([d["ct"] for d in results],
                            np.float64).reshape(n, 2),
                   np.array([d["bbox"] for d in results],
                            np.float64).reshape(n, 4),
                   tracking, sims, tracks)

    def __len__(self):
        return len(self.scores)


@dataclass
class Geometry:
    frame_h: int
    frame_w: int
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    to_out: np.ndarray        # 2x3 affine, frame pixels -> output cells
    to_frame: np.ndarray      # its inverse

    @classmethod
    def of(cls, cfg: dict, frame_h: int, frame_w: int) -> "Geometry":
        in_h, in_w = cfg["input_h"], cfg["input_w"]
        d = cfg["down_ratio"]
        a = fix_res_affine(frame_h, frame_w, in_h // d, in_w // d).numpy()
        inv = np.linalg.inv(np.vstack([a, [0.0, 0.0, 1.0]]))[:2]
        return cls(frame_h, frame_w, in_h, in_w, in_h // d, in_w // d, a,
                   inv)

    def out(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        return pts @ self.to_out[:, :2].T + self.to_out[:, 2]

    def frame(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        return pts @ self.to_frame[:, :2].T + self.to_frame[:, 2]


def choose_blocks(n_done: int, length: int, count: int,
                  seed: int) -> List[Tuple[int, int]]:
    """``count`` blocks of ``length`` consecutive window frames among the
    first ``n_done``, drawn from the seed (one block of all of them when
    there are too few)."""
    if n_done <= length:
        return [(0, n_done)]
    rng = np.random.default_rng(int(seed) + 1)
    starts = sorted(rng.choice(n_done - length + 1,
                               size=min(count, n_done - length + 1),
                               replace=False))
    return [(int(a), int(a) + length) for a in starts]


class TrackJudge:
    """The reference side of a track cell's comparison."""

    def __init__(self, ref: Reference, cfg: dict, geom: Geometry):
        self.ref = ref
        self.cfg = cfg
        self.geom = geom
        self.m = cfg["max_object"]
        self.thr = cfg["track_thresh"]
        self.tracked = cfg.get("tracked_class")

    # ---- the reference's view of frames -------------------------------------

    @torch.no_grad()
    def forward(self, frames: torch.Tensor):
        """uint8 frames [B, H, W, 3] on the device -> (heads, maps)."""
        x = input_image(frames, self.geom.in_h, self.geom.in_w)
        y, maps = self.ref.trunk(x)
        return self.ref.heads(y), maps

    def ref_boxes(self, heads: Dict[str, torch.Tensor], i: int,
                  cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The reference's decoded boxes and tracking offsets at integer
        cells [n, 2] (x, y) of frame i, in output cells."""
        xs = torch.as_tensor(cells[:, 0], device=heads["hm"].device).long()
        ys = torch.as_tensor(cells[:, 1], device=heads["hm"].device).long()

        def at(head):
            return heads[head][i][:, ys, xs].t().double().cpu().numpy()

        x0 = cells[:, 0:1].astype(np.float64)
        y0 = cells[:, 1:2].astype(np.float64)
        if "ltrb_amodal" in heads:
            d = at("ltrb_amodal")
            boxes = np.hstack([x0 + d[:, 0:1], y0 + d[:, 1:2],
                               x0 + d[:, 2:3], y0 + d[:, 3:4]])
        else:
            reg = at("reg") if "reg" in heads else np.full((len(x0), 2), 0.5)
            wh = np.maximum(at("wh"), 0.0)
            cx, cy = x0 + reg[:, 0:1], y0 + reg[:, 1:2]
            boxes = np.hstack([cx - wh[:, 0:1] / 2, cy - wh[:, 1:2] / 2,
                               cx + wh[:, 0:1] / 2, cy + wh[:, 1:2] / 2])
        tracking = (at("tracking") if "tracking" in heads
                    else np.zeros((len(x0), 2)))
        return boxes, tracking

    def due(self, hm: torch.Tensor) -> np.ndarray:
        """[n, 3] (class, x, y) of the reference's top-K peaks of one
        [C, h, w] sigmoided heatmap that score ``MISS_MARGIN`` above the
        threshold (over all classes, then the tracked class alone)."""
        c, h, w = hm.shape
        scores, idx = torch.topk(peaks(hm).reshape(-1), self.cfg["K"])
        idx = idx[scores >= self.thr + MISS_MARGIN].cpu().numpy()
        out = np.stack([idx // (h * w) + 1, idx % w, (idx % (h * w)) // w],
                       axis=1)
        if self.tracked is not None:
            out = out[out[:, 0] == self.tracked]
        return out

    def embed(self, maps, i: int, boxes: np.ndarray) -> torch.Tensor:
        """[max_object, E] embeddings of frame i at the boxes' centres
        (rows past the boxes zero)."""
        dev = maps[0].device
        n = min(len(boxes), self.m)
        centers = torch.zeros((1, max(n, 1), 2), device=dev)
        if n:
            c = 0.5 * (boxes[:n, 0:2] + boxes[:n, 2:4])
            c = np.stack([2.0 * c[:, 0] / self.geom.out_w - 1.0,
                          2.0 * c[:, 1] / self.geom.out_h - 1.0], axis=1)
            centers[0, :n] = torch.as_tensor(c, dtype=torch.float32,
                                             device=dev)
        emb = self.ref.embed([fm[i: i + 1] for fm in maps], centers)[0]
        out = torch.zeros((self.m, emb.shape[-1]), device=dev)
        out[:n] = emb[:n]
        return out

    # ---- judging recorded frames --------------------------------------------

    def judge(self, frames: torch.Tensor, order: Sequence[int],
              records: Sequence[Record],
              blocks: Sequence[Tuple[int, int]]) -> Dict[str, float]:
        """The numbers of the module docstring over ``blocks`` of window
        frames; ``order[j]`` is window frame j's index in ``frames``."""
        out = {"score_gap": 0.0, "box_gap": 0.0, "missed": 0.0,
               "missed_frame": 0.0, "sim_rel": 0.0, "ring_misses": 0,
               "frames": 0, "detections": 0, "sim_frames": 0, "due": 0,
               "due_missed": 0}
        for a, b in blocks:
            embs: Dict[int, torch.Tensor] = {}
            for j0 in range(a, b, REF_BATCH):
                js = list(range(j0, min(j0 + REF_BATCH, b)))
                heads, maps = self.forward(frames[[order[j] for j in js]])
                for i, j in enumerate(js):
                    gaps, boxes = self._detections(heads, i, records[j])
                    for k in ("score_gap", "box_gap"):
                        out[k] = max(out[k], gaps[k])
                    for k in ("due", "due_missed"):
                        out[k] += gaps[k]
                    if gaps["due"]:
                        out["missed_frame"] = max(
                            out["missed_frame"],
                            gaps["due_missed"] / gaps["due"])
                    out["frames"] += 1
                    out["detections"] += len(records[j])
                    embs[j] = self.embed(maps, i, boxes)
                del heads, maps
            for j in range(a, b):
                gaps = self._sims(j, a, embs, records)
                if gaps is not None:
                    out["sim_rel"] = max(out["sim_rel"], gaps[0])
                    out["ring_misses"] += gaps[1]
                    out["sim_frames"] += 1
        if out["due"]:
            out["missed"] = out["due_missed"] / out["due"]
        return out

    def _detections(self, heads, i: int, rec: Record):
        """One frame's gaps, and the reference's boxes at its detections."""
        hm = sigmoid_clamped(heads["hm"][i])
        n = len(rec)
        due = self.due(hm)
        gaps = {"due": len(due), "due_missed": len(due), "score_gap": 0.0,
                "box_gap": 0.0}
        if n == 0:
            return gaps, np.zeros((0, 4))
        cts = self.geom.out(rec.cts)
        cells = np.rint(cts)
        off_grid = np.abs(cts - cells).max() > OFF_GRID
        if len(due):
            near = ((due[:, None, 0] == rec.classes[None, :])
                    & (np.abs(due[:, None, 1:] - cells[None]).max(-1)
                       <= MISS_CELLS)).any(axis=1)
            gaps["due_missed"] = int((~near).sum())
        cells = np.clip(cells, 0, [self.geom.out_w - 1, self.geom.out_h - 1]
                        ).astype(np.int64)
        at = hm[torch.as_tensor(rec.classes - 1, device=hm.device),
                torch.as_tensor(cells[:, 1], device=hm.device),
                torch.as_tensor(cells[:, 0], device=hm.device)]
        ref_scores = at.double().cpu().numpy()
        gaps["score_gap"] = (1.0 if off_grid else
                             float(np.abs(rec.scores - ref_scores).max()))
        boxes, tracking = self.ref_boxes(heads, i, cells)
        prog_boxes = self.geom.out(rec.boxes.reshape(-1, 2)).reshape(-1, 4)
        box = np.abs(prog_boxes - boxes).max()
        if rec.tracking is not None:
            prog_tr = rec.tracking @ self.geom.to_out[:, :2].T
            box = max(box, np.abs(prog_tr - tracking).max())
        gaps["box_gap"] = float(box)
        return gaps, boxes

    def _sims(self, j: int, a: int, embs,
              records) -> Optional[Tuple[float, int]]:
        """(mean relative similarity gap over frame j's entries of real
        pairs and its unmatched column, ring rows live where the
        reference's ring has no detection or dead where it has one), or
        None where frame j's ring reaches before the block's first frame
        ``a``."""
        sims = records[j].sims
        if sims is None:
            return None
        w = sims.shape[0]
        ring = [t for t in range(j - 1, -1, -1) if len(records[t]) > 0][:w]
        if any(t < a for t in ring):
            return None
        emb = embs[j]
        dev = emb.device
        slots = torch.zeros((w, self.m, emb.shape[-1]), device=dev)
        counts = torch.zeros((w,), dtype=torch.int32, device=dev)
        for s, t in enumerate(ring):
            slots[s] = embs[t]
            counts[s] = min(len(records[t]), self.m)
        n = min(len(records[j]), self.m)
        if n == 0:
            return None
        with torch.no_grad():
            ref = self.ref.similarity(slots, counts, emb, n)
        prog = torch.as_tensor(sims, device=dev)
        rows = torch.arange(self.m, device=dev)[None, :] < counts[:, None]
        valid = rows[:, :, None] & (torch.arange(self.m + 1, device=dev)
                                    <= n)[None, None, :]
        if not bool(valid.any()):
            return None
        rel = (prog - ref).abs()[valid] / ref[valid].clamp(min=SIM_FLOOR)
        # a row of a ring slot's detection is never all zero (its unmatched
        # column is a softmax), a row past the slot's count always is
        live = (prog != 0).any(dim=-1)
        return float(rel.mean()), int((live != rows).sum())


def cascade_misses(records: Sequence[Record],
                   cfg: dict) -> Tuple[int, Dict[str, float]]:
    """``id_misses``: the plain cascade run over ``records`` from the
    first, on the detections and similarities recorded, against the tracks
    the program's cascade emitted for each; and the cascade's load, per
    frame: the tracks it holds and the tracks born."""
    cascade = Cascade(cfg["track_buffer"])
    program, reference = [], []
    held = 0
    for rec in records:
        ids, boxes, scores = rec.tracks
        program.append({int(t): (b, float(s))
                        for t, b, s in zip(ids, boxes, scores)})
        reference.append({t: (b, s) for t, b, s in cascade.update(
            rec.boxes, rec.scores, rec.sims, cfg["max_object"])})
        held += len(cascade.tracked) + len(cascade.lost)
    n = max(len(records), 1)
    load = {"tracks_held": held / n, "births": (cascade.next_id - 1) / n}
    return emitted_misses(program, reference, TRACK_BOX_TOL), load


def records_from_reference(judge: TrackJudge, frames: torch.Tensor,
                           order: Sequence[int], n: int,
                           sim_window: int) -> List[Record]:
    """What the frame program and its post-processing would hand the
    cascade, computed by ``judge``'s reference (the control runs a
    lower-precision reference in the program's place): per window frame
    the top-K peaks above the threshold (tracked class only), their boxes
    and tracking offsets in the frame's pixels, and the similarity against
    a ring of its own embeddings."""
    records: List[Record] = []
    ring: List[Tuple[torch.Tensor, int]] = []
    m = judge.m
    for j0 in range(0, n, REF_BATCH):
        js = list(range(j0, min(j0 + REF_BATCH, n)))
        heads, maps = judge.forward(frames[[order[j] for j in js]])
        for i, j in enumerate(js):
            hm = sigmoid_clamped(heads["hm"][i])
            c, h, w = hm.shape
            scores, idx = torch.topk(peaks(hm).reshape(-1), judge.cfg["K"])
            cls = (idx // (h * w) + 1).cpu().numpy()
            ys = ((idx % (h * w)) // w).cpu().numpy()
            xs = (idx % w).cpu().numpy()
            scores = scores.double().cpu().numpy()
            keep = scores >= judge.thr
            if judge.tracked is not None:
                keep &= cls == judge.tracked
            keep = np.flatnonzero(keep)[:m]
            cells = np.stack([xs[keep], ys[keep]], axis=1)
            boxes, tracking = judge.ref_boxes(heads, i, cells)
            nv = len(keep)
            rec = Record(scores[keep].astype(np.float32).astype(np.float64),
                         cls[keep], judge.geom.frame(cells),
                         judge.geom.frame(boxes.reshape(-1, 2)
                                          ).reshape(nv, 4),
                         tracking @ judge.geom.to_frame[:, :2].T, None)
            emb = judge.embed(maps, i, boxes)
            sims = None
            if nv:
                slots = torch.zeros((sim_window, m, emb.shape[-1]),
                                    device=emb.device)
                counts = torch.zeros((sim_window,), dtype=torch.int32,
                                     device=emb.device)
                for s, (e, cnt) in enumerate(ring[:sim_window]):
                    slots[s], counts[s] = e, cnt
                with torch.no_grad():
                    sims = judge.ref.similarity(slots, counts, emb,
                                                nv).cpu().numpy()
                ring.insert(0, (emb, min(nv, m)))
            rec.sims = sims
            records.append(rec)
        del heads, maps
    return records

