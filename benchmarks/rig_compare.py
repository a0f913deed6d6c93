"""Whether a rig window's outputs are right: the program against the float32
reference on the same frames and weights, and its trackers against the
plain 3-D cascade.

What the timed path hands on is recorded for every camera of every sample
of the window (``CameraRecord``: the decode's peaks as the post-processing
took them, the detections it made of them, each class tracker's
similarity against its ring, the tracks emitted); besides, every batched
LSTM step (each track's h' and deltas) and every 3-D IoU matrix.  After
the window, blocks of consecutive samples drawn from the seed are worked
out again by the reference (``reference/deft_ref.py``, ``ddd_ref.py``),
every camera at once, and these numbers taken, each the worst over the
cameras compared:

* ``score_gap``, ``box_gap``, ``missed`` (and ``missed_frame``): as in the
  track cells (``compare.py``): the score against the reference's heatmap
  at the detection's own cell; the box and the tracking offset, in output
  cells; the share of the reference's peaks due with no detection of their
  class near, due here from ``MISS_MARGIN`` above the tracker's cut (the
  decode returns its K peaks from 0.1 on a busy camera, whose last ranks
  swap on rounding; the peaks the trackers take lie well inside them);
* ``dep_gap``: the depth's gap over the reference's depth;
* ``dim_gap``: the 3-D size's, in metres;
* ``rot_gap``: the camera yaw's, in radians (a turn of 2 pi is none);
* ``loc_gap``: the global centre's, over the reference's depth: the
  program's camera-frame box and the reference's, each taken to the
  global frame by the reference's geometry with the camera's own records
  (a gap in metres grows with the depth, which ``1 / sigmoid - 1`` makes
  large where the logit is low);
* ``sim_rel``: per class update, the mean relative gap of the similarity
  rows of the ring slots that hold updates of the same block, against the
  reference's similarity of its own embeddings (at its own boxes' centres
  of the program's detections), the worst update;
* ``ring_misses`` (every update of the window): ring rows live where the
  plain ring rule (the class's updates with detections, one slot each in
  turn, 50 slots, emptied where a new scene starts) puts no detection, or dead where it puts one, and
  updates whose detection count is not the plain routing's (exact);
* ``id_misses`` (every camera of the window): emitted tracks on which the
  program and the plain 3-D cascade (``reference/cascade3d.py``), run from
  the window's first camera on the program's detections and similarities,
  afresh (ids going on) at each camera that starts a new scene, disagree in id, box, 3-D box or score (exact);
* ``lstm_rel``: the program's LSTM steps against the plain cascade's steps
  of the paired tracks, the largest gap of h' and the deltas over the
  reference's largest magnitude (at least ``LSTM_FLOOR``): the steps take
  the cascade's own features and carried state, so a state the program
  drops between samples shows; and the state (h, c) every paired track
  holds after the window's last sample against the cascade's, which shows
  a dropped state on the tracks that sample did not step, where a scene
  with few matches across samples has few steps that would;
* ``iou3d_gap``: the program's 3-D IoU matrices against ``cascade3d.
  iou3d`` on the same boxes, largest absolute gap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Collection, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmarks.compare import MISS_CELLS, MISS_MARGIN, SIM_FLOOR, TrackJudge
from benchmarks.reference import cascade3d, ddd_ref
from benchmarks.reference.cascade3d import (RING_FRAMES, RigCascade,
                                            paired_misses, track_vector)

LSTM_FLOOR = 1e-3       # the least magnitude ``lstm_rel`` divides by
DUE_SCORE = cascade3d.SCORE_CUT + MISS_MARGIN   # a reference peak is due
TRACK_TOL = 1e-3        # pixels and metres: an emitted track on both sides


@dataclass
class CameraRecord:
    """One camera of one sample as the program handed it on: the peaks
    ``cells`` [n, 2] (x, y), ``cls`` [n] (0-based), ``score``, ``bbox``
    [n, 4] and ``tracking`` [n, 2] in output cells, and the detections
    made of them (``res``: ``ddd_ref.camera_results``' fields ``score``,
    ``cls`` (1-based), ``bbox`` in pixels, ``loc``, ``dim``, ``rot_y``,
    ``dep``); per class the tracker's (n, similarity [50, M, n+1] by ring
    slot); the tracks emitted, {id: (``track_vector``, score)}."""
    cells: np.ndarray
    cls: np.ndarray
    score: np.ndarray
    bbox: np.ndarray
    tracking: Optional[np.ndarray]
    res: Dict[str, np.ndarray]
    updates: Dict[str, Tuple[int, np.ndarray]] = field(default_factory=dict)
    emitted: Dict[int, tuple] = field(default_factory=dict)

    @classmethod
    def of(cls, dets: Dict[str, np.ndarray], results: List[dict]):
        """From the decode's [1, K, ...] arrays and the post-processed
        detection dicts the program made of their first n."""
        n = len(results)

        def first(key, width):
            return np.asarray(dets[key][0][:n], np.float64).reshape(n, width)

        def of_results(key, width):
            return np.array([np.ravel(d[key]) for d in results],
                            np.float64).reshape(n, width)

        res = {"score": of_results("score", 1)[:, 0],
               "cls": np.array([d["class"] for d in results], np.int64),
               "bbox": of_results("bbox", 4), "loc": of_results("loc", 3),
               "dim": of_results("dim", 3), "rot_y": of_results("rot_y", 1)[:,
                                                                            0],
               "dep": of_results("dep", 1)[:, 0]}
        return cls(np.rint(first("cts", 2)).astype(np.int64),
                   first("clses", 1)[:, 0].astype(np.int64),
                   first("scores", 1)[:, 0], first("bboxes", 4),
                   first("tracking", 2) if "tracking" in dets else None, res)

    def __len__(self):
        return len(self.score)


def emitted_of(tracks) -> Dict[int, tuple]:
    """The program's emitted tracks of a camera as ``CameraRecord.emitted``
    holds them."""
    return {int(t.track_id): (track_vector(t.tlbr, t.ddd_bbox),
                              float(t.score)) for t in tracks}


def choose_blocks(n_done: int, length: int, count: int,
                  seed: int) -> List[Tuple[int, int]]:
    """``count`` blocks of ``length`` consecutive window samples among the
    first ``n_done`` drawn from the seed (one block of all of them when
    there are too few)."""
    if n_done <= length:
        return [(0, n_done)]
    rng = np.random.default_rng(int(seed) + 1)
    starts = sorted(rng.choice(n_done - length + 1,
                               size=min(count, n_done - length + 1),
                               replace=False))
    return [(int(a), int(a) + length) for a in starts]


def class_updates(records: Sequence[CameraRecord], infos: Sequence[dict],
                  starts: Collection[int] = ()) -> Dict[str, List[tuple]]:
    """Per class, the window's updates with detections in order: (camera
    index, the plain routing's rows, the program's n and similarity, the
    ring slot the plain rule gives it, the slots before it: {slot: (camera
    index, rows)}); the rings start empty at the cameras ``starts``."""
    out = {c: [] for c in cascade3d.TRACKED}
    ring = {c: [] for c in cascade3d.TRACKED}
    ptr = {c: 0 for c in cascade3d.TRACKED}
    for g, (rec, info) in enumerate(zip(records, infos)):
        if g in starts:
            ring = {c: [] for c in cascade3d.TRACKED}
            ptr = {c: 0 for c in cascade3d.TRACKED}
        routed = cascade3d.route(rec.res, info)
        for c in cascade3d.TRACKED:
            rows = routed[c]["rows"]
            n_prog, sims = rec.updates.get(c, (0, None))
            if not rows and not n_prog:
                continue
            before = {slot: (g2, rows2) for g2, rows2, slot in ring[c]}
            slot = ptr[c] % RING_FRAMES
            out[c].append((g, rows, n_prog, sims, slot, before))
            if rows:
                ring[c] = [e for e in ring[c] if e[2] != slot]
                ring[c].append((g, rows, slot))
                ptr[c] += 1
    return out


def embed_all(track: TrackJudge, maps, i: int,
              boxes: np.ndarray) -> torch.Tensor:
    """[n, E] embeddings of frame i at the centres of all its boxes [n, 4]
    in output cells (the rig samples every peak; its trackers take the
    rows of their detections)."""
    dev = maps[0].device
    c = 0.5 * (boxes[:, 0:2] + boxes[:, 2:4])
    c = np.stack([2.0 * c[:, 0] / track.geom.out_w - 1.0,
                  2.0 * c[:, 1] / track.geom.out_h - 1.0], axis=1)
    centers = torch.as_tensor(c, dtype=torch.float32,
                              device=dev).reshape(1, -1, 2)
    return track.ref.embed([fm[i: i + 1] for fm in maps], centers)[0]


class RigJudge:
    """The reference side of a rig cell's comparison."""

    def __init__(self, track: TrackJudge, cameras: int):
        self.track = track
        self.ref = track.ref
        self.geom = track.geom
        self.m = track.m
        self.cameras = cameras

    def judge(self, frames: torch.Tensor, order: Sequence[int],
              records: Sequence[CameraRecord], infos: Sequence[dict],
              blocks: Sequence[Tuple[int, int]],
              starts: Collection[int] = ()) -> Dict[str, float]:
        """The numbers of the module docstring over ``blocks`` of window
        samples; ``order[j]`` is window sample j's index in ``frames``
        ([S, C, H, W, 3]), ``records`` and ``infos`` per camera of the
        window's samples in turn, ``starts`` the cameras that start a new
        scene."""
        c = self.cameras
        out = {k: 0.0 for k in ("score_gap", "box_gap", "dep_gap", "dim_gap",
                                "rot_gap", "loc_gap", "missed",
                                "missed_frame", "sim_rel")}
        out.update({"ring_misses": 0, "frames": 0, "detections": 0,
                    "due": 0, "due_missed": 0, "sim_updates": 0})
        embs: Dict[int, torch.Tensor] = {}
        for a, b in blocks:
            for j in range(a, b):
                heads, maps = self.track.forward(frames[order[j]])
                for k in range(c):
                    g = j * c + k
                    gaps, boxes = self._camera(heads, k, records[g],
                                               infos[g])
                    for key, v in gaps.items():
                        if key in ("due", "due_missed"):
                            out[key] += v
                        else:
                            out[key] = max(out[key], v)
                    if gaps["due"]:
                        out["missed_frame"] = max(
                            out["missed_frame"],
                            gaps["due_missed"] / gaps["due"])
                    out["frames"] += 1
                    out["detections"] += len(records[g])
                    embs[g] = embed_all(self.track, maps, k, boxes)
                del heads, maps
        if out["due"]:
            out["missed"] = out["due_missed"] / out["due"]
        inside = {g for a, b in blocks for g in range(a * c, b * c)}
        for updates in class_updates(records, infos, starts).values():
            for g, rows, n_prog, sims, slot, before in updates:
                if n_prog != min(len(rows), self.m):
                    out["ring_misses"] += 1
                    continue
                counts = np.zeros(RING_FRAMES, np.int64)
                for s, (_, rows2) in before.items():
                    counts[s] = min(len(rows2), self.m)
                live = (sims != 0).any(-1)                     # [W, M]
                want = np.arange(live.shape[1])[None] < counts[:, None]
                out["ring_misses"] += int((live != want).sum())
                if g not in inside:
                    continue
                rel = self._sims(g, rows, sims, before, embs)
                if rel is not None:
                    out["sim_rel"] = max(out["sim_rel"], rel)
                    out["sim_updates"] += 1
        return out

    def _camera(self, heads, k: int, rec: CameraRecord, info: dict):
        """One camera's gaps, and the reference's boxes at its detections
        (output cells)."""
        one = {h: v[k] for h, v in heads.items()}
        due = self._due(ddd_ref.sigmoid_clamped(one["hm"]))
        gaps = {"due": len(due), "due_missed": len(due)}
        if len(rec) == 0:
            return gaps, np.zeros((0, 4))
        if len(due):
            near = ((due[:, None, 0] == rec.cls[None, :] + 1)
                    & (np.abs(due[:, None, 1:] - rec.cells[None]).max(-1)
                       <= MISS_CELLS)).any(axis=1)
            gaps["due_missed"] = int((~near).sum())
        ref = ddd_ref.at_cells(one, rec.cls, rec.cells)
        gaps["score_gap"] = float(np.abs(rec.score - ref["score"]).max())
        box = np.abs(rec.bbox - ref["bbox"]).max()
        if rec.tracking is not None:
            box = max(box, np.abs(rec.tracking - ref["tracking"]).max())
        gaps["box_gap"] = float(box)
        res = ddd_ref.camera_results(ref, self.geom.to_frame,
                                     np.asarray(info["calib"]))
        prog = rec.res
        gaps["dep_gap"] = float((np.abs(prog["dep"] - res["dep"])
                                 / np.abs(res["dep"])).max())
        gaps["dim_gap"] = float(np.abs(prog["dim"] - res["dim"]).max())
        turn = np.abs(prog["rot_y"] - res["rot_y"]) % (2 * np.pi)
        gaps["rot_gap"] = float(np.minimum(turn, 2 * np.pi - turn).max())
        centres = [np.linalg.norm(
            ddd_ref.global_box(prog["loc"][i], prog["dim"][i],
                               prog["rot_y"][i], info)[3:6]
            - ddd_ref.global_box(res["loc"][i], res["dim"][i],
                                 res["rot_y"][i], info)[3:6])
            / abs(res["dep"][i]) for i in range(len(rec))]
        gaps["loc_gap"] = float(max(centres))
        return gaps, ref["bbox"]

    def _due(self, hm: torch.Tensor) -> np.ndarray:
        """[n, 3] (class, x, y) of the reference's top-K peaks of one
        sigmoided [C, h, w] heatmap that score ``DUE_SCORE`` or more."""
        c, h, w = hm.shape
        scores, idx = torch.topk(ddd_ref.peaks(hm).reshape(-1),
                                 self.track.cfg["K"])
        idx = idx[scores >= DUE_SCORE].cpu().numpy()
        return np.stack([idx // (h * w) + 1, idx % w,
                         (idx % (h * w)) // w], axis=1)

    def _sims(self, g: int, rows, sims: np.ndarray, before,
              embs) -> Optional[float]:
        """The mean relative gap of update g's similarity rows of the slots
        whose updates the reference embedded, or None where it has none."""
        slots = [s for s, (g2, _) in before.items() if g2 in embs]
        if not slots:
            return None
        m = self.m
        emb = embs[g]
        dev = emb.device

        def rows_of(g2, rows2):
            out = torch.zeros((m, emb.shape[-1]), device=dev)
            n = min(len(rows2), m)
            out[:n] = embs[g2][torch.as_tensor(rows2[:n], device=dev)]
            return out

        ring = torch.zeros((RING_FRAMES, m, emb.shape[-1]), device=dev)
        counts = torch.zeros((RING_FRAMES,), dtype=torch.int32, device=dev)
        for s in slots:
            g2, rows2 = before[s]
            ring[s] = rows_of(g2, rows2)
            counts[s] = min(len(rows2), m)
        n = min(len(rows), m)
        with torch.no_grad():
            ref = self.ref.similarity(ring, counts, rows_of(g, rows), n)
        ref = ref[:, :, : n + 1].double().cpu().numpy()
        prog = np.asarray(sims, np.float64)[:, :, : n + 1]
        valid = np.zeros(prog.shape, bool)
        for s in slots:
            valid[s, : int(counts[s])] = True
        rel = np.abs(prog - ref)[valid] / np.maximum(ref[valid], SIM_FLOOR)
        return float(rel.mean())


def cascade_check(records: Sequence[CameraRecord], infos: Sequence[dict],
                  lstm_steps: Dict[Tuple[int, int], tuple], lstm_sd,
                  max_object: int, quant=None,
                  held: Optional[Dict[int, tuple]] = None,
                  starts: Collection[int] = ()
                  ) -> Tuple[int, float, Dict[str, float]]:
    """(``id_misses``, ``lstm_rel``, the cascade's load per camera: the
    tracks it holds and the tracks born): the plain cascade over
    ``records`` from the first on the program's detections and
    similarities, against the tracks the program emitted and the LSTM steps
    it took (``lstm_steps``: (camera index, id) -> (h', deltas)), and the
    LSTM state it holds after the last record (``held``: id -> (h, c)),
    which ``lstm_rel`` takes too; the cascade starts afresh, its ids going
    on, at the cameras ``starts``."""
    rig = RigCascade(lstm_sd, max_object, quant=quant)
    program, reference = [], []
    held_n = 0
    for g, (rec, info) in enumerate(zip(records, infos)):
        if g in starts:
            rig.reset()
        sims = {c: s for c, (_, s) in rec.updates.items()}
        program.append(rec.emitted)
        reference.append({t: (track_vector(box, ddd), s)
                          for t, _, box, s, ddd in rig.step(rec.res, info,
                                                            sims)})
        held_n += rig.tracks_held()
    misses, p2r = paired_misses(program, reference, TRACK_TOL)
    steps = {k: v for k, v in lstm_steps.items() if k[0] < len(records)}
    rel = cascade3d.lstm_gap(steps, rig.lstm_steps, p2r, LSTM_FLOOR)
    if held is not None:
        rel = max(rel, state_gap(held, rig, p2r))
    n = max(len(records), 1)
    load = {"tracks_held": held_n / n, "births": (rig.next_id - 1) / n,
            "iou3d_pairs": rig.iou_pairs / n}
    return misses, rel, load


def state_gap(held: Dict[int, tuple], rig: RigCascade,
              p2r: Dict[int, int]) -> float:
    """The LSTM state the program's tracks carry (``held``: id -> (h, c))
    against the plain cascade's of the paired tracks it holds, the largest
    gap over the reference's largest magnitude (at least ``LSTM_FLOOR``):
    a state the program does not carry between samples shows on every
    track the last sample did not step."""
    ref = {t.id: t for c in rig.classes.values() for t in c.tracked}
    worst = 0.0
    for pid, (h, c) in held.items():
        t = ref.get(p2r.get(pid))
        if t is None:
            continue
        got = np.r_[np.ravel(h), np.ravel(c)].astype(np.float64)
        want = np.r_[np.ravel(t.h), np.ravel(t.c)].astype(np.float64)
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), LSTM_FLOOR)))
    return worst


def iou3d_gap(calls: Sequence[tuple]) -> float:
    """The program's 3-D IoU matrices (a boxes, b boxes, matrix) against
    the plain ones."""
    worst = 0.0
    for a, b, got in calls:
        want = cascade3d.iou3d(a, b)
        worst = max(worst, float(np.abs(np.asarray(got, np.float64)
                                        - want).max()))
    return worst
