"""The plain 3-D cascade of the nuScenes rig, frozen here as the yardstick
of the program's per-class trackers: from one camera's post-processed
detections to the tracks the rig emits for that camera, in float64 numpy
(the LSTM in float32 torch, ``lstm_ref.py``).

``route(res, info)`` takes one camera's detections (``ddd_ref.
camera_results``' fields: the frame's boxes, scores, 1-based classes and
the camera-frame 3-D boxes) to the seven tracked classes: a score of at
least 0.3 (0.35 for pedestrians), the global box of ``ddd_ref.global_box``,
and a greedy 2-D NMS per class (IoU 0.7 for buses and trucks, else 0.8).

``RigCascade.step(res, info, sims)`` runs the seven classes' cascades on
one camera, in class order, ids from one counter:

* the similarity table: the frame's similarity against the ring (``sims``
  [class] ``[50, M, n+1]`` by ring slot, as the program's ring computed
  it), each slot's rows live up to the detections it holds, decayed by
  age (1 within 3 updates, else 0.01^(age/3)); a track's similarity is
  the median of its newest nodes' rows (all up to 3, else the newest 2);
* not for pedestrians, a first pass over the tracks updated in the last 3
  updates: cost 1 - 3-D IoU (``iou3d``: the boxes' bird's-eye rectangles
  clipped by this file's own convex intersection, times the overlap of
  their heights), matched at cost 0.999 or less;
* appearance fused with motion: 1 - similarity, set to infinity where the
  detection's global centre lies further from the track's than 0.2 x the
  track's depth (at least 5 m for pedestrians, 10 m otherwise), then 0.9 x
  cost + 0.001 x distance, matched at 0.9; then the similarity alone, at
  0.9, for the tracks and detections left;
* the recent tracks left against the detections left by 2-D IoU (+1 pixel
  areas), matched at cost 0 (identical boxes only);
* births of every detection left; a matched track takes the detection's
  box, 3-D box, depth and (when tracked) score;
* every track born or matched steps the LSTM once (batched per class and
  update): its 18-d feature of the global box, the change since its last
  observation and that change per update elapsed, and its carried state.

The emitted tracks of a camera (id, class, box, score, 3-D box) and every
LSTM step (id, h', deltas) are kept for the comparison.

Where this follows the program rather than DEFT's ``src/lib``: a track
never becomes lost (only removal ends it, and removal reaches only tracks
updated in the last 3 updates, so none is removed: every track stays in
the pool for the sequence); the IoU costs are float32, as the program's
matrices are; the LSTM's predictions feed no cost (the 3-D passes read the
track's last box), so they are checked as the program steps them, not
through the association.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmarks.reference import lstm_ref
from benchmarks.reference.cascade import assign, pairwise_iou
from benchmarks.reference.ddd_ref import global_box

CLASS_NAMES = ("car", "truck", "bus", "trailer", "construction_vehicle",
               "pedestrian", "motorcycle", "bicycle", "traffic_cone",
               "barrier")
TRACKED = ("car", "truck", "bus", "trailer", "pedestrian", "motorcycle",
           "bicycle")
SCORE_CUT, PEDESTRIAN_CUT = 0.3, 0.35
NMS_OVERLAP = {"bus": 0.7, "truck": 0.7}
NMS_DEFAULT, NMS_TOP = 0.8, 200

RING_FRAMES = 50          # the ring's slots
MAX_TRACK_NODE = 50       # a node older than this is not compared
NODES_KEPT = 8
MEDIAN_ROWS = 2           # the newest rows a track's median takes beyond 3
FRESH_FRAMES = 3
DECAY, DECAY2 = 1.0, 0.01
IOU3D_COST, MATCH_COST, IOU_COST = 0.999, 0.9, 0.0
RECENT = 3                # updates within which a track is recent
MAX_LOST = 10             # int(10 / 30 * 30): frame rate 10, buffer 30
MOTION_WEIGHT, MOTION_GAIN, GATE_SHARE = 0.9, 0.001, 0.2
GATE_FLOOR = {"pedestrian": 5.0}
GATE_FLOOR_DEFAULT = 10.0
FEATURES, FUTURE = 18, 4
INSIDE_EPS = 1e-9

TRACKED_STATE, REMOVED = 1, 3


# ---- routing ----------------------------------------------------------------

def nms(boxes: np.ndarray, scores: np.ndarray, overlap: float) -> List[int]:
    """Greedy NMS of tlbr boxes (areas without the +1), best score first,
    dropping boxes whose IoU with a kept one exceeds ``overlap`` -> the
    kept indices, ascending."""
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(scores)[-NMS_TOP:]
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(int(i))
        order = order[:-1]
        if order.size == 0:
            break
        w = np.clip(np.minimum(x2[order], x2[i])
                    - np.maximum(x1[order], x1[i]), 0, None)
        h = np.clip(np.minimum(y2[order], y2[i])
                    - np.maximum(y1[order], y1[i]), 0, None)
        inter = w * h
        union = area[order] + area[i] - inter
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
        order = order[iou <= overlap]
    return sorted(set(keep))


def route(res: Dict[str, np.ndarray], info: dict) -> Dict[str, dict]:
    """One camera's detections -> per tracked class ``rows`` (indices into
    ``res``), ``bbox``, ``score``, ``ddd`` [k, 7] and ``depth``."""
    out = {c: {"rows": [], "ddd": []} for c in TRACKED}
    for i in range(len(res["score"])):
        name = CLASS_NAMES[int(res["cls"][i]) - 1]
        if name not in out:
            continue
        cut = PEDESTRIAN_CUT if name == "pedestrian" else SCORE_CUT
        if res["score"][i] < cut:
            continue
        out[name]["rows"].append(i)
        out[name]["ddd"].append(global_box(res["loc"][i], res["dim"][i],
                                           res["rot_y"][i], info))
    for name, slot in out.items():
        rows = slot["rows"]
        slot["ddd"] = np.asarray(slot["ddd"], np.float64).reshape(-1, 7)
        if rows:
            keep = nms(np.asarray(res["bbox"], np.float64)[rows],
                       np.asarray(res["score"], np.float64)[rows],
                       NMS_OVERLAP.get(name, NMS_DEFAULT))
            slot["rows"] = [rows[k] for k in keep]
            slot["ddd"] = slot["ddd"][keep]
        rows = slot["rows"]
        slot["bbox"] = np.asarray(res["bbox"], np.float64)[rows].reshape(-1,
                                                                          4)
        slot["score"] = [float(res["score"][i]) for i in rows]
        slot["depth"] = [float(res["loc"][i][2]) for i in rows]
    return out


# ---- 3-D IoU ---------------------------------------------------------------

def _rects(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] boxes [h, w, l, x, y, z, yaw] -> [N, 4, 2] bird's-eye
    corners (x, z): the l x w rectangle turned by yaw about the y axis."""
    l, w, yaw = boxes[:, 2:3], boxes[:, 1:2], boxes[:, 6:7]
    xc = np.array([1.0, 1.0, -1.0, -1.0]) * l / 2
    zc = np.array([1.0, -1.0, -1.0, 1.0]) * w / 2
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([c * xc + s * zc + boxes[:, 3:4],
                     -s * xc + c * zc + boxes[:, 5:6]], axis=-1)


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _inside(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """[P, K, 2] points in [P, 4, 2] convex quadrilaterals -> [P, K]
    (edges included)."""
    edge = np.roll(poly, -1, axis=1) - poly                   # [P, 4, 2]
    rel = pts[:, :, None, :] - poly[:, None, :, :]            # [P, K, 4, 2]
    side = _cross(edge[:, None], rel)                         # [P, K, 4]
    return ((side >= -INSIDE_EPS).all(-1) | (side <= INSIDE_EPS).all(-1))


def intersection_area(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Areas of the intersections of convex quadrilaterals [P, 4, 2] and
    [P, 4, 2]: the hull of the corners of each inside the other and of the
    edges' crossings, its points taken in angle about their mean."""
    p = len(a)
    ea = np.roll(a, -1, axis=1) - a                           # [P, 4, 2]
    eb = np.roll(b, -1, axis=1) - b
    r = ea[:, :, None, :]                                     # [P, 4, 1, 2]
    s = eb[:, None, :, :]                                     # [P, 1, 4, 2]
    qp = b[:, None, :, :] - a[:, :, None, :]                  # [P, 4, 4, 2]
    den = _cross(r, s)
    ok = np.abs(den) > 1e-12
    den = np.where(ok, den, 1.0)
    t = _cross(qp, s) / den
    u = _cross(qp, r) / den
    ok &= (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross = (a[:, :, None, :] + t[..., None] * r).reshape(p, 16, 2)
    pts = np.concatenate([a, b, cross], axis=1)               # [P, 24, 2]
    valid = np.concatenate([_inside(a, b), _inside(b, a),
                            ok.reshape(p, 16)], axis=1)
    count = valid.sum(1)
    mean = ((pts * valid[..., None]).sum(1)
            / np.maximum(count, 1)[:, None])
    ang = np.arctan2(pts[..., 1] - mean[:, None, 1],
                     pts[..., 0] - mean[:, None, 0])
    ang = np.where(valid, ang, np.inf)
    order = np.argsort(ang, axis=1)
    pts = np.take_along_axis(pts, order[..., None], axis=1)
    valid = np.take_along_axis(valid, order, axis=1)
    pts = np.where(valid[..., None], pts, pts[:, :1])         # pad: repeat
    nxt = np.roll(pts, -1, axis=1)
    area = 0.5 * np.abs(_cross(pts, nxt).sum(1))
    return np.where(count >= 3, area, 0.0)


def iou3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 7] x [M, 7] boxes -> [N, M] 3-D IoU: the bird's-eye
    intersection times the overlap of the heights [y - h, y], over the
    union of the volumes h w l."""
    a = np.asarray(a, np.float64).reshape(-1, 7)
    b = np.asarray(b, np.float64).reshape(-1, 7)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    ra = np.repeat(_rects(a), m, axis=0)
    rb = np.tile(_rects(b), (n, 1, 1))
    inter = intersection_area(ra, rb).reshape(n, m)
    top = np.minimum(a[:, None, 4], b[None, :, 4])
    bottom = np.maximum(a[:, None, 4] - a[:, None, 0],
                        b[None, :, 4] - b[None, :, 0])
    inter_vol = inter * np.maximum(0.0, top - bottom)
    vol_a = a[:, 0] * a[:, 1] * a[:, 2]
    vol_b = b[:, 0] * b[:, 1] * b[:, 2]
    denom = vol_a[:, None] + vol_b[None, :] - inter_vol
    return np.where(denom > 0, inter_vol / np.where(denom > 0, denom, 1),
                    0.0)


# ---- tracks -----------------------------------------------------------------

class Track:
    def __init__(self, bbox, score, ddd, depth, node):
        self.bbox = np.asarray(bbox, np.float64)
        self.score = score
        self.ddd = np.asarray(ddd, np.float64)
        self.depth = depth
        self.nodes = deque([node], maxlen=NODES_KEPT)
        self.state = 0
        self.id = 0
        self.frame = 0
        self.start = 0
        self.h = np.zeros((1, lstm_ref.HIDDEN), np.float32)
        self.c = np.zeros((1, lstm_ref.HIDDEN), np.float32)
        self.last = None          # (h, w, l, x, y, z, yaw, frame)
        self.feat = None          # staged for the frame's LSTM step

    def observe(self, bbox, ddd):
        """Take a box and stage the LSTM feature of the 3-D one."""
        self.bbox = np.asarray(bbox, np.float64)
        box = np.asarray(ddd, np.float64)
        if self.last is None:
            change = np.zeros(4)
            rate = np.zeros(4)
            size = np.zeros(3)
        else:
            dt = max(self.frame - self.last[7], 1)
            prev = np.asarray(self.last[:7])
            size = box[0:3] - prev[0:3]
            change = np.r_[box[3:6] - prev[3:6], box[6] - prev[6]]
            rate = change / dt
        self.last = tuple(box) + (self.frame,)
        self.feat = np.array([*box[3:6], *change[:3], *box[0:3], *size,
                              *rate[:3], box[6], change[3], rate[3]],
                             np.float32)


def joined(a, b):
    seen = {t.id for t in a}
    return list(a) + [t for t in b if not (t.id in seen or seen.add(t.id))]


class ClassCascade:
    """One tracked class's cascade over the rig's camera updates."""

    def __init__(self, name: str, rig: "RigCascade"):
        self.name = name
        self.rig = rig
        self.tracked: List[Track] = []
        self.frame = 0
        self.ring: List[Tuple[int, int, int]] = []   # (frame, n, slot)
        self.ptr = 0
        self.table = None

    # ---- the similarity ---------------------------------------------------

    def _ingest(self, sims: np.ndarray, n: int):
        """The frame's decayed table [P, max count, n+1] against the
        buffered frames, newest first, from ``sims`` by ring slot; then
        the frame takes the next slot."""
        prev = list(reversed(self.ring))
        p = len(prev)
        width = max((c for _, c, _ in prev), default=0)
        table = np.zeros((p, width, n + 1), np.float32)
        counts = np.array([c for _, c, _ in prev], np.int64)
        if p:
            age = self.frame - np.array([f for f, _, _ in prev], np.int64)
            decay = np.where(age < FRESH_FRAMES, DECAY, DECAY2) ** (age / 3.0)
            slots = np.array([s for _, _, s in prev], np.int64)
            live = (np.arange(width)[None, :] < counts[:, None])[:, :, None]
            table[:] = (np.asarray(sims, np.float32)[slots][:, :width, : n + 1]
                        * decay[:, None, None].astype(np.float32) * live)
        rank = {f: r for r, (f, _, _) in enumerate(prev)}
        self.table = (self.frame, table, rank, counts)
        slot = self.ptr % RING_FRAMES
        if len(self.ring) == RING_FRAMES:
            self.ring.pop(0)
        self.ring.append((self.frame, n, slot))
        self.ptr += 1

    def _similarity(self, pool: Sequence[Track], n_det: int) -> np.ndarray:
        d = n_det + 1
        out = np.zeros((len(pool), d), np.float32)
        if not pool or self.table is None or self.table[0] != self.frame:
            return out
        _, table, rank, counts = self.table
        rows = []
        for i, t in enumerate(pool):
            live = []
            for f, det in t.nodes:
                age = self.frame - f
                r = rank.get(f)
                if 0 < age < MAX_TRACK_NODE and r is not None \
                        and det < counts[r]:
                    live.append(table[r, det, :d])
            if len(live) > MEDIAN_ROWS + 1:
                live = live[-MEDIAN_ROWS:]
            if live:
                rows.append((i, np.median(np.stack(live), axis=0)))
        for i, med in rows:
            out[i, : len(med)] = med
        return out

    # ---- the passes ---------------------------------------------------------

    def _take(self, track: Track, det: Track, output, activated):
        output.append(track)
        if track.state == TRACKED_STATE:
            track.score = det.score
            activated.append(track)
        track.state = TRACKED_STATE
        track.frame = self.frame
        track.nodes.append(det.nodes[-1])
        track.ddd, track.depth = det.ddd, det.depth
        track.observe(det.bbox, det.ddd)

    def _fuse(self, cost: np.ndarray, pool, dets) -> np.ndarray:
        if cost.size == 0:
            return cost
        cost = cost.astype(np.float32)
        meas = np.stack([d.ddd[3:6] for d in dets])
        centres = np.stack([t.ddd[3:6] for t in pool])
        gd = np.sqrt(((meas[None] - centres[:, None]) ** 2).sum(-1))
        floor = GATE_FLOOR.get(self.name, GATE_FLOOR_DEFAULT)
        gate = np.maximum(GATE_SHARE * np.array([t.depth for t in pool]),
                          floor)
        cost[gd > gate[:, None]] = np.inf
        return ((cost * np.float32(MOTION_WEIGHT)).astype(np.float64)
                + MOTION_GAIN * gd).astype(np.float32)

    def update(self, det: dict, sims) -> List[Track]:
        """One camera's detections of the class (``route``'s slot) and the
        program's similarity -> the tracks emitted."""
        self.frame += 1
        frame = self.frame
        n = len(det["score"])
        dets = [Track(det["bbox"][i], det["score"][i], det["ddd"][i],
                      det["depth"][i], (frame, i)) for i in range(n)]
        if n:
            self._ingest(sims, min(n, self.rig.max_object))
        output: List[Track] = []
        activated: List[Track] = []
        pool = list(self.tracked)
        cols = list(range(n))
        if self.name != "pedestrian":
            new = [t for t in pool if abs(t.frame - frame) < RECENT]
            old = [t for t in pool if abs(t.frame - frame) >= RECENT]
            iou = iou3d(np.array([t.ddd for t in new]).reshape(-1, 7),
                        np.array([d.ddd for d in dets]).reshape(-1, 7))
            self.rig.iou_pairs += iou.size
            cost = np.float32(1.0) - iou.astype(np.float32)
            m, u_new, u_det = assign(cost, IOU3D_COST)
            for i, k in m:
                self._take(new[i], dets[k], output, activated)
            cols = list(u_det)
            dets = [dets[k] for k in u_det]
            pool = joined([new[i] for i in u_new], old)

        cost = np.zeros((len(pool), len(dets)))
        if cost.size:
            cost = np.float32(1.0) - self._similarity(pool, n)[:, :-1][:,
                                                                       cols]
        cost = self._fuse(cost, pool, dets)
        m, u_track, u_det2 = assign(cost, MATCH_COST)
        for i, k in m:
            self._take(pool[i], dets[k], output, activated)
        rest = [pool[i] for i in u_track]
        dets = [dets[k] for k in u_det2]

        u_track = list(range(len(rest)))
        if dets:
            sim = self._similarity(rest, n)
            if sim.size:
                cost = np.float32(1.0) - sim[:, :-1][:, cols][:, u_det2]
                m, u_track, u_det = assign(cost, MATCH_COST)
                for i, k in m:
                    self._take(rest[i], dets[k], output, activated)
                dets = [dets[k] for k in u_det]

        recent = [rest[i] for i in u_track
                  if abs(frame - rest[i].frame) < RECENT]
        cost = 1.0 - pairwise_iou(
            np.array([t.bbox for t in recent]).reshape(-1, 4),
            np.array([d.bbox for d in dets]).reshape(-1, 4))
        m, u_track, u_det = assign(cost, IOU_COST)
        for i, k in m:
            self._take(recent[i], dets[k], output, activated)
        for i in u_track:
            if frame - recent[i].frame > MAX_LOST:
                recent[i].state = REMOVED

        for k in u_det:
            t = dets[k]
            output.append(t)
            t.id = self.rig.next_id
            self.rig.next_id += 1
            t.state = TRACKED_STATE
            t.frame = t.start = frame
            t.observe(t.bbox, t.ddd)
            activated.append(t)

        self.tracked = joined([t for t in self.tracked
                               if t.state == TRACKED_STATE], activated)
        self._step_lstm(output)
        return output

    def _step_lstm(self, output: Sequence[Track]):
        seen, pend = set(), []
        for t in output:
            if t.feat is not None and id(t) not in seen:
                seen.add(id(t))
                pend.append(t)
        if not pend:
            return
        rig = self.rig
        dev = rig.device
        h = torch.as_tensor(np.concatenate([t.h for t in pend]), device=dev)
        c = torch.as_tensor(np.concatenate([t.c for t in pend]), device=dev)
        x = torch.as_tensor(np.stack([t.feat for t in pend]), device=dev)
        with torch.no_grad():
            h2, c2, deltas = lstm_ref.step(rig.lstm, h, c, x, rig.quant)
        h2, c2 = h2.cpu().numpy(), c2.cpu().numpy()
        deltas = deltas.cpu().numpy()
        for i, t in enumerate(pend):
            t.h, t.c = h2[i: i + 1], c2[i: i + 1]
            t.feat = None
            rig.lstm_steps[(rig.step_index, t.id)] = (h2[i], deltas[i])


class RigCascade:
    """The seven classes' cascades, one id counter (from 1)."""

    def __init__(self, lstm_sd: Dict[str, torch.Tensor], max_object: int,
                 device="cpu", quant: Optional[Callable] = None):
        self.lstm = lstm_sd
        self.max_object = max_object
        self.device = device
        self.quant = quant
        self.next_id = 1
        self.iou_pairs = 0
        self.step_index = -1
        # (camera step, id) -> (h' [128], deltas [future, 4])
        self.lstm_steps: Dict[Tuple[int, int], tuple] = {}
        self.reset()

    def reset(self):
        """Fresh cascades for a new scene; ids go on from the counter."""
        self.classes = {c: ClassCascade(c, self) for c in TRACKED}

    def step(self, res: Dict[str, np.ndarray], info: dict,
             sims: Dict[str, np.ndarray]) -> List[tuple]:
        """One camera -> its emitted tracks, (id, class, tlbr, score,
        [h, w, l, x, y, z, yaw]) each, in class order."""
        self.step_index += 1
        routed = route(res, info)
        out = []
        for name in TRACKED:
            for t in self.classes[name].update(routed[name],
                                               sims.get(name)):
                out.append((t.id, name, t.bbox.copy(), float(t.score),
                            t.ddd.copy()))
        return out

    def tracks_held(self) -> int:
        return sum(len(c.tracked) for c in self.classes.values())


# ---- comparison -------------------------------------------------------------

def track_vector(tlbr, ddd) -> np.ndarray:
    """A track's box and 3-D box as one vector, the yaw as its sine and
    cosine (a turn of 2 pi is the same box)."""
    ddd = np.asarray(ddd, np.float64)
    return np.r_[np.asarray(tlbr, np.float64), ddd[:6], np.sin(ddd[6]),
                 np.cos(ddd[6])]


def paired_misses(program: Sequence[Dict[int, tuple]],
                  reference: Sequence[Dict[int, tuple]],
                  tol: float) -> Tuple[int, Dict[int, int]]:
    """Emitted tracks that the two sides do not share, over camera steps
    given as {id: (vector, score)}: ids are paired one to one where a track
    first shows with the same vector (within ``tol``) and score on both
    sides, and each step's tracks must then agree pair by pair.  Returns
    the misses and the pairing, program id -> reference id."""
    p2r: Dict[int, int] = {}
    r2p: Dict[int, int] = {}
    misses = 0

    def same(x, y):
        return (np.abs(np.asarray(x[0]) - np.asarray(y[0])).max() <= tol
                and x[1] == y[1])

    for prog, ref in zip(program, reference):
        left = dict(ref)
        for pid, track in prog.items():
            rid = p2r.get(pid)
            if rid is None:
                rid = next((r for r, t in left.items()
                            if r not in r2p and same(track, t)), None)
                if rid is not None:
                    p2r[pid], r2p[rid] = rid, pid
            if rid is None or rid not in left or not same(track, left[rid]):
                misses += 1
            if rid is not None:
                left.pop(rid, None)
        misses += len(left)
    return misses, p2r


def lstm_gap(program: Dict[Tuple[int, int], tuple],
             reference: Dict[Tuple[int, int], tuple], p2r: Dict[int, int],
             floor: float) -> float:
    """The worst LSTM step of the program against the reference's step of
    the paired track at the same camera step: the largest gap of h' and
    the deltas over the reference's largest magnitude (at least
    ``floor``); 1 for a step one side took and the other did not, on a
    paired track."""
    r2p = {r: p for p, r in p2r.items()}
    worst = 0.0
    for (g, pid), (h, d) in program.items():
        rid = p2r.get(pid)
        if rid is None:
            continue
        ref = reference.get((g, rid))
        if ref is None:
            worst = max(worst, 1.0)
            continue
        got = np.r_[np.ravel(h), np.ravel(d)].astype(np.float64)
        want = np.r_[np.ravel(ref[0]), np.ravel(ref[1])].astype(np.float64)
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), floor)))
    for (g, rid) in reference:
        pid = r2p.get(rid)
        if pid is not None and (g, pid) not in program:
            worst = max(worst, 1.0)
    return worst
