"""The plain association cascade of a 2-D (MOT) track cell, frozen here as
the yardstick of the program's host cascade: the constant-velocity Kalman
filter, the AFE similarity's temporal decay and per-track median, the
Mahalanobis motion fusion, the thresholded linear assignment, the IoU pass,
births and the lifecycle, in float64 numpy as DEFT's tracker
(``src/lib/utils/tracker.py`` of github.com/MedChaabane/DEFT) computes them.

``Cascade.update`` takes one frame's detections (tlbr boxes in the frame's
pixels, scores) and the frame program's similarity against its ring
(``[F, M, M+1]``, freshest ring frame first) and returns the tracks it
emits: (id, tlbr box, score) each.  Ids count from 1 per cascade.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

RING_FRAMES = 50          # the similarity cache's frames (MAX_RECORD_FRAME)
MAX_TRACK_NODE = 50       # a node older than this is not compared
NODES_KEPT = 8            # the newest nodes a track keeps
MEDIAN_ROWS = 4           # a track's median over its newest rows beyond 5
DECAY, DECAY2 = 1.0, 0.01  # the similarity's decay inside and past freshness
FRESH_FRAMES = 10         # MOT's freshness window
MATCH_COST = 0.9          # the assignment's cost limit, both passes
MOTION_WEIGHT = 0.9       # the appearance cost's share in the fused cost
GATE = 5.0 * 5.9915       # 5 x chi2inv95 (2 dof)
DUPLICATE_IOU_COST = 0.15

TRACKED, LOST, REMOVED = 1, 2, 3


# ---- the Kalman filter (x, y, a, h and their velocities) --------------------

STD_POS, STD_VEL = 1.0 / 20, 1.0 / 160
MOTION = np.eye(8)
MOTION[np.arange(4), 4 + np.arange(4)] = 1.0
UPDATE = np.eye(4, 8)


def kf_initiate(xyah: np.ndarray):
    h = xyah[3]
    std = [2 * STD_POS * h, 2 * STD_POS * h, 1e-2, 2 * STD_POS * h,
           10 * STD_VEL * h, 10 * STD_VEL * h, 1e-5, 10 * STD_VEL * h]
    return np.r_[xyah, np.zeros_like(xyah)], np.diag(np.square(std))


def kf_predict(mean: np.ndarray, cov: np.ndarray):
    """[N, 8], [N, 8, 8] -> one step ahead."""
    h = mean[:, 3]
    std = np.stack([STD_POS * h, STD_POS * h, 1e-2 * np.ones_like(h),
                    STD_POS * h, STD_VEL * h, STD_VEL * h,
                    1e-5 * np.ones_like(h), STD_VEL * h], axis=1)
    noise = np.zeros((len(mean), 8, 8))
    idx = np.arange(8)
    noise[:, idx, idx] = np.square(std)
    return mean @ MOTION.T, MOTION @ cov @ MOTION.T + noise


def kf_update(mean: np.ndarray, cov: np.ndarray, xyah: np.ndarray):
    """One track's correction by one measurement."""
    h = mean[3]
    innovation_cov = np.diag(np.square(
        [STD_POS * h, STD_POS * h, 1e-1, STD_POS * h]))
    pmean = UPDATE @ mean
    pcov = UPDATE @ cov @ UPDATE.T + innovation_cov
    pcov = pcov + 1e-8 * np.eye(pcov.shape[0])
    chol = np.linalg.cholesky(pcov)
    z = np.linalg.solve(chol, (cov @ UPDATE.T).T)
    gain = np.linalg.solve(chol.T, z).T
    return (mean + (xyah - pmean) @ gain.T,
            cov - gain @ pcov @ gain.T)


def kf_update_many(mean: np.ndarray, cov: np.ndarray, xyah: np.ndarray):
    """``kf_update`` over N tracks at once, [N, 8], [N, 8, 8], [N, 4]."""
    h = mean[:, 3]
    std = np.stack([STD_POS * h, STD_POS * h, 1e-1 * np.ones_like(h),
                    STD_POS * h], axis=1)
    pmean = mean[:, :4]
    pcov = cov[:, :4, :4].copy()
    idx = np.arange(4)
    pcov[:, idx, idx] += np.square(std) + 1e-8
    chol = np.linalg.cholesky(pcov)
    z = np.linalg.solve(chol, np.transpose(cov[:, :, :4], (0, 2, 1)))
    gain = np.transpose(np.linalg.solve(np.transpose(chol, (0, 2, 1)), z),
                        (0, 2, 1))
    new_mean = mean + np.einsum("nij,nj->ni", gain, xyah - pmean)
    new_cov = cov - np.einsum("nij,njk,nlk->nil", gain, pcov, gain)
    return new_mean, new_cov


def tlwh_to_xyah(tlwh) -> np.ndarray:
    out = np.asarray(tlwh, np.float64).copy()
    out[:2] += out[2:] / 2
    out[2] /= out[3] if out[3] != 0 else 1e-6
    return out


# ---- costs and assignment ---------------------------------------------------

def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] tlbr -> IoU with +1 pixel areas."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def assign(cost: np.ndarray, limit: float):
    """The least-cost matching in which no pair costs over ``limit`` ->
    (matches [K, 2], unmatched rows, unmatched columns): lapjv's
    ``extend_cost``/``cost_limit`` as a private dummy column per row at
    ``limit``, rows or columns with no feasible pair set aside first."""
    cost = np.asarray(cost, dtype=np.float64)
    if cost.size == 0:
        return (np.empty((0, 2), dtype=int), np.arange(cost.shape[0]),
                np.arange(cost.shape[1]))
    feas_r = (cost <= limit).any(axis=1)
    feas_c = (cost <= limit).any(axis=0)
    if not (feas_r.all() and feas_c.all()):
        rows_idx, cols_idx = np.where(feas_r)[0], np.where(feas_c)[0]
        sm, sur, suc = assign(cost[np.ix_(rows_idx, cols_idx)], limit)
        matches = (np.stack([rows_idx[sm[:, 0]], cols_idx[sm[:, 1]]], axis=1)
                   if len(sm) else np.empty((0, 2), dtype=int))
        return (matches,
                np.sort(np.concatenate([np.where(~feas_r)[0],
                                        rows_idx[sur]])).astype(int),
                np.sort(np.concatenate([np.where(~feas_c)[0],
                                        cols_idx[suc]])).astype(int))
    n, m = cost.shape
    transpose = m < n
    if transpose:
        cost = cost.T
        n, m = m, n
    rect = np.full((n, m + n), 1e9)
    rect[:, :m] = np.minimum(np.nan_to_num(cost, nan=1e9, posinf=1e9), 1e9)
    rect[np.arange(n), m + np.arange(n)] = limit
    rows, cols = linear_sum_assignment(rect)
    real = cols < m
    rr, cc = rows[real], cols[real]
    matched_r = np.zeros(n, dtype=bool)
    matched_c = np.zeros(m, dtype=bool)
    matched_r[rr] = True
    matched_c[cc] = True
    matches = np.stack([rr, cc], axis=1).astype(int)
    if transpose:
        matches = matches[:, ::-1]
        matched_r, matched_c = matched_c, matched_r
    return (matches.reshape(-1, 2), np.where(~matched_r)[0],
            np.where(~matched_c)[0])


# ---- tracks -----------------------------------------------------------------

class Track:
    def __init__(self, tlwh, score, frame: int, det: int):
        self.tlwh0 = np.asarray(tlwh, dtype=np.float64)
        self.mean = None
        self.cov = None
        self.score = score
        self.nodes = deque([(frame, det)], maxlen=NODES_KEPT)
        self.state = 0
        self.id = 0
        self.frame = 0
        self.start = 0

    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self.tlwh0.copy()
        out = self.mean[:4].copy()
        out[2] *= out[3]
        out[:2] -= out[2:] / 2
        return out

    def tlbr(self) -> np.ndarray:
        out = self.tlwh()
        out[2:] += out[:2]
        return out


def tlbrs(tracks: Sequence[Track]) -> np.ndarray:
    out = np.empty((len(tracks), 4), np.float64)
    kf = [i for i, t in enumerate(tracks) if t.mean is not None]
    if kf:
        mm = np.stack([tracks[i].mean[:4] for i in kf])
        w, h = mm[:, 2] * mm[:, 3], mm[:, 3]
        x1, y1 = mm[:, 0] - w / 2, mm[:, 1] - h / 2
        out[kf] = np.stack([x1, y1, x1 + w, y1 + h], axis=1)
    for i, t in enumerate(tracks):
        if t.mean is None:
            out[i] = t.tlbr()
    return out


def iou_cost(a: Sequence[Track], b: Sequence[Track]) -> np.ndarray:
    return 1.0 - pairwise_iou(tlbrs(a), tlbrs(b))


def joined(a, b):
    """All of ``a``, then the tracks of ``b`` whose ids ``a`` lacks."""
    seen = {t.id for t in a}
    out = list(a)
    for t in b:
        if t.id not in seen:
            seen.add(t.id)
            out.append(t)
    return out


def without(a, b):
    kept = {t.id: t for t in a}
    for t in b:
        kept.pop(t.id, None)
    return list(kept.values())


class Cascade:
    """One sequence's tracker (Kalman motion, MOT's passes)."""

    def __init__(self, track_buffer: int, frame_rate: int = 10):
        self.tracked: List[Track] = []
        self.lost: List[Track] = []
        self.removed: List[Track] = []
        self.frame = 0
        self.max_lost = int(frame_rate / 30.0 * track_buffer)
        self.next_id = 1
        # the similarity cache: buffered frames oldest first, their
        # detection counts, and the newest frame's decayed table
        self.ring: List[Tuple[int, int]] = []
        self.table = None

    # ---- the similarity ---------------------------------------------------

    def _ingest(self, sims: np.ndarray, n: int):
        """The frame's decayed table [P, max count, n+1] against the
        buffered frames, newest first; then the frame joins the buffer."""
        prev = list(reversed(self.ring))
        p = len(prev)
        width = max((c for _, c in prev), default=0)
        table = np.zeros((p, width, n + 1), np.float32)
        rank = {}
        counts = np.zeros((p,), np.int64)
        if p:
            age = self.frame - np.asarray([f for f, _ in prev], np.int64)
            decay = np.where(age < FRESH_FRAMES, DECAY, DECAY2) ** (age / 3.0)
            counts[:] = [c for _, c in prev]
            k = min(p, sims.shape[0])
            live = (np.arange(width)[None, :] < counts[:k, None])[:, :, None]
            table[:k] = (np.asarray(sims[:k], np.float32)[:, :width, : n + 1]
                         * decay[:k, None, None].astype(np.float32) * live)
            rank = {f: r for r, (f, _) in enumerate(prev)}
        self.table = (self.frame, table, rank, counts)
        if len(self.ring) == RING_FRAMES:
            self.ring.pop(0)
        self.ring.append((self.frame, n))

    def _similarity(self, pool: Sequence[Track], n_det: int) -> np.ndarray:
        """[tracks, n_det + 1]: each track's median over the rows of its
        nodes in the frame's table (all of them up to 5, else the newest
        4)."""
        d = n_det + 1
        out = np.zeros((len(pool), d), np.float32)
        if not pool or self.table is None or self.table[0] != self.frame:
            return out
        _, table, rank, counts = self.table
        t_of, age_of, det_of = [], [], []
        for i, t in enumerate(pool):
            for f, det in t.nodes:
                t_of.append(i)
                age_of.append(self.frame - f)
                det_of.append(det)
        tw = np.asarray(t_of, np.int64)
        df = np.asarray(age_of, np.int64)
        idd = np.asarray(det_of, np.int64)
        rank_of = np.full(MAX_TRACK_NODE, -1, np.int64)
        for f, r in rank.items():
            if 0 < self.frame - f < MAX_TRACK_NODE:
                rank_of[self.frame - f] = r
        j = rank_of[np.clip(df, 0, MAX_TRACK_NODE - 1)]
        ok = (df < MAX_TRACK_NODE) & (df > 0) & (j >= 0)
        ok[ok] &= idd[ok] < counts[j[ok]]
        vi = np.where(ok)[0]
        if vi.size == 0:
            return out
        tv = tw[vi]
        n_all = np.bincount(tv, minlength=len(pool))
        starts = np.cumsum(n_all) - n_all
        rev = n_all[tv] - 1 - (np.arange(vi.size) - starts[tv])
        keep = (n_all[tv] <= MEDIAN_ROWS + 1) | (rev < MEDIAN_ROWS)
        n_rows = np.where(n_all > MEDIAN_ROWS + 1, MEDIAN_ROWS, n_all)
        rmax = int(n_rows.max())
        if rmax == 0:
            return out
        rows = table[j[vi][keep], idd[vi][keep]]
        padded = np.full((len(pool), d, rmax), np.inf, np.float32)
        padded[tv[keep], : table.shape[2], rev[keep]] = rows[:, :d]
        padded.sort(axis=2)
        for r in np.unique(n_rows):
            if r == 0:
                continue
            sel = n_rows == r
            out[sel] = (padded[sel, :, (r - 1) // 2] if r % 2 else
                        (padded[sel, :, r // 2 - 1]
                         + padded[sel, :, r // 2]) / 2.0)
        return out

    # ---- the passes ---------------------------------------------------------

    def _fuse_motion(self, cost, pool, dets):
        if cost.size == 0:
            return cost
        tl = np.stack([d.tlwh() for d in dets]).astype(np.float64)
        meas = tl.copy()
        meas[:, :2] += tl[:, 2:] / 2
        meas[:, 2] /= np.where(tl[:, 3] != 0, tl[:, 3], 1e-6)
        means = np.stack([t.mean[:2] for t in pool])
        covs = np.stack([t.cov[:2, :2] for t in pool])
        a = covs[:, 0, 0] + 1e-8
        b = covs[:, 0, 1]
        c = covs[:, 1, 1] + 1e-8
        det = a * c - b * b
        dx = meas[None, :, 0] - means[:, None, 0]
        dy = meas[None, :, 1] - means[:, None, 1]
        gd = (c[:, None] * dx * dx - 2.0 * b[:, None] * dx * dy
              + a[:, None] * dy * dy) / det[:, None]
        cost[gd > GATE] = np.inf
        return MOTION_WEIGHT * cost + 0.05 * (1 - MOTION_WEIGHT) * gd

    def _match(self, pool, dets, matches, activated, output):
        pairs = [(pool[i], dets[k]) for i, k in matches]
        corrected = {}
        kf_pairs = [(t, d) for t, d in pairs if t.mean is not None]
        if len(kf_pairs) >= 2:
            meas = np.stack([d.tlwh() for _, d in kf_pairs])
            meas[:, :2] += meas[:, 2:] / 2
            hs = meas[:, 3].copy()
            hs[hs == 0] = 1e-6
            meas[:, 2] /= hs
            nm, nc = kf_update_many(np.stack([t.mean for t, _ in kf_pairs]),
                                    np.stack([t.cov for t, _ in kf_pairs]),
                                    meas)
            corrected = {id(t): (nm[i], nc[i])
                         for i, (t, _) in enumerate(kf_pairs)}
        for t, d in pairs:
            output.append(t)
            if t.state == TRACKED:
                t.score = d.score
                activated.append(t)
            t.state = TRACKED
            t.frame = self.frame
            t.nodes.append(d.nodes[-1])
            if id(t) in corrected:
                t.mean, t.cov = corrected[id(t)]
            else:
                t.mean, t.cov = kf_update(t.mean, t.cov,
                                          tlwh_to_xyah(d.tlwh()))

    def update(self, boxes: np.ndarray, scores: np.ndarray,
               sims, max_object: int) -> List[Tuple[int, np.ndarray, float]]:
        """One frame -> the emitted tracks, (id, tlbr, score) each."""
        self.frame += 1
        activated: List[Track] = []
        removed: List[Track] = []
        output: List[Track] = []
        n_det = len(scores)
        dets = []
        for i in range(n_det):
            tlwh = np.asarray(boxes[i], np.float64).copy()
            tlwh[2:] -= tlwh[:2]
            dets.append(Track(tlwh, scores[i], self.frame, i))
        if n_det:
            if sims.shape[0] == RING_FRAMES:
                raise ValueError("the similarity is the frame program's "
                                 "window, freshest ring frame first")
            self._ingest(sims, min(n_det, max_object))

        pool = joined(self.tracked, self.lost)
        movers = [t for t in pool if t.mean is not None]
        if movers:
            mean = np.asarray([t.mean.copy() for t in movers])
            cov = np.asarray([t.cov for t in movers])
            for i, t in enumerate(movers):
                if t.state != TRACKED:
                    mean[i][7] = 0
            mean, cov = kf_predict(mean, cov)
            for t, m, c in zip(movers, mean, cov):
                t.mean, t.cov = m, c

        # appearance and motion
        cost = np.zeros((len(pool), len(dets)))
        if cost.size:
            cost = 1.0 - self._similarity(pool, n_det)[:, :-1]
        cost = self._fuse_motion(cost, pool, dets)
        matches, u_track, u_det = assign(cost, MATCH_COST)
        self._match(pool, dets, matches, activated, output)
        rest = [pool[i] for i in u_track]
        dets = [dets[i] for i in u_det]

        # IoU on the tracked remainder
        rest = [t for t in rest if t.state == TRACKED]
        matches, u_track, u_det = assign(iou_cost(rest, dets), MATCH_COST)
        self._match(rest, dets, matches, activated, output)
        for i in u_track:
            if self.frame - rest[i].frame > self.max_lost:
                rest[i].state = REMOVED
                removed.append(rest[i])

        # births
        for i in u_det:
            t = dets[i]
            output.append(t)
            t.id = self.next_id
            self.next_id += 1
            t.state = TRACKED
            t.frame = t.start = self.frame
            t.mean, t.cov = kf_initiate(tlwh_to_xyah(t.tlwh0))
            activated.append(t)

        for t in self.lost:
            if self.frame - t.frame > self.max_lost:
                t.state = REMOVED
                removed.append(t)
        self.tracked = joined([t for t in self.tracked if t.state == TRACKED],
                              activated)
        self.lost = without(without(self.lost, self.tracked), self.removed)
        self.removed.extend(removed)
        self._drop_duplicates()
        return [(t.id, t.tlbr(), float(t.score)) for t in output]

    def _drop_duplicates(self):
        cost = iou_cost(self.tracked, self.lost)
        drop_a, drop_b = set(), set()
        for p, q in zip(*np.where(cost < DUPLICATE_IOU_COST)):
            a, b = self.tracked[p], self.lost[q]
            if a.frame - a.start > b.frame - b.start:
                drop_b.add(q)
            else:
                drop_a.add(p)
        self.tracked = [t for i, t in enumerate(self.tracked)
                        if i not in drop_a]
        self.lost = [t for i, t in enumerate(self.lost) if i not in drop_b]


def emitted_misses(program: Sequence[Dict[int, Tuple[np.ndarray, float]]],
                   reference: Sequence[Dict[int, Tuple[np.ndarray, float]]],
                   box_tol: float) -> int:
    """Emitted tracks that the two sides do not share, over frames given
    as {id: (tlbr, score)}: ids are paired one to one where a track first
    shows with the same box and score on both sides, and each frame's
    tracks must then agree pair by pair.  Counts, per frame, a track on
    one side with no partner on the other, or whose partner's box or
    score differs."""
    p2r: Dict[int, int] = {}
    r2p: Dict[int, int] = {}
    misses = 0

    def same(x, y):
        return (np.abs(np.asarray(x[0]) - np.asarray(y[0])).max() <= box_tol
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
    return misses
