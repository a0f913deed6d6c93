"""Online track management, copied from ``deft_tpu/tracking/tracker.py``
(2-D path: MOT and KITTI).

* ``DeviceFeatureRecorder`` keeps the 50-frame embedding window as one
  ``[W, max_object, E]`` tensor on the detector's device, written in place
  (the JAX package writes its ring functionally with ``.at[].set``), and
  evaluates the AFE similarity of the current frame against ALL buffered
  frames in ONE batched call -- against the ring as it was BEFORE the
  frame's own write.  Only the [W, N, N+1] similarity crosses to the host,
  where the temporal decay weighting is applied.

* ``STrack`` / ``Tracker`` reproduce the association cascade host-side
  (appearance -> motion fusion -> second-chance AFE (KITTI) -> IoU ->
  lifecycle) with the Kalman filter.  The LSTM motion model and the
  nuScenes 3-D branches wait for later slices (ROADMAP.md, queue A).

The tracker never touches the model: embeddings arrive pre-computed and
similarity comes through an injected callable.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deft_tpu_torch.tracking import matching
from deft_tpu_torch.tracking.basetrack import BaseTrack, IdAllocator, TrackState
from deft_tpu_torch.tracking.kalman import KalmanFilter

MAX_RECORD_FRAME = 50
DECAY = 1.0
DECAY2 = 0.01
MAX_TRACK_NODE = 50


_EYE4 = np.eye(4)
_EYE4.setflags(write=False)


def freshness_window(dataset: str) -> int:
    """Frames considered 'fresh' for full-strength similarity
    (tracker.py:77-82)."""
    return 5 if dataset == "kitti_tracking" else 10


class Node:
    """Pointer into the recorder: (frame_index, detection index)."""

    __slots__ = ("frame_index", "id")

    def __init__(self, frame_index: int, det_id: int):
        self.frame_index = frame_index
        self.id = det_id


class DeviceFeatureRecorder:
    """Fixed-shape on-device embedding window + host-side similarity cache.

    ``similarity_fn(window_embeds [W,M,E], counts [W], cur [M,E], n_cur)``
    takes tensors on ``device`` and must return a [W, M, M+1] tensor
    (AFE.window_similarity); it is invoked once per frame.
    """

    def __init__(self, dataset: str, max_object: int, embed_dim: int,
                 similarity_fn: Callable, window: int = MAX_RECORD_FRAME,
                 device="cpu"):
        self.device = torch.device(device)
        self.dataset = dataset
        self.window = window
        self.max_object = max_object
        self.embed_dim = embed_dim
        self.similarity_fn = similarity_fn

        self.embeds = torch.zeros((window, max_object, embed_dim),
                                  dtype=torch.float32, device=self.device)
        self.counts = np.zeros((window,), np.int32)
        self.ptr = 0                           # mirrors the device ring pointer
        self.frames: List[int] = []            # buffered frame ids, oldest first
        self.slot_of: Dict[int, int] = {}
        # (frame_index, slab [P, pre_n_max, n+1], {pre_frame: rank}, pre_ns):
        # the newest frame's decayed similarity as ONE contiguous array
        self.slab = None

    def update(self, frame_index: int, features):
        """features: [n, E] (a tensor on any device, or numpy).

        Computes the windowed similarity (one batched device call) against
        the ring BEFORE this frame, ingests it, then writes this frame's
        embeddings into their ring slot in place.
        """
        if frame_index in self.slot_of:
            return
        n = min(int(features.shape[0]), self.max_object)
        if n == 0:
            return

        padded = torch.zeros((self.max_object, self.embed_dim),
                             dtype=torch.float32, device=self.device)
        padded[:n] = torch.as_tensor(features[:n], device=self.device)
        with torch.no_grad():
            sims = self.similarity_fn(
                self.embeds, torch.as_tensor(self.counts, device=self.device),
                padded, n)
        # [W, M, M+1], evaluated against the buffer BEFORE this frame
        sims = sims.cpu().numpy()

        self.ingest(frame_index, sims, n)
        self.embeds[self.slot_of[frame_index]] = padded

    def ingest(self, frame_index: int, sims: np.ndarray, n: int):
        """Record a frame whose slot-indexed window similarity ``sims``
        [W, M, M+1] was evaluated against the buffer BEFORE this frame.

        Applies the temporal decay weighting (tracker.py:76-90) into ONE
        contiguous slab [P, pre_n_max, n+1] that Tracker.get_similarity
        gathers from, and mirrors the ring bookkeeping (slot = ptr % W,
        non-empty frames only).
        """
        m_frame = freshness_window(self.dataset)
        prev = list(reversed(self.frames))      # newest pre-frame first
        p = len(prev)
        pre_n_max = int(self.counts.max()) if p else 0
        slab = np.zeros((p, pre_n_max, n + 1), np.float32)
        slab_f2i: Dict[int, int] = {}
        slab_pre_ns = np.zeros((p,), np.int64)
        if p:
            pf = np.asarray(prev, np.int64)
            dfv = frame_index - pf
            delta = np.where(dfv < m_frame, DECAY, DECAY2) ** (dfv / 3.0)
            slots = np.asarray([self.slot_of[f] for f in prev], np.int64)
            slab_pre_ns[:] = self.counts[slots]
            src = np.asarray(sims, np.float32)[slots]
            mask = (np.arange(pre_n_max)[None, :]
                    < slab_pre_ns[:, None])[:, :, None]
            slab[:] = (src[:, :pre_n_max, : n + 1]
                       * delta[:, None, None].astype(np.float32) * mask)
            slab_f2i = {pre_frame: rank for rank, pre_frame in enumerate(prev)}
        self.slab = (frame_index, slab, slab_f2i, slab_pre_ns)

        # ring write bookkeeping
        slot = self.ptr % self.window
        if len(self.frames) == self.window:
            evict = self.frames.pop(0)
            if self.slot_of.pop(evict) != slot:
                raise RuntimeError("ring bookkeeping out of step")
        self.frames.append(frame_index)
        self.slot_of[frame_index] = slot
        self.counts[slot] = n
        self.ptr += 1


class STrack(BaseTrack):
    """Single-track state with a Kalman motion model (tracker.py:142-628)."""

    def __init__(self, tlwh, score, node: Node):
        self._tlwh = np.asarray(tlwh, dtype=np.float64)
        self.kalman_filter = None
        # shared read-only placeholder: every consumer ASSIGNS a fresh
        # covariance (KF initiate/update/predict)
        self.mean, self.covariance = None, _EYE4
        self.is_activated = False
        self.score = score
        self.tracklet_len = 0
        # only the newest <= mm+1 nodes feed get_similarity
        self.nodes = deque([node], maxlen=8)

    # ---- motion -------------------------------------------------------------

    @staticmethod
    def multi_predict(stracks: Sequence["STrack"], kalman: KalmanFilter):
        if len(stracks) == 0:
            return
        multi_mean = np.asarray([st.mean.copy() for st in stracks])
        multi_cov = np.asarray([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                multi_mean[i][7] = 0
        multi_mean, multi_cov = kalman.multi_predict(multi_mean, multi_cov)
        for st, mean, cov in zip(stracks, multi_mean, multi_cov):
            st.mean = mean
            st.covariance = cov

    # ---- lifecycle ----------------------------------------------------------

    def activate(self, kalman_filter, frame_id: int, ids: IdAllocator):
        self.track_id = ids.next_id()
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id
        self.kalman_filter = kalman_filter
        self.mean, self.covariance = kalman_filter.initiate(
            self.tlwh_to_xyah(self._tlwh)
        )

    def re_activate(self, new_track: "STrack", frame_id: int,
                    kf_result=None):
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        self.nodes.append(new_track.nodes[-1])
        if kf_result is not None:
            self.mean, self.covariance = kf_result
        else:
            self.mean, self.covariance = self.kalman_filter.update(
                self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
            )

    def update(self, new_track: "STrack", frame_id: int, kf_result=None):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.nodes.append(new_track.nodes[-1])
        if kf_result is not None:
            self.mean, self.covariance = kf_result
        else:
            self.mean, self.covariance = self.kalman_filter.update(
                self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
            )

    # ---- geometry -----------------------------------------------------------

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def tlbr(self) -> np.ndarray:
        ret = self.tlwh.copy()
        ret[2:] += ret[:2]
        return ret

    @staticmethod
    def tlwh_to_xyah(tlwh) -> np.ndarray:
        ret = np.asarray(tlwh, np.float64).copy()
        ret[:2] += ret[2:] / 2
        # degenerate zero-height boxes (possible from an untrained detector)
        # get an epsilon height instead of an inf aspect ratio
        ret[2] /= ret[3] if ret[3] != 0 else 1e-6
        return ret

    @staticmethod
    def tlbr_to_tlwh(tlbr) -> np.ndarray:
        ret = np.asarray(tlbr, np.float64).copy()
        ret[2:] -= ret[:2]
        return ret

    def __repr__(self):
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"


class Tracker:
    """Per-sequence online tracker (tracker.py:631-1056), 2-D datasets."""

    def __init__(self, dataset: str, max_object: int, embed_dim: int,
                 similarity_fn: Callable, use_lstm: bool = False,
                 frame_rate: int = 10, track_buffer: int = 30,
                 ids: Optional[IdAllocator] = None, device="cpu"):
        if use_lstm:
            raise NotImplementedError(
                "the LSTM motion model is not ported yet; it comes with the "
                "nuScenes slice (ROADMAP.md, queue A)")
        if dataset == "nuscenes":
            raise NotImplementedError(
                "the nuScenes 3-D tracker is not ported yet (ROADMAP.md, "
                "queue A)")
        self.dataset = dataset
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.buffer_size = int(frame_rate / 30.0 * track_buffer)
        self.max_time_lost = self.buffer_size
        self.det_thresh = 0.0
        self.kalman_filter = KalmanFilter()
        self.ids = ids if ids is not None else IdAllocator()
        self.recorder = DeviceFeatureRecorder(
            dataset, max_object, embed_dim, similarity_fn, device=device
        )

    # -- similarity matrix for a pool of tracks (tracker.py:663-688) ----------

    def get_similarity(self, frame_index: int, strack_pool: Sequence[STrack],
                       num_detections: int) -> np.ndarray:
        """Per-track median similarity (reference tracker.py:219-252 and
        663-688): for each track, its node rows in the current frame's table
        -- all rows when <= mm+1 survive, else the newest mm -- and their
        median, batched across tracks: the frame's slab is gathered once for
        every (track, node) row and the medians run as one sorted
        [T, d, mm+1] array."""
        d = num_detections + 1
        n_trk = len(strack_pool)
        if n_trk == 0:
            return np.zeros((0, d), np.float32)
        out = np.zeros((n_trk, d), np.float32)
        slab_entry = self.recorder.slab
        if slab_entry is None or slab_entry[0] != frame_index:
            return out
        _, slab, f2i, pre_ns = slab_entry
        d_tab = slab.shape[2]
        mm = 4            # median over the newest mm rows when > mm+1 exist

        # (frame-slot, row-id) per track with the keep-newest-mm-of->(mm+1)
        # rule, vectorized: newest-first, drop nodes older than
        # MAX_TRACK_NODE or absent from the table, keep the newest mm when
        # more than mm+1 survive.
        tt_l, tf_l, ti_l = [], [], []
        for i, t in enumerate(strack_pool):
            nd = t.nodes
            tt_l.extend([i] * len(nd))
            for n in nd:                       # oldest -> newest
                tf_l.append(n.frame_index)
                ti_l.append(n.id)
        tw = np.asarray(tt_l, np.int64)
        df = frame_index - np.asarray(tf_l, np.int64)
        idd = np.asarray(ti_l, np.int64)
        # frame -> slab rank lookup by age difference
        rank_of = np.full(MAX_TRACK_NODE, -1, np.int64)
        for pre_frame, rank in f2i.items():
            age = frame_index - pre_frame
            if 0 < age < MAX_TRACK_NODE:
                rank_of[age] = rank
        j = rank_of[np.clip(df, 0, MAX_TRACK_NODE - 1)]
        ok = (df < MAX_TRACK_NODE) & (df > 0) & (j >= 0)
        ok[ok] &= idd[ok] < pre_ns[j[ok]]
        vi = np.where(ok)[0]                   # grouped by track, oldest first
        if vi.size == 0:
            return out
        tv = tw[vi]
        cnt_all = np.bincount(tv, minlength=n_trk)
        starts = np.cumsum(cnt_all) - cnt_all
        rev = cnt_all[tv] - 1 - (np.arange(vi.size) - starts[tv])
        keep = (cnt_all[tv] <= mm + 1) | (rev < mm)
        flat_t = tv[keep]
        flat_f = j[vi][keep]
        flat_r = idd[vi][keep]
        slot = rev[keep]                       # distinct per track, < mm+1
        counts = np.where(cnt_all > mm + 1, mm, cnt_all)
        rmax = int(counts.max())
        if rmax == 0:
            return out

        rows = slab[flat_f, flat_r]                           # [K, d_tab]

        # columns beyond the recorder's table width stay +inf, matching the
        # padded-fill behavior when num_detections > max_object; layout
        # [T, d, rmax] so the median's sort axis is contiguous
        padded = np.full((n_trk, d, rmax), np.inf, np.float32)
        padded[flat_t, :d_tab, slot] = rows[:, :d]
        padded.sort(axis=2)
        for r in np.unique(counts):
            if r == 0:
                continue
            sel = counts == r
            if r % 2:
                med = padded[sel, :, (r - 1) // 2]
            else:
                med = (padded[sel, :, r // 2 - 1]
                       + padded[sel, :, r // 2]) / 2.0
            out[sel] = med
        return out

    # -- the cascade -----------------------------------------------------------

    def _apply_matches(self, pool, detections, matches, activated, output):
        """Apply one association stage's matches: batched Kalman correction
        (KalmanFilter.multi_update) + the per-track lifecycle bookkeeping."""
        pairs = [(pool[it], detections[idet]) for it, idet in matches]
        results = {}
        kf_pairs = [(t, d) for t, d in pairs if t.mean is not None]
        if len(kf_pairs) >= 2:
            means = np.stack([t.mean for t, _ in kf_pairs])
            covs = np.stack([t.covariance for t, _ in kf_pairs])
            meas = np.stack([d.tlwh for _, d in kf_pairs])
            meas[:, :2] += meas[:, 2:] / 2
            hs = meas[:, 3].copy()
            hs[hs == 0] = 1e-6
            meas[:, 2] /= hs
            nm, nc = self.kalman_filter.multi_update(means, covs, meas)
            results = {id(t): (nm[i], nc[i])
                       for i, (t, _) in enumerate(kf_pairs)}
        for track, det in pairs:
            output.append(track)
            pre = results.get(id(track))
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id, kf_result=pre)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, kf_result=pre)

    def update(self, detections_in: List[Dict], embeddings) -> List[STrack]:
        """One frame.

        detections_in: list of dicts with 'bbox' (tlbr) and 'score';
        embeddings: [n, E] appearance embeddings aligned with detections_in
        (a tensor on any device, or numpy).
        """
        self.frame_id += 1
        activated: List[STrack] = []
        removed: List[STrack] = []
        output: List[STrack] = []

        n_det = len(detections_in)
        if n_det > 0:
            nodes = [Node(self.frame_id, i) for i in range(n_det)]
            detections = [
                STrack(STrack.tlbr_to_tlwh(d["bbox"]), d["score"], node)
                for d, node in zip(detections_in, nodes)
            ]
            self.recorder.update(self.frame_id, embeddings[:n_det])
        else:
            detections = []

        tracked_stracks = list(self.tracked_stracks)
        strack_pool = joint_stracks(tracked_stracks, self.lost_stracks)
        STrack.multi_predict(
            [t for t in strack_pool if t.mean is not None], self.kalman_filter
        )
        lll = n_det

        # -- primary association: AFE similarity + motion fusion --------------
        dists = np.zeros((len(strack_pool), len(detections)))
        if dists.size != 0:
            dists = self.get_similarity(self.frame_id, strack_pool, lll)
            dists = 1.0 - dists[:, :-1]
        dists = matching.fuse_motion(dists, strack_pool, detections)
        matches, u_track, u_detection2 = matching.linear_assignment(dists, 0.9)
        self._apply_matches(strack_pool, detections, matches, activated,
                            output)
        r_tracked = [strack_pool[i] for i in u_track]
        detections = [detections[i] for i in u_detection2]

        # -- second-chance AFE-only pass (KITTI) -------------------------------
        if self.dataset == "kitti_tracking" and len(detections) > 0:
            dists = self.get_similarity(self.frame_id, r_tracked, lll)
            if dists.size != 0:
                dists = 1.0 - dists[:, :-1][:, u_detection2]
                matches, u_track, u_detection = matching.linear_assignment(
                    dists, 0.9
                )
                self._apply_matches(r_tracked, detections, matches,
                                    activated, output)
                detections = [detections[i] for i in u_detection]
            else:
                u_track = list(range(len(r_tracked)))
        else:
            u_track = list(range(len(r_tracked)))
        strack_pool = r_tracked

        # -- IoU association on the remainder ---------------------------------
        if self.dataset == "kitti_tracking":
            r_tracked = [strack_pool[i] for i in u_track
                         if abs(self.frame_id - strack_pool[i].frame_id) < 6]
        else:
            r_tracked = [strack_pool[i] for i in u_track
                         if strack_pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, detections)
        matches, u_track, u_detection = matching.linear_assignment(dists, 0.9)
        self._apply_matches(r_tracked, detections, matches, activated,
                            output)

        for it in u_track:
            track = r_tracked[it]
            if self.frame_id - track.frame_id > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        # -- births ------------------------------------------------------------
        detections = [detections[i] for i in u_detection]
        for track in detections:
            output.append(track)
            if track.score < self.det_thresh:
                continue
            track.activate(self.kalman_filter, self.frame_id, self.ids)
            activated.append(track)

        # -- lifecycle bookkeeping (tracker.py:1037-1054) ----------------------
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [
            t for t in self.tracked_stracks if t.state == TrackState.Tracked
        ]
        # the reference's `refind_stracks` list is never appended to; a
        # re-activated track rejoins tracked_stracks one frame later via the
        # Tracked-state branch, as in the JAX package
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.removed_stracks.extend(removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks)
        return output


def stacked_tlbrs(tracks) -> np.ndarray:
    """[N, 4] tlbr for a track pool in one vectorized pass."""
    n = len(tracks)
    out = np.empty((n, 4), np.float64)
    kf_idx = [i for i, t in enumerate(tracks) if t.mean is not None]
    if kf_idx:
        mm = np.stack([tracks[i].mean[:4] for i in kf_idx])
        w = mm[:, 2] * mm[:, 3]
        h = mm[:, 3]
        x1 = mm[:, 0] - w / 2
        y1 = mm[:, 1] - h / 2
        out[kf_idx] = np.stack([x1, y1, x1 + w, y1 + h], axis=1)
    for i, t in enumerate(tracks):
        if t.mean is None:
            out[i] = t.tlbr
    return out


def joint_stracks(tlista, tlistb):
    exists = {}
    res = []
    for t in tlista:
        exists[t.track_id] = 1
        res.append(t)
    for t in tlistb:
        if not exists.get(t.track_id, 0):
            exists[t.track_id] = 1
            res.append(t)
    return res


def sub_stracks(tlista, tlistb):
    stracks = {t.track_id: t for t in tlista}
    for t in tlistb:
        stracks.pop(t.track_id, None)
    return list(stracks.values())


def remove_duplicate_stracks(stracksa, stracksb):
    pdist = matching.iou_distance(stracksa, stracksb)
    pairs = np.where(pdist < 0.15)
    dupa, dupb = [], []
    for p, q in zip(*pairs):
        timep = stracksa[p].frame_id - stracksa[p].start_frame
        timeq = stracksb[q].frame_id - stracksb[q].start_frame
        if timep > timeq:
            dupb.append(q)
        else:
            dupa.append(p)
    resa = [t for i, t in enumerate(stracksa) if i not in dupa]
    resb = [t for i, t in enumerate(stracksb) if i not in dupb]
    return resa, resb
