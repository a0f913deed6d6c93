"""Online track management, copied from ``deft_tpu/tracking/tracker.py``.

* ``DeviceFeatureRecorder`` keeps the 50-frame embedding window as one
  ``[W, max_object, E]`` tensor on the detector's device, written in place
  (the JAX package writes its ring functionally with ``.at[].set``), and
  evaluates the AFE similarity of the current frame against ALL buffered
  frames in ONE batched call -- against the ring as it was BEFORE the
  frame's own write.  Only the [W, N, N+1] similarity crosses to the host,
  where the temporal decay weighting is applied.

* ``STrack`` / ``Tracker`` reproduce the association cascade host-side
  (appearance -> motion fusion -> second-chance AFE (nuScenes, KITTI) ->
  IoU -> lifecycle) with the Kalman filter or the LSTM motion model.  The
  nuScenes branch (one tracker per class) first matches recent tracks by
  3-D IoU (not for pedestrians), gates motion by the 3-D box centres and
  steps the LSTM once per frame for every updated track, batched
  (``_flush_lstm``).

The tracker never touches the model: embeddings arrive pre-computed and
similarity comes through an injected callable.

``Tracker.spans`` (``utils/spans.py``; ``PipelinedRunner`` sets its own)
times ``update``'s stages (``tracker.predict``, ``tracker.affinity``,
``tracker.assign``, ``tracker.iou``, ``tracker.births``,
``tracker.bookkeeping``) and counts its load per frame: ``dets``,
``matched`` (the 0.9 appearance assignment's pairs), ``births``,
``tracks_held`` (tracked and lost after the update) and ``tracks_removed``
(the length of ``removed_stracks``, which grows for the whole sequence).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deft_tpu_torch.models.factory import resolve_device
from deft_tpu_torch.tracking import matching
from deft_tpu_torch.tracking.basetrack import BaseTrack, IdAllocator, TrackState
from deft_tpu_torch.tracking.kalman import KalmanFilter
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion
from deft_tpu_torch.utils.spans import NO_SPANS

MAX_RECORD_FRAME = 50
DECAY = 1.0
DECAY2 = 0.01
MAX_TRACK_NODE = 50


_EYE4 = np.eye(4)
_EYE4.setflags(write=False)


def freshness_window(dataset: str) -> int:
    """Frames considered 'fresh' for full-strength similarity
    (tracker.py:77-82)."""
    if dataset == "kitti_tracking":
        return 5
    if dataset == "nuscenes":
        return 3
    return 10


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
    (AFE.window_similarity); it is invoked once per frame.  ``device`` is
    the card unless the caller asks for the CPU; without a card, the
    default raises.
    """

    def __init__(self, dataset: str, max_object: int, embed_dim: int,
                 similarity_fn: Callable, window: int = MAX_RECORD_FRAME,
                 device="cuda"):
        self.device = resolve_device(device)
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
        """Record a frame whose window similarity ``sims`` was evaluated
        against the buffer BEFORE this frame, in either layout
        (``deft_tpu/tracking/tracker.py:122-183``):

        * ``[W, M, M+1]`` slot-indexed (the full ring);
        * ``[F < W, M, M+1]`` freshest-first (the frame programs'
          ``sim_window``): row ``rank`` is the rank-th most recently
          buffered frame; buffered frames beyond F rows carry a temporal
          decay <= DECAY2^((F+1)/3) ~ 0 and are recorded as exact zeros.

        Applies the temporal decay weighting (tracker.py:76-90) into ONE
        contiguous slab [P, pre_n_max, n+1] that Tracker.get_similarity
        gathers from, and mirrors the ring bookkeeping (slot = ptr % W,
        non-empty frames only).
        """
        if frame_index in self.slot_of or n == 0:
            return
        m_frame = freshness_window(self.dataset)
        windowed = sims.shape[0] != self.window
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
            k = min(p, sims.shape[0]) if windowed else p
            src = (np.asarray(sims[:k], np.float32) if windowed
                   else np.asarray(sims, np.float32)[slots])
            mask = (np.arange(pre_n_max)[None, :]
                    < slab_pre_ns[:k, None])[:, :, None]
            slab[:k] = (src[:, :pre_n_max, : n + 1]
                        * delta[:k, None, None].astype(np.float32) * mask)
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
    """Single-track state (tracker.py:142-628): a Kalman motion model, or the
    LSTM's features, hidden state and future predictions; the nuScenes path
    adds the 3-D box, depth, class and submission fields."""

    def __init__(self, tlwh, score, node: Node, use_lstm: bool = False,
                 dataset: str = "mot", ddd_bbox=None, depth=None,
                 org_ddd_box=None, classe=None, ddd_submission=None):
        self._tlwh = np.asarray(tlwh, dtype=np.float64)
        self.kalman_filter = None
        # shared read-only placeholder: every consumer ASSIGNS a fresh
        # covariance (KF initiate/update/predict, _empirical_cov)
        self.mean, self.covariance = None, _EYE4
        self.is_activated = False
        self.score = score
        self.tracklet_len = 0
        # only the newest <= mm+1 nodes feed get_similarity
        self.nodes = deque([node], maxlen=8)
        self.dataset = dataset
        self.use_lstm = use_lstm
        self.depth = depth
        self.classe = classe
        self.ddd_bbox = ddd_bbox
        self.org_ddd_box = org_ddd_box
        self.ddd_submission = ddd_submission
        if use_lstm:
            self.hn = np.zeros((1, 128), np.float32)
            self.cn = np.zeros((1, 128), np.float32)
            self.first_time = True
            self.last_frame_id = -1
            self._pending_feat = None   # flushed by Tracker._flush_lstm
            self.future_predictions: Dict[int, np.ndarray] = {}
            self.observations: List[List[float]] = []
            self.observations_tlwh: List[np.ndarray] = [self._tlwh.copy()]
            self.observations_ddd_bboxes: List[np.ndarray] = []

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

    def prediction_at_frame(self, frame_id: int) -> np.ndarray:
        """The LSTM's prediction for ``frame_id`` (its last one beyond
        them): [cx, cy, a, h] in 2-D, [h, w, l, x, y, z, rot] in 3-D."""
        max_fut = 5 if self.dataset == "nuscenes" else 6
        key = frame_id - self.frame_id
        if 1 <= key < max_fut and key in self.future_predictions:
            return self.future_predictions[key]
        return self.future_predictions[max_fut - 1]

    def prediction_at_frame_tlbr(self, frame_id: int) -> np.ndarray:
        ret = self.prediction_at_frame(frame_id).copy()   # [cx, cy, a, h]
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        ret[2:] += ret[:2]
        return ret

    # ---- lifecycle ----------------------------------------------------------

    def activate(self, kalman_filter, frame_id: int, ids: IdAllocator):
        self.track_id = ids.next_id()
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id
        if self.use_lstm:
            self._observe(self._tlwh, self.ddd_bbox)
        else:
            self.kalman_filter = kalman_filter
            self.mean, self.covariance = kalman_filter.initiate(
                self.tlwh_to_xyah(self._tlwh)
            )

    def _take_3d(self, new_track: "STrack"):
        self.depth = new_track.depth
        self.org_ddd_box = new_track.org_ddd_box
        self.ddd_bbox = new_track.ddd_bbox
        self.ddd_submission = new_track.ddd_submission

    def re_activate(self, new_track: "STrack", frame_id: int,
                    kf_result=None):
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        self.nodes.append(new_track.nodes[-1])
        self._take_3d(new_track)
        if self.use_lstm:
            self._observe(new_track.tlwh, new_track.ddd_bbox)
        elif kf_result is not None:
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
        self._take_3d(new_track)
        if self.use_lstm:
            self._observe(new_track.tlwh, new_track.ddd_bbox)
        elif kf_result is not None:
            self.mean, self.covariance = kf_result
        else:
            self.mean, self.covariance = self.kalman_filter.update(
                self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
            )

    # ---- LSTM features (tracker.py:408-580) ----------------------------------

    def _observe(self, tlwh, ddd_box):
        """Record an observation and stage the LSTM's input feature; the
        cell step runs batched over the frame's tracks in
        ``Tracker._flush_lstm``, and nothing reads ``future_predictions``
        before it (the cascade queries only unmatched tracks')."""
        if self.dataset == "nuscenes":
            self.update_lstm_features_ddd(ddd_box)
            self.observations_tlwh.append(np.asarray(tlwh).copy())
        else:
            self.update_lstm_features(tlwh)

    @staticmethod
    def _empirical_cov(obs) -> np.ndarray:
        arr = np.asarray(obs)
        if arr.shape[0] < 2:
            return np.eye(arr.shape[1]) if arr.ndim == 2 else np.eye(4)
        return np.cov(arr.T)

    def _elapsed(self) -> int:
        return max(self.frame_id - self.last_frame_id, 1)

    def update_lstm_features(self, tlwh):
        """The 11-d 2-D feature [cx, cy, dcx, dcy, h, w, w/h, dh, dw, vx, vy]
        in float64, staged as float32."""
        self.observations_tlwh.append(np.asarray(tlwh, np.float64).copy())
        self.observations.append(self.tlwh_to_xyah(tlwh).tolist())
        self.covariance = self._empirical_cov(self.observations)

        box = np.asarray(tlwh, np.float64).copy()
        box[:2] += box[2:] / 2
        c_x, c_y, w, h = box.tolist()
        h_w_ratio = w / h if h != 0 else 0.0
        if self.first_time:
            self.first_time = False
            delta_h = delta_w = v_x = v_y = delta_cx = delta_cy = 0.0
        else:
            dt = self._elapsed()
            delta_h = h - self.last_h
            delta_w = w - self.last_w
            v_x = delta_cx = (c_x - self.last_cx) / dt
            v_y = delta_cy = (c_y - self.last_cy) / dt
        self.last_h, self.last_w = h, w
        self.last_cx, self.last_cy = c_x, c_y
        self.last_frame_id = self.frame_id
        self._pending_feat = np.array(
            [c_x, c_y, delta_cx, delta_cy, h, w, h_w_ratio, delta_h, delta_w,
             v_x, v_y], np.float32)

    def _apply_lstm_deltas(self, deltas: np.ndarray):
        """Deltas [future, 4] ([dcx, dcy, dh, dw]) -> predictions
        [cx, cy, a = w/h, h] per future frame."""
        f = self._pending_feat.astype(np.float64)
        c_x, c_y, h, w = f[0], f[1], f[4], f[5]
        preds = {}
        for i in range(deltas.shape[0]):
            p = deltas[i].astype(np.float64)
            cx_p, cy_p = c_x + p[0], c_y + p[1]
            h_p, w_p = h + p[2], w + p[3]
            preds[i + 1] = np.array(
                [cx_p, cy_p, (w_p / h_p if h_p != 0 else 0.0), h_p])
        self.future_predictions = preds
        self._pending_feat = None

    def update_lstm_features_ddd(self, ddd_box):
        """The 18-d 3-D feature [x, y, z, dx, dy, dz, h, w, l, dh, dw, dl,
        vx, vy, vz, rot, drot, vrot] in float64, staged as float32."""
        ddd_box = np.asarray(ddd_box, np.float64)
        self.observations_ddd_bboxes.append(ddd_box.copy())
        self.covariance = self._empirical_cov(self.observations_ddd_bboxes)

        h, w, l, c_x, c_y, c_z, rot_y = ddd_box.tolist()
        if self.first_time:
            self.first_time = False
            delta_h = delta_w = delta_l = 0.0
            v_x = v_y = v_z = v_rot = 0.0
            delta_cx = delta_cy = delta_cz = delta_rot = 0.0
        else:
            dt = self._elapsed()
            delta_h, delta_w = h - self.last_h, w - self.last_w
            delta_l = l - self.last_l
            v_x = (c_x - self.last_cx) / dt
            v_y = (c_y - self.last_cy) / dt
            v_z = (c_z - self.last_cz) / dt
            v_rot = (rot_y - self.last_rot_y) / dt
            delta_cx, delta_cy, delta_cz = (
                c_x - self.last_cx, c_y - self.last_cy, c_z - self.last_cz)
            delta_rot = rot_y - self.last_rot_y
        self.last_h, self.last_w, self.last_l = h, w, l
        self.last_cx, self.last_cy, self.last_cz = c_x, c_y, c_z
        self.last_rot_y = rot_y
        self.last_frame_id = self.frame_id
        self._pending_feat = np.array(
            [c_x, c_y, c_z, delta_cx, delta_cy, delta_cz, h, w, l, delta_h,
             delta_w, delta_l, v_x, v_y, v_z, rot_y, delta_rot, v_rot],
            np.float32)

    def _apply_lstm_deltas_ddd(self, deltas: np.ndarray):
        """Deltas [future, 4] ([dx, dy, dz, drot]) -> predictions
        [h, w, l, x, y, z, rot] per future frame."""
        f = self._pending_feat.astype(np.float64)
        c_x, c_y, c_z = f[0], f[1], f[2]
        h, w, l = f[6], f[7], f[8]
        rot_y = f[15]
        preds = {}
        for i in range(deltas.shape[0]):
            p = deltas[i].astype(np.float64)
            preds[i + 1] = np.array(
                [h, w, l, c_x + p[0], c_y + p[1], c_z + p[2], rot_y + p[3]])
        self.future_predictions = preds
        self._pending_feat = None

    # ---- geometry -----------------------------------------------------------

    @property
    def tlwh(self) -> np.ndarray:
        if self.use_lstm:
            return self.observations_tlwh[-1].copy()
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
    """Per-sequence online tracker (tracker.py:631-1056).  nuScenes runs one
    per class, each with the LSTM motion model.  Its embedding ring (and the
    LSTM it builds) live on ``device``: the card unless the caller asks for
    the CPU."""

    def __init__(self, dataset: str, max_object: int, embed_dim: int,
                 similarity_fn: Callable, use_lstm: bool = False,
                 motion: Optional[LSTMMotion] = None,
                 frame_rate: int = 10, track_buffer: int = 30,
                 ids: Optional[IdAllocator] = None, device="cuda"):
        if dataset == "nuscenes" and not use_lstm:
            # the 3-D gate measures [h, w, l, x, y, z, rot] boxes, which the
            # Kalman state does not hold (the JAX package fails there too)
            raise ValueError("the nuScenes tracker needs use_lstm=True")
        self.dataset = dataset
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.buffer_size = int(frame_rate / 30.0 * track_buffer)
        self.max_time_lost = self.buffer_size
        self.det_thresh = 0.0
        self.use_lstm = use_lstm
        self.motion = None
        self.kalman_filter = None
        if use_lstm:
            self.motion = (motion if motion is not None
                           else LSTMMotion(dataset, device=device))
        else:
            self.kalman_filter = KalmanFilter()
        self.ids = ids if ids is not None else IdAllocator()
        self.recorder = DeviceFeatureRecorder(
            dataset, max_object, embed_dim, similarity_fn, device=device
        )
        self.spans = NO_SPANS

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
        # median over the newest mm rows when > mm+1 exist
        mm = 2 if self.dataset == "nuscenes" else 4

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

    def update(self, detections_in: List[Dict], embeddings,
               sims: Optional[np.ndarray] = None, ddd_boxes=None, depths=None,
               ddd_org_boxes=None, submission=None,
               classe: Optional[str] = None) -> List[STrack]:
        """One frame.

        detections_in: list of dicts with 'bbox' (tlbr) and 'score';
        embeddings: [n, E] appearance embeddings aligned with detections_in
        (a tensor on any device, or numpy), unused when ``sims`` is given;
        sims: the window similarity a frame program already computed
        (``DeviceFeatureRecorder.ingest`` layouts); the recorder then makes
        no similarity call of its own (tracker.py:677-721).  nuScenes adds
        per detection its [h, w, l, x, y, z, rot] global box, depth, camera
        box and submission fields, and the tracker's ``classe``.
        """
        self.frame_id += 1
        activated: List[STrack] = []
        removed: List[STrack] = []
        output: List[STrack] = []
        ddd = self.dataset == "nuscenes"

        n_det = len(detections_in)
        if n_det > 0:
            nodes = [Node(self.frame_id, i) for i in range(n_det)]
            detections = [
                STrack(STrack.tlbr_to_tlwh(d["bbox"]), d["score"], node,
                       use_lstm=self.use_lstm, dataset=self.dataset)
                for d, node in zip(detections_in, nodes)
            ]
            if ddd:
                for i, det in enumerate(detections):
                    det.ddd_bbox = np.asarray(ddd_boxes[i])
                    det.depth = float(np.ravel(depths[i])[0])
                    det.org_ddd_box = np.asarray(ddd_org_boxes[i])
                    det.classe = classe
                    det.ddd_submission = submission[i]
            if sims is not None:
                self.recorder.ingest(self.frame_id, sims,
                                     min(n_det, self.recorder.max_object))
            else:
                self.recorder.update(self.frame_id, embeddings[:n_det])
        else:
            detections = []

        spans = self.spans
        spans.add("dets", n_det)
        with spans.span("tracker.predict"):
            tracked_stracks = list(self.tracked_stracks)
            strack_pool = joint_stracks(tracked_stracks, self.lost_stracks)
            if not self.use_lstm:
                STrack.multi_predict(
                    [t for t in strack_pool if t.mean is not None],
                    self.kalman_filter)
        lll = n_det
        # the detections the AFE similarity's columns keep
        cols = list(range(n_det))

        # -- nuScenes, not pedestrians: 3-D IoU on recent tracks first -------
        if ddd and classe != "pedestrian":
            pool_old = [t for t in strack_pool
                        if abs(t.frame_id - self.frame_id) >= 3]
            pool_new = [t for t in strack_pool
                        if abs(t.frame_id - self.frame_id) < 3]
            dists = matching.iou_ddd_distance(pool_new, detections)
            matches, u_track, u_detection0 = matching.linear_assignment(
                dists, thresh=0.999)
            for itracked, idet in matches:
                track = pool_new[itracked]
                output.append(track)
                if track.state == TrackState.Tracked:
                    track.update(detections[idet], self.frame_id)
                    activated.append(track)
                else:
                    track.re_activate(detections[idet], self.frame_id)
            cols = list(u_detection0)
            detections = [detections[i] for i in u_detection0]
            strack_pool = joint_stracks([pool_new[i] for i in u_track],
                                        pool_old)

        # -- primary association: AFE similarity + motion fusion --------------
        with spans.span("tracker.affinity"):
            dists = np.zeros((len(strack_pool), len(detections)))
            if dists.size != 0:
                dists = self.get_similarity(self.frame_id, strack_pool, lll)
                dists = 1.0 - dists[:, :-1][:, cols]
            if ddd:
                dists = matching.fuse_motion_ddd(dists, strack_pool,
                                                 detections,
                                                 classe_name=classe)
            else:
                dists = matching.fuse_motion(dists, strack_pool, detections,
                                             frame_id=self.frame_id,
                                             use_lstm=self.use_lstm)
        with spans.span("tracker.assign"):
            matches, u_track, u_detection2 = matching.linear_assignment(
                dists, 0.9)
            spans.add("matched", len(matches))
            self._apply_matches(strack_pool, detections, matches, activated,
                                output)
            r_tracked = [strack_pool[i] for i in u_track]
            detections = [detections[i] for i in u_detection2]

            # -- second-chance AFE-only pass (nuScenes, KITTI) ---------------
            u_track = list(range(len(r_tracked)))
            if self.dataset in ("nuscenes", "kitti_tracking") and detections:
                dists = self.get_similarity(self.frame_id, r_tracked, lll)
                if dists.size != 0:
                    dists = 1.0 - dists[:, :-1][:, cols][:, u_detection2]
                    matches, u_track, u_detection = matching.linear_assignment(
                        dists, 0.9
                    )
                    self._apply_matches(r_tracked, detections, matches,
                                        activated, output)
                    detections = [detections[i] for i in u_detection]
            strack_pool = r_tracked

        # -- IoU association on the remainder ---------------------------------
        with spans.span("tracker.iou"):
            if self.dataset in ("kitti_tracking", "nuscenes"):
                recent = 3 if ddd else 6
                r_tracked = [strack_pool[i] for i in u_track
                             if abs(self.frame_id - strack_pool[i].frame_id)
                             < recent]
            else:
                r_tracked = [strack_pool[i] for i in u_track
                             if strack_pool[i].state == TrackState.Tracked]
            dists = matching.iou_distance(
                r_tracked, detections, self.frame_id,
                use_prediction=self.use_lstm and not ddd)
            matches, u_track, u_detection = matching.linear_assignment(
                dists, 0.0 if ddd else 0.9)
            self._apply_matches(r_tracked, detections, matches, activated,
                                output)

            for it in u_track:
                track = r_tracked[it]
                if self.frame_id - track.frame_id > self.max_time_lost:
                    track.mark_removed()
                    removed.append(track)

        # -- births ------------------------------------------------------------
        with spans.span("tracker.births"):
            detections = [detections[i] for i in u_detection]
            births = 0
            for track in detections:
                output.append(track)
                if track.score < self.det_thresh:
                    continue
                track.activate(self.kalman_filter, self.frame_id, self.ids)
                activated.append(track)
                births += 1
            spans.add("births", births)

        # -- lifecycle bookkeeping (tracker.py:1037-1054) ----------------------
        with spans.span("tracker.bookkeeping"):
            for track in self.lost_stracks:
                if self.frame_id - track.end_frame > self.max_time_lost:
                    track.mark_removed()
                    removed.append(track)

            self.tracked_stracks = [
                t for t in self.tracked_stracks
                if t.state == TrackState.Tracked
            ]
            # the reference's `refind_stracks` list is never appended to; a
            # re-activated track rejoins tracked_stracks one frame later via
            # the Tracked-state branch, as in the JAX package
            self.tracked_stracks = joint_stracks(self.tracked_stracks,
                                                 activated)
            self.lost_stracks = sub_stracks(self.lost_stracks,
                                            self.tracked_stracks)
            self.lost_stracks = sub_stracks(self.lost_stracks,
                                            self.removed_stracks)
            self.removed_stracks.extend(removed)
            self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
                self.tracked_stracks, self.lost_stracks, ddd_tracking=ddd)
        spans.add("tracks_held",
                  len(self.tracked_stracks) + len(self.lost_stracks))
        spans.add("tracks_removed", len(self.removed_stracks))
        if self.use_lstm:
            self._flush_lstm(output)
        return output

    def _flush_lstm(self, tracks: Sequence[STrack]):
        """One batched LSTM step for every track updated this frame
        (tracker.py:872-899): the staged features through
        ``LSTMMotion.predict_batch``, hidden state and future predictions
        back to each track."""
        seen = set()
        pend = []
        for t in tracks:
            if t._pending_feat is not None and id(t) not in seen:
                seen.add(id(t))
                pend.append(t)
        if not pend:
            return
        h = np.concatenate([t.hn for t in pend], axis=0)
        c = np.concatenate([t.cn for t in pend], axis=0)
        feats = np.stack([t._pending_feat for t in pend])
        h2, c2, deltas = self.motion.predict_batch(h, c, feats)
        for i, t in enumerate(pend):
            t.hn = h2[i: i + 1]
            t.cn = c2[i: i + 1]
            if self.dataset == "nuscenes":
                t._apply_lstm_deltas_ddd(deltas[i])
            else:
                t._apply_lstm_deltas(deltas[i])


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


def remove_duplicate_stracks(stracksa, stracksb, ddd_tracking=False):
    if ddd_tracking:
        pdist = matching.iou_ddd_distance(stracksa, stracksb)
    else:
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
