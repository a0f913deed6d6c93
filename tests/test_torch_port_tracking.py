"""The PyTorch port's tracker vs the JAX package's, frame by frame.

The same detections, embeddings and similarity function go into
``deft_tpu.tracking.tracker.Tracker`` and ``deft_tpu_torch``'s ``Tracker``
for 24 frames of a synthetic scene with births, a long loss (removal), short
losses (re-finds) and crossing objects.  The similarity is a numpy function
of the ring contents, so it also checks that both rings hold the same
embeddings in the same slots.
"""

import numpy as np
import pytest
import torch

from deft_tpu.tracking.tracker import Tracker as JaxTracker
from deft_tpu_torch.tracking.tracker import Tracker

M, E = 8, 16
FRAMES = 24


def similarity(window, counts, cur, n):
    """[W, M, E], [W], [M, E], n -> [W, M, M+1]: a softmax over cosine
    similarities with an 'unmatched' column, zero outside the valid rows."""
    w = window / np.maximum(np.linalg.norm(window, axis=-1, keepdims=True), 1e-6)
    c = cur / np.maximum(np.linalg.norm(cur, axis=-1, keepdims=True), 1e-6)
    cos = np.einsum("wie,je->wij", w, c)[:, :, :n]
    logits = np.concatenate([6.0 * cos, np.full(cos.shape[:2] + (1,), 1.0)],
                            axis=-1)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.zeros(window.shape[:2] + (M + 1,), np.float32)
    out[:, :, : n + 1] = p
    out *= (np.arange(M)[None, :] < counts[:, None])[..., None]
    return out


def scene(seed):
    """Per frame: (detections, embeddings).  Six objects with their own
    appearance vectors and constant velocities; object 2 is born at frame
    5, object 3 vanishes for frames 8-10 (re-found), object 4 leaves at
    frame 6 for good, object 5 is born at frame 12 and objects 0 and 1
    cross."""
    rng = np.random.RandomState(seed)
    app = rng.randn(6, E)
    start = np.array([[10, 10], [200, 20], [50, 150], [120, 90], [30, 200],
                      [160, 160]], np.float64)
    vel = np.array([[6, 1], [-6, 1], [2, -3], [0, 2], [3, 0], [-2, -2]],
                   np.float64)
    size = np.array([[30, 60], [28, 56], [40, 80], [25, 50], [35, 70],
                     [30, 60]], np.float64)
    alive = np.ones((FRAMES, 6), bool)
    alive[:5, 2] = False
    alive[8:11, 3] = False
    alive[6:, 4] = False
    alive[:12, 5] = False
    frames = []
    for f in range(FRAMES):
        dets, embs = [], []
        for o in range(6):
            if not alive[f, o]:
                continue
            xy = start[o] + vel[o] * f + rng.randn(2) * 0.5
            dets.append({"bbox": np.concatenate([xy, xy + size[o]]),
                         "score": float(0.5 + 0.4 * rng.rand())})
            embs.append(app[o] + 0.1 * rng.randn(E))
        frames.append((dets, np.asarray(embs, np.float32).reshape(-1, E)))
    return frames


def _state(trackers_lists):
    return [[(t.track_id, t.state) for t in lst] for lst in trackers_lists]


@pytest.mark.parametrize("dataset", ["mot", "kitti_tracking"])
def test_tracker_matches_jax(dataset):
    jt = JaxTracker(dataset, M, E, similarity_fn=lambda w, c, e, n: similarity(
        np.asarray(w), np.asarray(c), np.asarray(e), int(n)))
    pt = Tracker(dataset, M, E, device="cpu",
                 similarity_fn=lambda w, c, e, n: torch.from_numpy(similarity(
                     w.numpy(), c.numpy(), e.numpy(), int(n))))
    removed_seen = refound = False
    for f, (dets, embs) in enumerate(scene(7)):
        j_out = jt.update([dict(d) for d in dets], embs)
        p_out = pt.update([dict(d) for d in dets], torch.from_numpy(embs))
        assert [t.track_id for t in p_out] == [t.track_id for t in j_out], f
        assert _state([p_out, pt.tracked_stracks, pt.lost_stracks,
                       pt.removed_stracks]) == _state(
            [j_out, jt.tracked_stracks, jt.lost_stracks, jt.removed_stracks]), f
        for a, b in zip(p_out, j_out):
            np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=1e-6,
                                       err_msg=f"frame {f}")
        np.testing.assert_array_equal(pt.recorder.embeds.numpy(),
                                      np.asarray(jt.recorder.embeds))
        np.testing.assert_array_equal(pt.recorder.counts, jt.recorder.counts)
        removed_seen |= len(pt.removed_stracks) > 0
        # a track matched again after frames without a detection
        refound |= any(len(t.nodes) > 1
                       and t.nodes[-1].frame_index - t.nodes[-2].frame_index > 1
                       for t in p_out)
    assert refound
    # KITTI's IoU stage skips tracks unmatched for 6+ frames, so only the
    # MOT cascade ever removes one
    assert removed_seen == (dataset == "mot")
    assert len({t.track_id for t in pt.tracked_stracks}) >= 4


def test_lstm_and_nuscenes_wait_for_later_slices():
    with pytest.raises(NotImplementedError):
        Tracker("mot", M, E, similarity_fn=None, use_lstm=True)
    with pytest.raises(NotImplementedError):
        Tracker("nuscenes", M, E, similarity_fn=None)
