"""The nuScenes slice of the port against the JAX package, on the CPU.

Geometry (quaternions, camera -> global boxes, unprojection, NMS, 3-D IoU)
to 1e-9 in float64; the 3-D decode and post-process on random head maps;
the LSTM step with carried weights; the per-class 3-D tracker with the LSTM
on scripted frames; ``Detector.run_multi`` on synthetic nuScenes scenes
(``tools/make_synthetic_nuscenes.py``, two cameras, and the port's own
six-camera rig) and the submission.  Inputs come from seeded numpy.
``run_multi`` against the JAX package's is in
``test_torch_port_nuscenes_run_multi.py`` (this file's fixtures and
helpers, a worker of its own).
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import nuscenes_config as jax_nuscenes_config
from deft_tpu.inference import ddd as jddd
from deft_tpu.inference import geometry as jgeo
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.post_process import generic_post_process as j_post
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu.ops import iou as jiou
from deft_tpu.ops.decode import generic_decode as j_decode
from deft_tpu.tracking.basetrack import IdAllocator as JaxIds
from deft_tpu.tracking.motion_lstm import LSTMMotion as JaxMotion
from deft_tpu.tracking.tracker import Tracker as JaxTracker
from deft_tpu_torch.config import nuscenes_config
from deft_tpu_torch.convert import from_jax_motion_variables, from_jax_variables
from deft_tpu_torch.data.synthetic_nuscenes import make_scene
from deft_tpu_torch.inference import ddd, geometry
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.post_process import generic_post_process
from deft_tpu_torch.ops import iou
from deft_tpu_torch.ops.decode import generic_decode
from deft_tpu_torch.track import (nuscenes_submission, sample_major,
                                  track_nuscenes, tracks_to_results)
from deft_tpu_torch.tracking import motion_lstm
from deft_tpu_torch.tracking.basetrack import IdAllocator
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion
from deft_tpu_torch.tracking.tracker import Tracker

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

GEO_TOL = 1e-9         # float64 geometry, absolute
DDD_TOL = 1e-5         # loc / rot_y / dim from float32 head maps
LSTM_TOL = 1e-5
BOX_TOL = 1e-3         # pixels, as the slice tests
SCORE_TOL = 1e-4
E = 704                # nuScenes embedding width


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's models: the suite runs several
    test processes on one machine, and each one's default of a thread per
    core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rand_quat(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


# ---- geometry --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_box_to_global(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        args = (rng.randn(3) * 10, rng.uniform(0.3, 5, 3), rng.uniform(-3, 3),
                rand_quat(rng), rng.randn(3), rand_quat(rng), rng.randn(3) * 50)
        a = geometry.camera_box_to_global(*args)
        b = jgeo.camera_box_to_global(*args)
        np.testing.assert_allclose(a.center, b.center, rtol=0, atol=GEO_TOL)
        np.testing.assert_allclose(a.orientation.q, b.orientation.q, rtol=0,
                                   atol=GEO_TOL)
        np.testing.assert_allclose(a.wlh, b.wlh, rtol=0, atol=0)


def test_quaternion():
    rng = np.random.RandomState(3)
    for _ in range(20):
        qa, qb = rand_quat(rng), rand_quat(rng)
        axis, angle = rng.randn(3), rng.uniform(-3, 3)
        v = rng.randn(3)
        pairs = [(geometry.Quaternion(qa), jgeo.Quaternion(qa)),
                 (geometry.Quaternion(axis=axis, angle=angle),
                  jgeo.Quaternion(axis=axis, angle=angle))]
        prod = (geometry.Quaternion(qa) * geometry.Quaternion(qb),
                jgeo.Quaternion(qa) * jgeo.Quaternion(qb))
        for p, j in pairs + [prod]:
            np.testing.assert_allclose(p.q, j.q, rtol=0, atol=GEO_TOL)
            np.testing.assert_allclose(p.rotate(v), j.rotate(v), rtol=0,
                                       atol=GEO_TOL)
            assert abs(p.angle - j.angle) <= GEO_TOL
            np.testing.assert_allclose(p.axis, j.axis, rtol=0, atol=GEO_TOL)


def test_ddd2locrot_and_alpha():
    rng = np.random.RandomState(4)
    calib = np.array([[1266.0, 0, 816.0, 0.5], [0, 1266.0, 491.0, -0.2],
                      [0, 0, 1, 0.01]])
    rot = rng.randn(50, 8)
    np.testing.assert_allclose(ddd.get_alpha(rot), jddd.get_alpha(rot),
                               rtol=0, atol=GEO_TOL)
    for alpha in rng.uniform(-np.pi, np.pi, 20):
        ct = rng.uniform(0, 1600, 2)
        dim = rng.uniform(0.5, 5, 3)
        dep = rng.uniform(1, 60)
        loc, rot_y = ddd.ddd2locrot(ct, alpha, dim, dep, calib)
        j_loc, j_rot_y = jddd.ddd2locrot(ct, alpha, dim, dep, calib)
        np.testing.assert_array_equal(loc, j_loc)
        assert abs(rot_y - j_rot_y) <= GEO_TOL


@pytest.mark.parametrize("overlap", [0.5, 0.7, 0.8])
def test_nms_greedy(overlap):
    rng = np.random.RandomState(5)
    # 20 boxes, each with two jittered copies
    xy = np.repeat(rng.uniform(0, 200, (20, 2)), 3, axis=0)
    wh = np.repeat(rng.uniform(20, 60, (20, 2)), 3, axis=0)
    xy += rng.normal(0, 2, xy.shape)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    scores = rng.rand(60)
    keep, n = ddd.nms_greedy(boxes, scores, overlap=overlap)
    j_keep, j_n = jddd.nms_greedy(boxes, scores, overlap=overlap)
    assert n == j_n and 0 < n < 60
    np.testing.assert_array_equal(keep, j_keep)


def test_pairwise_iou3d():
    rng = np.random.RandomState(6)
    a = np.concatenate([rng.uniform(0.5, 3, (12, 3)),
                        rng.uniform(-4, 4, (12, 3)),
                        rng.uniform(-3, 3, (12, 1))], axis=1)
    b = a + rng.normal(0, 0.5, a.shape)
    b[:3] = a[:3]                     # identical boxes: IoU 1
    got = iou.pairwise_iou3d(a, b)
    np.testing.assert_allclose(got, jiou.pairwise_iou3d(a, b), rtol=0,
                               atol=GEO_TOL)
    assert (got > 0).sum() > 12 and np.allclose(np.diag(got)[:3], 1.0)


# ---- 3-D decode + post-process ---------------------------------------------

def test_decode_and_post_process_3d():
    """Random head maps through the JAX decode + post-process and the
    port's: the same detections, ``loc``, ``rot_y`` and ``dim`` within
    1e-5."""
    rng = np.random.RandomState(7)
    b, h, w = 2, 24, 40
    cfg = nuscenes_config(input_h=4 * h, input_w=4 * w)
    maps = {head: rng.randn(b, h, w, c).astype(np.float32)
            for head, c in cfg.heads.items()}
    maps["hm"] = rng.uniform(0.01, 0.99, maps["hm"].shape).astype(np.float32)
    maps["dep"] = rng.uniform(2.0, 60.0, maps["dep"].shape).astype(np.float32)
    maps["dim"] = rng.uniform(0.4, 5.0, maps["dim"].shape).astype(np.float32)
    j = {k: np.asarray(v) for k, v in j_decode(
        {k: jnp.asarray(v) for k, v in maps.items()}, k=40).items()}
    p = {k: v.numpy() for k, v in generic_decode(
        {k: torch.from_numpy(v) for k, v in maps.items()}, k=40).items()}
    assert set(j) == set(p)
    calibs = [np.array([[300.0, 0, 80, 0], [0, 300.0, 48, 0], [0, 0, 1, 0]],
                       np.float32)] * b
    centers = [np.array([320.0, 180.0], np.float32)] * b
    scales = [640.0] * b
    j_res = j_post(j, centers, scales, h, w, 0.3, calibs)
    p_res = generic_post_process(p, centers, scales, h, w, 0.3, calibs)
    assert [len(r) for r in p_res] == [len(r) for r in j_res]
    assert min(len(r) for r in p_res) >= 10
    for pr, jr in zip(p_res, j_res):
        for a, c in zip(pr, jr):
            assert a["class"] == c["class"]
            for key in ("loc", "dim", "bbox", "ct", "nuscenes_att",
                        "velocity"):
                np.testing.assert_allclose(a[key], c[key], rtol=0,
                                           atol=DDD_TOL, err_msg=key)
            assert abs(a["rot_y"] - c["rot_y"]) <= DDD_TOL
            assert abs(a["alpha"] - c["alpha"]) <= DDD_TOL


# ---- the LSTM motion model -------------------------------------------------

@pytest.mark.parametrize("dataset", ["nuscenes", "mot"])
@pytest.mark.parametrize("n", [1, 5, 33])
def test_lstm_step_matches_jax(dataset, n):
    jm = JaxMotion(dataset, seed=n)
    pm = LSTMMotion(dataset, from_jax_motion_variables(
        jax.tree.map(np.asarray, jm.variables)), device="cpu")
    rng = np.random.RandomState(n)
    f = 18 if dataset == "nuscenes" else 11
    h = rng.randn(n, 128).astype(np.float32)
    c = rng.randn(n, 128).astype(np.float32)
    x = (rng.randn(n, f) * 5).astype(np.float32)
    for a, b in zip(pm.predict_batch(h, c, x), jm.predict_batch(h, c, x)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LSTM_TOL)
    _, _, preds = pm.predict(h[:1], c[:1], x[:1])
    _, _, j_preds = jm.predict(h[:1], c[:1], x[:1])
    assert sorted(preds) == sorted(j_preds) == list(range(1, pm.max_dis_fut + 1))
    for k in preds:
        np.testing.assert_allclose(preds[k], j_preds[k], rtol=0, atol=LSTM_TOL)


def test_lstm_converter_rejects_unknown_leaves():
    v = jax.tree.map(np.asarray, JaxMotion("nuscenes").variables)
    v["params"]["extra"] = {"kernel": np.zeros(3)}
    with pytest.raises(ValueError):
        from_jax_motion_variables(v)


def test_lstm_counts_batches():
    pm = LSTMMotion("nuscenes", device="cpu")
    before = (motion_lstm.BATCHES, motion_lstm.ROWS)
    pm.predict_batch(np.zeros((7, 128)), np.zeros((7, 128)), np.zeros((7, 18)))
    assert (motion_lstm.BATCHES, motion_lstm.ROWS) == (before[0] + 1,
                                                       before[1] + 7)


# ---- the per-class 3-D tracker with the LSTM ---------------------------------

def np_similarity(window, counts, cur, n_cur):
    """The JAX package's ``mock_similarity`` of tests/test_tracking_3d.py
    in numpy: exp(-|a - b|^2) with a 0.05 'unmatched' column."""
    w, m, _ = window.shape
    d2 = ((window[:, :, None, :] - cur[None, None]) ** 2).sum(-1)
    ids = np.arange(m)
    valid = (ids[None, :, None] < counts[:, None, None]) & (ids[None, None, :]
                                                            < n_cur)
    sim = np.exp(-d2) * valid
    col = np.arange(m + 1)[None, None, :]
    real = np.concatenate([sim, np.zeros((w, m, 1))], axis=-1)
    return np.where(col < n_cur, real, np.where(col == n_cur, 0.05, 0.0)
                    ).astype(np.float32)


def jax_similarity(window, counts, cur, n_cur):
    return jnp.asarray(np_similarity(np.asarray(window), np.asarray(counts),
                                     np.asarray(cur), int(n_cur)))


def torch_similarity(window, counts, cur, n_cur):
    return torch.from_numpy(np_similarity(window.numpy(), counts.numpy(),
                                          cur.numpy(), int(n_cur)))


def embedding(i, rng=None):
    e = np.zeros(E, np.float32)
    e[i % E] = 3.0
    if rng is not None:
        e += rng.normal(0, 0.02, E).astype(np.float32)
    return e


def frame_3d(ids, t, rng, jump=()):
    """Objects moving in the global frame: image boxes, embeddings and the
    3-D fields ``_update_nuscenes`` passes the trackers."""
    dets, embs, ddd_b, depths, orgs, subs = [], [], [], [], [], []
    for i in ids:
        x2d = 100.0 + 8 * t + 150 * i + rng.normal(0, 1)
        dets.append({"bbox": np.array([x2d, 100.0, x2d + 60, 160.0]),
                     "score": 0.8 - 0.01 * i})
        embs.append(embedding(i, rng))
        gx = 10.0 * i + 1.0 * t + rng.normal(0, 0.05) + (100 if i in jump else 0)
        gy = 5.0 * i + rng.normal(0, 0.05)
        ddd_b.append([1.5, 1.8, 4.2, gx, gy, 0.0, 0.1 * i])
        depths.append([20.0 + 5 * i])
        orgs.append([1.5, 1.8, 4.2, gx, gy, 20.0 + 5 * i, 0.1 * i])
        subs.append([gx, gy, 0.0, 1.8, 4.2, 1.5, 1, 0, 0, 0])
    emb = np.stack(embs) if embs else np.zeros((0, E), np.float32)
    return dets, emb, dict(ddd_boxes=ddd_b, depths=depths, ddd_org_boxes=orgs,
                           submission=subs)


def tracker_pair(dataset="nuscenes", shared=False):
    jm = JaxMotion(dataset, seed=1)
    pm = LSTMMotion(dataset, from_jax_motion_variables(
        jax.tree.map(np.asarray, jm.variables)), device="cpu")
    j_ids, p_ids = JaxIds(), IdAllocator()
    n = 2 if shared else 1
    jt = [JaxTracker(dataset, 8, E, jax_similarity, use_lstm=True, motion=jm,
                     ids=j_ids) for _ in range(n)]
    pt = [Tracker(dataset, 8, E, torch_similarity, use_lstm=True, motion=pm,
                  ids=p_ids, device="cpu") for _ in range(n)]
    return jt, pt


def check_same(p_out, j_out):
    assert [t.track_id for t in p_out] == [t.track_id for t in j_out]
    for a, b in zip(p_out, j_out):
        np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(a.hn, b.hn, rtol=0, atol=LSTM_TOL)
        np.testing.assert_allclose(a.cn, b.cn, rtol=0, atol=LSTM_TOL)
        assert sorted(a.future_predictions) == sorted(b.future_predictions)
        for k in a.future_predictions:
            np.testing.assert_allclose(a.future_predictions[k],
                                       b.future_predictions[k], rtol=0,
                                       atol=LSTM_TOL)


# scripted scenes: per frame the live object ids (and teleported ones)
SCENES = {
    "steady": [([0, 1], ())] * 6,
    "birth_and_loss": [([0], ()), ([0, 1], ()), ([0, 1, 2], ()), ([1, 2], ()),
                       ([1, 2], ()), ([0, 1, 2], ()), ([0, 2], ())],
    "teleport": [([0, 1], ())] * 3 + [([0, 1], (1,))] * 3,
}


@pytest.mark.parametrize("classe", ["car", "pedestrian"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tracker_3d_matches_jax(scene, classe):
    """Identical ids, boxes, hidden states and future predictions frame by
    frame; pedestrians skip the 3-D IoU pre-step."""
    (jt,), (pt,) = tracker_pair()
    rng_j, rng_p = np.random.RandomState(8), np.random.RandomState(8)
    n_ids = set()
    for t, (ids, jump) in enumerate(SCENES[scene]):
        d, e, kw = frame_3d(ids, t, rng_j, jump)
        j_out = jt.update(d, e, classe=classe, **kw)
        d, e, kw = frame_3d(ids, t, rng_p, jump)
        p_out = pt.update(d, e, classe=classe, **kw)
        check_same(p_out, j_out)
        n_ids.update(x.track_id for x in p_out)
    # the teleported object fails the motion gate but keeps its id through
    # the second, appearance-only pass; object 0, unseen for two
    # frames, is born again (the similarity to frames 3 or more back decays
    # 100-fold)
    assert len(n_ids) == {"steady": 2, "teleport": 2, "birth_and_loss": 4}[
        scene]


def test_per_class_trackers_share_ids():
    """Two class trackers on one ``IdAllocator``: the same global ids as
    the JAX package's, and the batched LSTM flush in each."""
    jts, pts = tracker_pair(shared=True)
    rng_j, rng_p = np.random.RandomState(9), np.random.RandomState(9)
    before = motion_lstm.BATCHES
    for t in range(4):
        for (jt, pt), classe in zip(zip(jts, pts), ("car", "pedestrian")):
            d, e, kw = frame_3d([0, 1], t, rng_j)
            j_out = jt.update(d, e, classe=classe, **kw)
            d, e, kw = frame_3d([0, 1], t, rng_p)
            p_out = pt.update(d, e, classe=classe, **kw)
            check_same(p_out, j_out)
    assert motion_lstm.BATCHES - before == 8
    ids = [t.track_id for tr in pts for t in tr.tracked_stracks]
    assert len(ids) == len(set(ids)) == 4


def test_tracker_2d_lstm_matches_jax():
    """The 2-D LSTM path (11-d features, predictions in the IoU stage)."""
    (jt,), (pt,) = tracker_pair("mot")
    rng_j, rng_p = np.random.RandomState(10), np.random.RandomState(10)
    for t, (ids, _) in enumerate(SCENES["birth_and_loss"]):
        d, e, _ = frame_3d(ids, t, rng_j)
        j_out = jt.update(d, e)
        d, e, _ = frame_3d(ids, t, rng_p)
        p_out = pt.update(d, e)
        check_same(p_out, j_out)


def test_nuscenes_tracker_needs_lstm():
    with pytest.raises(ValueError):
        Tracker("nuscenes", 8, E, torch_similarity, use_lstm=False,
                device="cpu")


# ---- Detector.run_multi against the JAX package's ----------------------------

SIZE = dict(input_h=96, input_w=160, dla_node="dcn", dcn_impl="hybrid",
            K=24, max_object=16, dcn_offset_range=1)
N_SAMPLES = 4


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


@pytest.fixture(scope="module")
def nus_scene(tmp_path_factory):
    """The synthetic scene of tools/make_synthetic_nuscenes.py (two cameras)
    as (image info, frame) pairs."""
    import cv2
    from convert_nuscenes import convert
    from make_synthetic_nuscenes import generate

    root = str(tmp_path_factory.mktemp("nus") / "nuscenes")
    generate(root, n_samples=N_SAMPLES, width=800, height=450)
    convert(root, "v1.0-trainval", "val.json")
    with open(os.path.join(root, "annotations", "val.json")) as f:
        infos = json.load(f)["images"]
    # noise on the flat background: no plateaus of tied heatmap peaks
    rng = np.random.RandomState(12)
    frames = []
    for info in infos:
        img = cv2.imread(os.path.join(root, "v1.0-trainval",
                                      info["file_name"])).astype(np.int16)
        img += rng.randint(-20, 20, img.shape).astype(np.int16)
        frames.append((info, np.clip(img, 0, 255).astype(np.uint8)))
    return root, sample_major(frames)


@pytest.fixture(scope="module")
def detectors(nus_scene):
    """JAX and port detectors with the same weights: seeded, offsets
    randomized, the dim and dep heads' biases at plausible sizes (1.6, 1.9,
    4.5 m) and depth (~20 m), the heatmap rescaled so ~1% of the first
    frame's pixels score above 0.5 in every class."""
    cfg = jax_nuscenes_config(**SIZE)
    model = jax_create_model(cfg.arch, cfg)
    params, stats = jax_init_model(model, cfg)
    variables = jax.tree.map(np.array, {"params": params,
                                        "batch_stats": stats})
    rng = np.random.RandomState(11)
    for path, v in list(_leaves(variables["params"])):
        if "conv_offset_mask" in path:
            _set(variables["params"], path,
                 (rng.normal(0, 0.01, v.shape) if path[-1] == "kernel"
                  else rng.uniform(-1.0, 1.0, v.shape)).astype(np.float32))
    heads = variables["params"]
    heads["head_dim"]["out"]["bias"] = np.array([1.6, 1.9, 4.5], np.float32)
    heads["head_dep"]["out"]["bias"] = np.array([-3.0], np.float32)
    jdet = JaxDetector(cfg, model=model, variables=variables)
    info, frame = nus_scene[1][0]
    images, _ = jdet.pre_process(frame, 1.0, {"calib": info["calib"]})
    out, _ = model.apply(variables, jnp.asarray(images))
    z = np.asarray(out["hm"])
    gain = 2.0 / z.std()
    hm = heads["head_hm"]["out"]
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = ((hm["bias"] - np.percentile(z.reshape(-1, z.shape[-1]), 99,
                                              axis=0)) * gain).astype(np.float32)
    jm = JaxMotion("nuscenes", seed=2)
    jdet = JaxDetector(cfg, model=model, variables=variables, motion=jm)
    motion_sd = from_jax_motion_variables(jax.tree.map(np.asarray,
                                                       jm.variables))
    state_dict = from_jax_variables(variables, cfg)

    def port():
        return Detector(nuscenes_config(**SIZE), state_dict, device="cpu",
                        motion_state_dict=motion_sd)

    return jdet, port


def snapshot(online):
    return [(t.track_id, t.classe, np.asarray(t.tlbr),
             np.asarray(t.ddd_submission, np.float64)) for t in online]


def check_cameras(got, want, tol):
    assert len(got) == len(want)
    for cam, (g, w) in enumerate(zip(got, want)):
        assert [t[:2] for t in g] == [t[:2] for t in w], cam
        for a, b in zip(g, w):
            np.testing.assert_allclose(a[2], b[2], rtol=0, atol=tol)
            np.testing.assert_allclose(a[3], b[3], rtol=1e-4, atol=1e-4)


def samples(frames):
    by = {}
    for info, frame in frames:
        by.setdefault(info["frame_id"], []).append((info, frame))
    return [by[k] for k in sorted(by)]


def test_run_multi_equals_sequential_run(detectors):
    """The port's batched rig against one ``run`` per camera, on its own
    six-camera scene: the same ids, boxes within BOX_TOL."""
    _, port = detectors
    scene = make_scene(n_samples=2, cameras=6, height=180, width=320,
                       n_objects=16, seed=3)
    seq, bat = port(), port()
    n = 0
    for sample in samples(scene):
        infos = [info for info, _ in sample]
        metas = [{"calib": info["calib"]} for info in infos]
        want = [snapshot(seq.run(frame, meta, info))
                for (info, frame), meta in zip(sample, metas)]
        got = bat.run_multi([f for _, f in sample], metas, infos,
                            materialize=snapshot)
        check_cameras(got, want, BOX_TOL)
        n += sum(len(c) for c in want)
    assert n >= 6


def test_submission_matches_convert_eval_format(nus_scene, detectors):
    """``track_nuscenes`` on the scene, then the port's submission and the
    JAX dataset's ``convert_eval_format`` of the same results: tracking
    items (global boxes) and detection items (camera boxes, attributes,
    velocities)."""
    from deft_tpu.data.datasets.nuscenes import NuScenesDataset

    root, frames = nus_scene
    _, port = detectors
    pdet = port()
    results = track_nuscenes(pdet, [(1, frames)])
    assert set(results) == {info["id"] for info, _ in frames}
    assert sum(len(v) for v in results.values()) > 0
    cfg = jax_nuscenes_config(input_h=96, input_w=160, dataset_version="")
    dataset = NuScenesDataset(cfg, "val", data_dir=root)
    infos = {info["id"]: info for info, _ in frames}
    # detection items: the post-processed detections of the first sample
    det_results = {}
    for info, frame in frames[:2]:
        images, meta = pdet.pre_process(frame, {"calib": info["calib"]})
        dets, _ = pdet.process(images)
        det_results[info["id"]] = pdet.post_process(dets, meta)
    for res in (results, det_results):
        got = nuscenes_submission(res, infos)
        want = dataset.convert_eval_format(copy.deepcopy(res))
        assert got["meta"] == want["meta"]
        assert sorted(got["results"]) == sorted(want["results"])
        for token, items in want["results"].items():
            assert len(got["results"][token]) == len(items) <= 500
            for a, b in zip(got["results"][token], items):
                assert sorted(a) == sorted(b)
                for key, value in b.items():
                    if isinstance(value, str):
                        assert a[key] == value, key
                    else:
                        np.testing.assert_allclose(a[key], value, rtol=1e-12,
                                                   atol=1e-12, err_msg=key)


def test_tracks_to_results_carries_the_class(nus_scene, detectors):
    _, port = detectors
    pdet = port()
    sample = samples(nus_scene[1])[0]
    infos = [info for info, _ in sample]
    out = pdet.run_multi([f for _, f in sample],
                         [{"calib": i["calib"]} for i in infos], infos,
                         materialize=tracks_to_results)
    items = [item for cam in out for item in cam]
    assert items
    for item in items:
        assert pdet.info.class_name[item["class"] - 1] == item["detection_name"]
        assert len(item["translation"]) == 3 and len(item["rotation"]) == 4


def test_nuscenes_detector_builds_on_cuda_by_default():
    """No refusal fires for the nuScenes config; the default device is the
    card (absent here)."""
    cfg = nuscenes_config()
    assert cfg.lstm and cfg.dataset == "nuscenes"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Detector(cfg)
