"""The port's nuScenes rig (``Detector.run_multi``) against the benchmark's
plain reference (``benchmarks/reference/``: ``deft_ref``, ``ddd_ref``,
``lstm_ref``, ``cascade3d``), on the CPU: seeded and calibrated weights
(``benchmarks/rig_program.py``), two cameras of the benchmark's synthetic
rig (``benchmarks/rig_scenes.py``) at 180x320, a 96x160 input, K 24 and 8
objects, six samples, the trackers started afresh at the fourth, as at a
new scene; two intra-op threads.

* the 3-D decode, the camera and global boxes and the E = 704 similarity
  of ``run_multi`` against the reference (the rig cell's own judge);
* the global boxes and per-class NMS (``Detector._route_nuscenes``)
  against ``cascade3d.route``;
* one LSTM step at N = 1, 5, 33 against ``lstm_ref.step``;
* the 3-D IoU against ``cascade3d.iou3d``'s own clip;
* the ids, boxes, scores and LSTM steps over the six samples against the
  plain 3-D cascade;
* the spans and counters ``run_multi`` records, and the MOT runner's set
  of spans, which the rig's leave as it was.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import rig_compare, rig_scenes
from benchmarks.cells.rig import RigRecorder
from benchmarks.compare import Geometry, TrackJudge
from benchmarks.program import program_config
from benchmarks.reference import cascade3d, ddd_ref, lstm_ref
from benchmarks.reference.deft_ref import Reference, dla34_spec, input_image
from benchmarks.rig_program import lstm_state_dict, make_rig_weights
from benchmarks.spec import Spec
from deft_tpu_torch.config import mot_config
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.ops.iou import pairwise_iou3d
from deft_tpu_torch.tracking import matching
from deft_tpu_torch.tracking.motion_lstm import LSTMMotion

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 32 + 11
SAMPLES = 6
NEW_SCENE = 3        # the sample that starts a new scene on fresh trackers
CONFIG = {"input_h": 96, "input_w": 160, "K": 24, "max_object": 8,
          "camera_share": {"car": 0.9, "truck": 0.35, "bus": 0.12,
                           "trailer": 0.12, "pedestrian": 0.6,
                           "motorcycle": 0.12, "bicycle": 0.12},
          "detections_per_frame": {
              "car": 1.5, "truck": 0.4, "bus": 0.15, "trailer": 0.15,
              "pedestrian": 0.8, "motorcycle": 0.15, "bicycle": 0.15,
              "construction_vehicle": 0.1, "traffic_cone": 0.3,
              "barrier": 0.3},
          "box_prior_cells": [3, 3],
          "test_line": ["tracking,ddd", "--dataset", "nuscenes",
                        "--nuscenes_att", "--velocity", "--track_thresh",
                        "0.1", "--nms", "--max_object", "8", "--K", "24"]}
SCENE = {"height": 180, "width": 320, "samples": SAMPLES, "cameras": 2,
         "ego_step_m": 3.0, "radius_m": 30.0}
TOL = 1e-4           # float32 on both sides; DCN, conv orders differ
# the MOT runner's spans and counters over a sequence
MOT_SPANS = {"casc_desims", "casc_post", "casc_track", "casc_wait",
             "cascade", "dispatch", "fetch_wait", "host_prep",
             "program.decode", "program.embed", "program.forward",
             "program.tail", "program.warp", "runner.fetch",
             "tracker.affinity", "tracker.assign", "tracker.births",
             "tracker.bookkeeping", "tracker.iou", "tracker.predict",
             "upload", "warp"}
MOT_COUNTERS = {"births", "dets", "eager_programs", "matched",
                "tracks_held", "tracks_removed"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rig():
    """Six samples of the tiny rig through ``run_multi``, recorded as the
    rig cell records them, and what the reference needs."""
    spec_file = Spec(ROOT)
    entry = spec_file.cell("nuscenes-track")
    config = {**spec_file.config(entry["config"]), **CONFIG}
    scene = {**spec_file.traffic(entry["traffic"])["scene"], **SCENE}
    dev = torch.device("cpu")
    frames, infos = rig_scenes.make_rig(scene, SEED, dev)
    spec = dla34_spec(config)
    lstm_sd = lstm_state_dict(SEED, dev)
    det = Detector(program_config(config, "test_line"), device=dev,
                   motion_state_dict=lstm_sd)
    sd = make_rig_weights(det, config, spec, frames[:2].flatten(0, 1), SEED,
                          dev, lambda msg: None)
    results = []
    post = det.post_process

    def keep(dets, meta):
        out = post(dets, meta)
        results.append(out)
        return out

    det.post_process = keep
    rec = RigRecorder(det, matching)
    try:
        for s in range(SAMPLES):
            if s == NEW_SCENE:
                rec.new_scene(det)
            det.run_multi(list(frames[s].numpy()),
                          [{"calib": i["calib"]} for i in infos[s]], infos[s],
                          materialize=rec.emit)
    finally:
        rec.stop()
    cam_infos = [info for row in infos for info in row]
    return {"config": config, "spec": spec, "sd": sd, "lstm": lstm_sd,
            "frames": frames, "infos": cam_infos, "det": det, "rec": rec,
            "results": results, "starts": {NEW_SCENE * frames.shape[1]}}


def test_run_multi_against_reference(rig):
    """Decode, camera and global boxes and the similarity of every camera
    against the reference, by the rig cell's judge."""
    config, frames = rig["config"], rig["frames"]
    geom = Geometry.of(config, frames.shape[2], frames.shape[3])
    judge = rig_compare.RigJudge(TrackJudge(
        Reference(rig["sd"], rig["spec"]), config, geom), frames.shape[1])
    out = judge.judge(frames, list(range(SAMPLES)), rig["rec"].cameras,
                      rig["infos"], [(0, SAMPLES)], rig["starts"])
    assert out["frames"] == 2 * SAMPLES and out["detections"] > 0
    assert out["sim_updates"] > 0
    for key in ("score_gap", "box_gap", "dep_gap", "dim_gap", "rot_gap",
                "sim_rel", "missed"):
        assert out[key] <= TOL, (key, out)
    assert out["loc_gap"] <= 1e-3 and out["ring_misses"] == 0, out


def test_decode_matches_ddd_reference(rig):
    """The first sample's peaks, read by ``ddd_ref.decode`` from the
    reference's heads: the same cells, classes and 3-D boxes."""
    config, frames = rig["config"], rig["frames"]
    ref = Reference(rig["sd"], rig["spec"])
    with torch.no_grad():
        y, _ = ref.trunk(input_image(frames[0], config["input_h"],
                                     config["input_w"]))
        heads = ref.heads(y)
    geom = Geometry.of(config, frames.shape[2], frames.shape[3])
    for k in range(frames.shape[1]):
        rec = rig["rec"].cameras[k]
        d = ddd_ref.decode({h: v[k] for h, v in heads.items()}, config["K"],
                           0.1)
        res = ddd_ref.camera_results(d, geom.to_frame,
                                     np.asarray(rig["infos"][k]["calib"]))
        assert len(d["score"]) == len(rec) > 0
        np.testing.assert_array_equal(d["cell"], rec.cells)
        np.testing.assert_array_equal(d["cls"], rec.cls)
        for key, tol in (("score", TOL), ("dep", TOL), ("dim", TOL),
                         ("rot_y", TOL), ("loc", 1e-3), ("bbox", 1e-2)):
            np.testing.assert_allclose(rec.res[key], res[key], rtol=TOL,
                                       atol=tol, err_msg=key)


def test_route_matches_plain_routing(rig):
    """``_route_nuscenes``' per-class detections and global boxes against
    ``cascade3d.route`` on every camera."""
    det = rig["det"]
    for results, rec, info in zip(rig["results"], rig["rec"].cameras,
                                  rig["infos"]):
        port = det._route_nuscenes(results, info)
        plain = cascade3d.route(rec.res, info)
        for c in cascade3d.TRACKED:
            assert len(port[c]["dets"]) == len(plain[c]["rows"]), c
            np.testing.assert_allclose(
                np.asarray(port[c]["ddd"]).reshape(-1, 7), plain[c]["ddd"],
                rtol=0, atol=1e-6)
            assert [d["score"] for d in port[c]["dets"]] == plain[c]["score"]


def test_similarity_e704_matches_reference(rig):
    """The AFE's ring similarity at nuScenes' E = 704 against the
    reference's, on embeddings of a seeded ring."""
    model = rig["det"].model
    ref = Reference(rig["sd"], rig["spec"])
    m = rig["config"]["max_object"]
    gen = torch.Generator().manual_seed(5)
    ring = torch.rand((50, m, 704), generator=gen)
    counts = torch.randint(0, m + 1, (50,), generator=gen,
                           dtype=torch.int32)
    ring = ring * (torch.arange(m)[None, :, None] < counts[:, None, None])
    cur = torch.rand((m, 704), generator=gen)
    cur[5:] = 0
    with torch.no_grad():
        got = model.window_similarity(ring, counts, cur, 5)
        want = ref.similarity(ring, counts, cur, 5)
    assert model.embed_dim == 704
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 5, 33])
def test_lstm_step_matches_reference(rig, n):
    motion = LSTMMotion("nuscenes", rig["lstm"], device="cpu")
    gen = torch.Generator().manual_seed(n)
    h = torch.randn((n, 128), generator=gen)
    c = torch.randn((n, 128), generator=gen)
    x = torch.randn((n, 18), generator=gen) * 30.0
    got = motion.predict_batch(h.numpy(), c.numpy(), x.numpy())
    want = lstm_ref.step(rig["lstm"], h, c, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


def test_iou3d_matches_plain_clip():
    rng = np.random.default_rng(3)
    a = np.c_[rng.uniform(1, 3, (20, 3)), rng.uniform(-3, 3, (20, 3)),
              rng.uniform(-4, 4, 20)]
    b = a.copy()
    b[5:, 3:6] += rng.normal(0, 0.7, (15, 3))
    b[5:, 6] += rng.normal(0, 0.5, 15)
    b[-3:, 3] += 50.0                       # far apart
    got = pairwise_iou3d(list(a), list(b))
    want = cascade3d.iou3d(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(want)[:5], 1.0, atol=1e-9)
    assert (want[:, -3:][:-3] == 0).all() and 0 < (want > 0).mean() < 1


def test_ids_match_plain_cascade(rig):
    """Every camera's emitted tracks (id, box, 3-D box, score) and every
    LSTM step over the six samples against the plain 3-D cascade."""
    rec = rig["rec"]
    misses, rel, load = rig_compare.cascade_check(
        rec.cameras, rig["infos"], rec.lstm, rig["lstm"],
        rig["config"]["max_object"], starts=rig["starts"])
    assert misses == 0
    assert rel <= 1e-5
    assert load["births"] > 0 and load["iou3d_pairs"] > 0
    assert sum(len(r.emitted) for r in rec.cameras) > 0
    assert rig_compare.iou3d_gap(rec.iou) <= 1e-6


def test_run_multi_records_rig_spans(rig):
    timers = rig["det"].timers
    count = timers.count
    for name in ("pre", "net", "post", "track", "rig.ddd", "tracker.iou3d",
                 "tracker.lstm", "tracker.affinity"):
        assert count.get(name, 0) > 0, name
    assert count["pre"] == count["net"] == SAMPLES
    assert count["rig.ddd"] == 2 * SAMPLES
    t = timers.per_frame(SAMPLES)
    assert t["n.cameras"] == 2
    assert t["n.iou3d_pairs"] > 0 and t["n.lstm_rows"] > 0


def test_mot_runner_span_set_unchanged():
    """The MOT runner records the spans and counters it did before the
    rig's were added: the rig's are the nuScenes trackers' alone."""
    torch.manual_seed(0)
    det = Detector(mot_config(input_h=96, input_w=160, max_object=8, K=16,
                              dla_node="conv", track_thresh=1e-3),
                   device="cpu")
    run = PipelinedRunner(det, depth=2, chunk=4)
    rng = np.random.RandomState(0)
    run.track_sequence([rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
                        for _ in range(8)])
    assert set(run.spans.totals) == MOT_SPANS
    assert set(run.spans.counters) == MOT_COUNTERS
    assert det.timers.count == {n: 0 for n in ("pre", "net", "post",
                                               "track", "tot")}
