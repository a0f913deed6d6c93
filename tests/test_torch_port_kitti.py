"""KITTI 2-D vehicle tracking: the port's ``Detector.run`` and
``PipelinedRunner`` vs the JAX package's, on the CPU.

``kitti_config`` at 64x192 (KITTI's 1:3.3 aspect, both sides divisible by
32), max_object 8, K 16, ``dcn_offset_range`` 1, on 18 frames of
``tools/make_synthetic_kitti.py::make_sequence`` (four cars crossing a
160x512 scene, written as PNG files and read back with cv2).  The weights
are the JAX init with every offset conv randomized, the heatmap head
rescaled per class so that ~2% of the first frame's pixels score above 0.5
in each (Cars and the other two classes: random weights otherwise never
reach the car filter) and the box head biased so that boxes have an
extent.  Random weights make smooth heatmaps, where two neighbouring peaks
can tie to the runner's noise: T2 rounds each DCN input to bf16, which
turns float32 differences between the packages into bf16 steps here and
there, and scores then differ by up to ~5e-4.  The two packages may then
keep different peaks.  The offset seed is one whose 18 frames have no such
tie; of seeds 1-13, all but 4 and 6 have one.

Three paths, each as ``test.py`` runs it with ``cls_default=2``:
``Detector.run`` (``dcn_impl="hybrid"``, on the JAX package's prefetched
warped inputs, as ``tests/test_torch_port_slice.py`` compares), and the
runner at chunk 1 and chunk 4 (``dcn_impl="pallas"``, the JAX T2 kernel in
interpret mode, the JAX runner with ``device_warp=True``).  Per frame the
items must agree: track ids exactly, boxes within BOX_TOL pixels; the KITTI
txt files are equal byte for byte and ``tools/eval_kitti.py`` scores them
alike.
"""

import functools
import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deft_tpu.ops.pallas_dcn as pallas_dcn
from deft_tpu.config import kitti_config
from deft_tpu.data.datasets.kitti_tracking import KITTITrackingDataset
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import kitti_config as port_kitti_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.data import synthetic_kitti
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.track import (
    save_kitti_results,
    track_videos,
    track_videos_detector,
)
from tools.eval_kitti import evaluate_kitti_dir, load_kitti_file
from tools.make_synthetic_kitti import make_sequence

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZE = dict(input_h=64, input_w=192, max_object=8, K=16, dcn_offset_range=1)
FRAMES = 18
OFFSET_SEED = 6
BOX_TOL = 1e-3            # pixels
CAR = 2
SEQ = "0000"
VIDEOS = [{"id": 1, "file_name": SEQ}]
INFOS = [{"id": 100 + f, "frame_id": f + 1} for f in range(FRAMES)]
# path -> (chunk; None: Detector.run)
PATHS = {"detector": None, "chunk_1": 1, "chunk_4": 4}


def _jax_tracks_to_results():
    spec = importlib.util.spec_from_file_location(
        "deft_test_entry", os.path.join(ROOT, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tracks_to_results


def _randomize_offsets(tree, rng):
    for key, v in tree.items():
        if key == "conv_offset_mask":
            v["kernel"] = rng.normal(0, 0.01, v["kernel"].shape
                                     ).astype(np.float32)
            v["bias"] = rng.uniform(-1.0, 1.0, v["bias"].shape
                                    ).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_offsets(v, rng)


def _jax_run(detector, runner, inputs, tracks_to_results):
    """test.py:172-210 on one sequence: {image id: items}."""
    results = {}
    if runner is None:
        for info, inp in zip(INFOS, inputs):
            results[info["id"]] = tracks_to_results(detector.run(inp), CAR)
        return results
    pending = []
    for info, frame in zip(INFOS, inputs):
        pending.append(info["id"])
        done = runner.submit(frame, {})
        if done is None:
            continue
        for tracks in (done if runner.chunk > 1 else [done]):
            results[pending.pop(0)] = tracks_to_results(tracks, CAR)
    for tracks in runner.flush():
        results[pending.pop(0)] = tracks_to_results(tracks, CAR)
    return results


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    make_sequence(str(root), SEQ, n_frames=FRAMES, seed=0)
    img_dir = os.path.join(root, "data_tracking_image_2", "training",
                           "image_02", SEQ)
    seq = [cv2.imread(os.path.join(img_dir, f"{f:06d}.png"))
           for f in range(FRAMES)]

    cfg = kitti_config(**SIZE)
    model = jax_create_model(cfg.arch, cfg)
    params, stats = jax_init_model(model, cfg)
    variables = jax.tree.map(np.array, {"params": params,
                                        "batch_stats": stats})
    _randomize_offsets(variables["params"], np.random.RandomState(OFFSET_SEED))
    # random weights give a flat heatmap far below the threshold: rescale
    # the head so ~2% of the first frame's pixels score > 0.5 in each class
    image, _ = JaxDetector(cfg, model=model,
                           variables=variables).pre_process(seq[0])
    out, _ = model.apply(variables, jnp.asarray(image))
    z = np.asarray(out["hm"]).reshape(-1, 3)
    gain = 2.0 / z.std()
    hm = variables["params"]["head_hm"]["out"]
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = ((hm["bias"] - np.percentile(z, 98, axis=0)) * gain
                  ).astype(np.float32)
    wh = variables["params"]["head_wh"]["out"]
    wh["bias"] = (wh["bias"] + np.float32([8, 8])).astype(np.float32)
    sd = from_jax_variables(variables, cfg)

    tracks_to_results = _jax_tracks_to_results()
    jdet = JaxDetector(cfg, model=model, variables=variables)
    inputs = [dict(zip(("images", "meta"), jdet.pre_process(f))) for f in seq]
    pdet = Detector(port_kitti_config(**SIZE), sd, device="cpu")
    runs = {"detector": (
        _jax_run(jdet, None, inputs, tracks_to_results),
        track_videos_detector(pdet, [(1, list(zip(
            [i["id"] for i in INFOS], inputs)))], cls_default=CAR))}
    frames = [(info["id"], f) for info, f in zip(INFOS, seq)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_dcn, "deform_conv_pallas_tap", functools.partial(
            pallas_dcn.deform_conv_pallas_tap, interpret=True))
        rcfg = kitti_config(device_warp=True, dcn_impl="pallas", **SIZE)
        rmodel = jax_create_model(rcfg.arch, rcfg)
        for name, chunk in PATHS.items():
            if chunk is None:
                continue
            jrun = JaxRunner(JaxDetector(rcfg, model=rmodel,
                                         variables=variables),
                             depth=3, chunk=chunk)
            prun = PipelinedRunner(Detector(
                port_kitti_config(dcn_impl="pallas", **SIZE), sd,
                device="cpu"), depth=3, chunk=chunk)
            runs[name] = (_jax_run(None, jrun, seq, tracks_to_results),
                          track_videos(prun, [(1, frames)], cls_default=CAR))
    return {"root": str(root), "sd": sd, "inputs": inputs, "runs": runs}


def _per_frame(results):
    return [results[info["id"]] for info in INFOS]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kitti_matches_jax(setup, path):
    j_res, p_res = setup["runs"][path]
    assert sorted(p_res) == sorted(j_res) == sorted(i["id"] for i in INFOS)
    for f, (jf, pf) in enumerate(zip(_per_frame(j_res), _per_frame(p_res))):
        assert ([i["tracking_id"] for i in pf]
                == [i["tracking_id"] for i in jf]), f"{path} frame {f}"
        for a, b in zip(pf, jf):
            assert a["class"] == b["class"] == CAR
            assert a["active"] == b["active"]
            np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                       atol=BOX_TOL, err_msg=f"{path} {f}")
    # a real scene: tracks are kept across frames
    per_frame = _per_frame(p_res)
    assert sum(len(fr) for fr in per_frame) >= 2 * FRAMES
    last = {i["tracking_id"] for i in per_frame[-1]}
    assert len(last & {i["tracking_id"] for i in per_frame[-5]}) >= 2


def test_car_filter_drops_other_classes(setup):
    """The heatmap scores Pedestrians and Cyclists above the threshold too:
    the port's post-process finds them, and ``Detector.run`` hands the
    tracker the cars only."""
    pdet = Detector(port_kitti_config(**SIZE), setup["sd"], device="cpu")
    classes = []
    for inp in setup["inputs"]:
        dets, _ = pdet.process(inp["images"])
        classes += [d["class"] for d in pdet.post_process(dets, inp["meta"])]
    assert classes.count(CAR) >= FRAMES
    assert len(classes) - classes.count(CAR) >= FRAMES


def test_port_chunk_4_equals_chunk_1(setup):
    """On the CPU, chunk 4 ``frame_chunk`` repeats chunk 1 ``frame_step``
    exactly."""
    one, four = setup["runs"]["chunk_1"][1], setup["runs"]["chunk_4"][1]
    for a_fr, b_fr in zip(_per_frame(one), _per_frame(four)):
        assert [i["tracking_id"] for i in a_fr] == [i["tracking_id"]
                                                    for i in b_fr]
        for a, b in zip(a_fr, b_fr):
            np.testing.assert_array_equal(a["bbox"], b["bbox"])


class _Stub:
    """What ``KITTITrackingDataset.save_results`` reads."""
    class_name = KITTITrackingDataset.class_name

    class coco:
        dataset = {"videos": VIDEOS}

    video_to_images = {1: INFOS}


def test_kitti_writer_matches_jax_on_one_dict(setup, tmp_path):
    """The two writers on the same results dict give the same bytes,
    including an inactive item, 3-D fields and a second class."""
    results = dict(setup["runs"]["chunk_1"][0])
    first = results[INFOS[1]["id"]]
    results[INFOS[1]["id"]] = first + [
        {"bbox": np.float32([1.005, 2.5, 30.25, 40.0]), "score": 0.456,
         "class": 1, "tracking_id": 99, "active": 0, "alpha": -1.7,
         "rot_y": 2.9, "dim": [1.52, 0.004, 3.9], "loc": [-3.4, 1.6, 22.7]}]
    _, _, (j_txt, p_txt) = _write_both(results, tmp_path)
    assert p_txt == j_txt
    assert " 99 Pedestrian -1 -1 -1 " in j_txt


def _write_both(results, tmp_path):
    """``results`` through the JAX writer and the port's: their txt."""
    j_dir = KITTITrackingDataset.save_results(_Stub, results,
                                              str(tmp_path / "jax"))
    p_dir = save_kitti_results(results, VIDEOS, _Stub.video_to_images,
                               str(tmp_path / "port"))
    texts = []
    for d in (j_dir, p_dir):
        with open(os.path.join(d, f"{SEQ}.txt")) as f:
            texts.append(f.read())
    return j_dir, p_dir, texts


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kitti_txt_and_scores_match_jax(setup, path, tmp_path):
    """Each package's results dict through both writers gives the same
    bytes: 18 fields per line, class Car, frames in range.  Scored by
    tools/eval_kitti.py against the generator's label_02, the JAX package's
    txt and the port's count the same matches, misses, false positives and
    switches; MOTP averages the overlaps of boxes that agree within
    BOX_TOL, printed to 0.01 px, and is held within 1e-4."""
    j_res, p_res = setup["runs"][path]
    j_dir, _, (j_txt, j_txt_port) = _write_both(j_res, tmp_path / "j")
    _, p_dir, (p_txt_jax, p_txt) = _write_both(p_res, tmp_path / "p")
    assert j_txt_port == j_txt and p_txt == p_txt_jax
    lines = p_txt.splitlines()
    assert len(lines) >= 2 * FRAMES
    for line in lines:
        parts = line.split()
        assert len(parts) == 18 and parts[2] == "Car"
        assert 0 <= int(parts[0]) < FRAMES
    gt_dir = os.path.join(setup["root"], "label_02")
    j_m = evaluate_kitti_dir(gt_dir, j_dir)["overall"]
    p_m = evaluate_kitti_dir(gt_dir, p_dir)["overall"]
    assert abs(p_m.pop("motp") - j_m.pop("motp")) <= 1e-4
    assert p_m == j_m
    assert p_m["num_objects"] > 0


def test_synthetic_kitti_generator(tmp_path):
    """The numpy generator: KITTI image_02's frame size, deterministic per
    seed, other seeds other scenes, cars that enter and leave, and label
    rows that tools/eval_kitti.py reads."""
    frames, rows = synthetic_kitti.make_sequence(n_frames=12, seed=3)
    again, rows_again = synthetic_kitti.make_sequence(n_frames=12, seed=3)
    other, rows_other = synthetic_kitti.make_sequence(n_frames=12, seed=4)
    assert len(frames) == 12
    assert all(f.shape == (375, 1242, 3) and f.dtype == np.uint8
               for f in frames)
    assert all(np.array_equal(a, b) for a, b in zip(frames, again))
    assert rows == rows_again and rows != rows_other
    assert not np.array_equal(frames[5], other[5])
    path = tmp_path / "0000.txt"
    path.write_text("\n".join(rows) + "\n")
    labels = load_kitti_file(str(path))
    assert sum(len(v) for v in labels.values()) == len(rows)
    assert all(len(r.split()) == 17 for r in rows)
    spans = {}
    for frame, objs in labels.items():
        for tid, (x, y, w, h) in objs:
            assert 0 <= frame < 12 and w >= 8 and h >= 8
            assert 0 <= x and x + w <= 1242 and 0 <= y and y + h <= 375
            spans.setdefault(tid, []).append(frame)
    assert len(spans) >= 10
    assert any(min(s) > 0 for s in spans.values())        # some enter
    assert any(max(s) < 11 for s in spans.values())       # some leave
