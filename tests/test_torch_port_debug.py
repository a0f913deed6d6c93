"""``--debug`` and ``--save_video`` through the port against the JAX
package, on the CPU.

One JAX run is the reference for the file (the ``reference`` fixture, one
set of JAX compiles): the JAX ``test.py``'s ``main`` on the MOT recipe's
test line with ``--debug 2 --save_video`` (``--dla_node conv``, float32,
96x128), over a two-frame PNG sequence at the input size (so both
packages' input warps are the identity and the inputs equal), from the
port's seeded weights (``torch_port_recipes.seeded_checkpoint``, loaded
by the JAX package without its init's compile, ``jax_init_from``); every
heatmap its ``pred_hm`` boards are drawn from is recorded.

* ``Detector.run`` at ``debug=2`` on the two frames (``tests/
  test_debugger.py``'s configuration): the ``pred_hm`` forward equals the
  JAX ``_debug_hm``'s within ``HM_TOL``, the tracks equal JAX's results
  (ids, boxes within ``BOX_TOL``), and the boards
  (``<n:05d>_{generic,previous,pred_hm}.png``) have JAX's names; the
  generic and previous boards are within the visualizer's mark tolerance
  (``test_torch_port_visualize.py``), ``pred_hm`` within ``PRED_HM_TOL``
  per channel (the colormap's uint8 cut and cv2's fixed-point resize).
* ``test.main`` on the same line: the saved results equal JAX's (ids,
  boxes within ``BOX_TOL``, scores within ``SCORE_TOL``), the board names
  and the video's frame count too; then at ``--debug 1 --save_video``
  with cv2 made unimportable: the generic and previous boards alone, and
  the video as one PNG per frame in ``video_<id>/``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import deft_tpu.utils.visualize as jax_vis
from deft_tpu_torch import test as port_test
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.data.image_io import imread, imwrite_png
from deft_tpu_torch.inference.detector import Detector
from test_torch_port_visualize import assert_marks_close
from torch_port_recipes import (ROOT, jax_init_from, recipe_test_argv,
                                seeded_checkpoint)

SIZE = dict(input_h=96, input_w=128, max_object=8, dla_node="conv",
            compute_dtype="float32")
FRAMES = 2
HM_TOL = 1e-4
BOX_TOL = 1e-3            # px
SCORE_TOL = 1e-4
PRED_HM_TOL = 2
BOARDS = ("generic", "pred_hm", "previous")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's port models (the suite runs
    several test processes on one machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def scene():
    """(frames, boxes): rectangles moving on noise at 96x128."""
    rng = np.random.RandomState(0)
    frames, boxes = [], []
    for f in range(FRAMES):
        img = rng.randint(40, 90, (96, 128, 3)).astype(np.uint8)
        rects = [(30 + 2 * f, 20 + f, 60 + 2 * f, 50 + f),
                 (80 - f, 55, 110 - f, 85)]
        for x0, y0, x1, y1 in rects:
            img[y0:y1, x0:x1] = rng.randint(150, 255, 3)
        frames.append(img)
        boxes.append(rects)
    return frames, boxes


def mot_layout(data):
    """``mot17/``: the scene as sequence SYN-01, its own val half (PNG
    frames, ``gt.txt`` and ``gt_val_half.txt``, ``annotations/
    val_half.json``), in ``tools/convert_mot_to_coco.py``'s layout."""
    seq = data / "mot17" / "train" / "SYN-01"
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    frames, boxes = scene()
    images, rows = [], []
    for f, (img, rects) in enumerate(zip(frames, boxes), start=1):
        imwrite_png(str(seq / "img1" / f"{f:06d}.png"), img)
        images.append({"id": f, "file_name": f"SYN-01/img1/{f:06d}.png",
                       "video_id": 1, "frame_id": f, "height": 96,
                       "width": 128})
        rows += [f"{f},{i},{x0},{y0},{x1 - x0},{y1 - y0},1,1,1"
                 for i, (x0, y0, x1, y1) in enumerate(rects, start=1)]
    for name in ("gt.txt", "gt_val_half.txt"):
        (seq / "gt" / name).write_text("\n".join(rows) + "\n")
    (data / "mot17" / "annotations").mkdir()
    (data / "mot17" / "annotations" / "val_half.json").write_text(
        json.dumps({"images": images, "annotations": [],
                    "videos": [{"id": 1, "file_name": "SYN-01"}],
                    "categories": [{"id": 1, "name": "pedestrian"}]}))


def line(root, exp, debug=2):
    return recipe_test_argv(
        "mot", load_model=root / "model.pth", data_dir=root / "data",
        exp_dir=exp, gpus=-1, save_results=True, debug=debug,
        save_video=True, **SIZE)


def save_dir(argv):
    return parse_config(argv)[0].save_dir


def jax_test_module():
    spec = importlib.util.spec_from_file_location("deft_test_entry_debug",
                                                  ROOT / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``test.main`` run (module docstring): (root, its results,
    its save_dir, the heatmaps of its pred_hm boards)."""
    root = tmp_path_factory.mktemp("debug")
    mot_layout(root / "data")
    seeded_checkpoint(parse_config(line(root, root / "seed"))[0],
                      scene()[0][0], root / "model.pth", seed=3)
    heatmaps = []
    gen_colormap = jax_vis.Debugger.gen_colormap

    def recorded(self, hm, output_res=None):
        heatmaps.append(np.array(hm))
        return gen_colormap(self, hm, output_res)

    argv = line(root, root / "exp_jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEFT_COMPILE_CACHE", str(root / "jax_cache"))
    mp.setattr(jax_vis.Debugger, "gen_colormap", recorded)
    try:
        with jax_init_from(root / "model.pth"):
            jax_test_module().main(argv)
    finally:
        mp.undo()
    with open(os.path.join(save_dir(argv), "save_results_mot.json")) as f:
        results = json.load(f)
    return root, results, save_dir(argv), heatmaps


def test_detector_run_debug_2_matches_jax(reference):
    root, results, jax_dir, heatmaps = reference
    cfg = parse_config(line(root, root / "exp_run"))[0]
    det = Detector(cfg, device="cpu")
    frames, _ = scene()
    assert len(heatmaps) == FRAMES
    for image_id, (frame, hm) in enumerate(zip(frames, heatmaps), start=1):
        images, _ = det.pre_process(frame)
        np.testing.assert_allclose(det.debug_heatmap(images), hm, rtol=0,
                                   atol=HM_TOL)
        online = det.run(frame)
        want = results[str(image_id)]
        assert len(want) > 0
        assert [t.track_id for t in online] == [i["tracking_id"]
                                                for i in want]
        np.testing.assert_allclose([t.tlbr for t in online],
                                   [i["bbox"] for i in want], atol=BOX_TOL)
    names = sorted(os.listdir(os.path.join(jax_dir, "debug")))
    assert names == [f"0000{n}_{b}.png" for n in range(1, FRAMES + 1)
                     for b in BOARDS]
    assert sorted(os.listdir(os.path.join(cfg.save_dir, "debug"))) == names
    for name in names:
        got = imread(os.path.join(cfg.save_dir, "debug", name))
        want = imread(os.path.join(jax_dir, "debug", name))
        assert got.shape == want.shape
        if "pred_hm" in name:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= (
                PRED_HM_TOL)
        elif not np.array_equal(got, want):
            frame = frames[int(name[4]) - (1 if "generic" in name else 2)]
            assert_marks_close(got, want, frame)


def video_frames(path):
    capture = cv2.VideoCapture(str(path))
    n = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    capture.release()
    return n


def test_test_main_debug_and_save_video_match_jax(reference, monkeypatch):
    root, want, jax_dir, _ = reference
    argv = line(root, root / "exp_port")
    port_test.main(argv)
    port_dir = save_dir(argv)
    with open(os.path.join(port_dir, "save_results_mot.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == [str(i)
                                           for i in range(1, FRAMES + 1)]
    n = 0
    for image_id, items in want.items():
        mine = got[image_id]
        assert [i["tracking_id"] for i in mine] == [
            i["tracking_id"] for i in items]
        for a, b in zip(mine, items):
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=BOX_TOL)
            assert abs(a["score"] - b["score"]) <= SCORE_TOL
            n += 1
    assert n >= FRAMES
    boards = sorted(os.listdir(os.path.join(jax_dir, "debug")))
    assert sorted(os.listdir(os.path.join(port_dir, "debug"))) == boards
    assert video_frames(os.path.join(port_dir, "video_1.mp4")) == (
        video_frames(os.path.join(jax_dir, "video_1.mp4"))) == FRAMES

    # --debug 1 where cv2 is missing: no pred_hm, one PNG per video frame
    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = line(root, root / "exp_port_png", debug=1)
    port_test.main(argv)
    port_dir = save_dir(argv)
    assert sorted(os.listdir(os.path.join(port_dir, "debug"))) == [
        b for b in boards if "pred_hm" not in b]
    assert sorted(os.listdir(os.path.join(port_dir, "video_1"))) == [
        f"{i:06d}.png" for i in range(FRAMES)]
