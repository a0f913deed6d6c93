"""COCO-format datasets through the port against the JAX package, on the
CPU: ``--dataset coco`` and ``--dataset custom`` through the samples, the
trainer, the test line and ``tools/eval_coco.py``.

The layout (``torch_port_layouts.layout_coco``) is the JAX
``CocoDataset``'s:
``coco/{train,val}2017/*.png`` with ``annotations/instances_{split}
2017.json``, two videos of moving boxes (``video_id``, ``frame_id``,
``track_id``) in three sparse categories (ids 1, 3, 7), frames at the
test's input size (64x96) so that both packages' input warps are the
identity.

* ``CocoDataset`` and ``CustomDataset`` samples equal the JAX package's
  under the same seeds, every target key bit for bit, the images within
  the warp's uint8 step (``test_torch_port_train_data.py``'s bound).
* ``eval_coco.evaluate`` equals the JAX tool's on ``tests/
  test_eval_coco.py``'s cases and on a random one; ``run_eval`` writes
  the same ``results_coco.json`` and returns the same 12 numbers.
* ``python -m deft_tpu_torch.train --dataset coco`` (``dla_node="conv"``,
  batch 2): its first step's loss statistics equal those of the JAX
  package's training forward (``loss_and_updates``) from the same weights
  on the same batch (the port loader's first from the line's seeds),
  within 1e-4 relative (the train tests' tolerance).
* ``test.main --dataset coco`` (the MOT recipe's flags, ``--dla_node
  conv``, float32, the JAX runner with ``--device_warp``, the weights
  loaded without the JAX init's compile, ``jax_init_from``) on every val
  scene of ``VAL_SEEDS``: the same results (ids, boxes within
  ``BOX_TOL``, scores within ``SCORE_TOL``) frame by frame, up to the
  first association of a video in which the two packages pick different
  matchings; there the costs must agree within ``COST_TOL`` and the two
  matchings tie (``association_tie``: on seeds 2, 3, 7 and 8 each costs
  exactly what the other does under the port's costs), and from there on
  the video's frames hold the same scores; the same COCO stats where no
  video diverged (seeds 4 and 6).
* ``CustomDataset.run_eval`` raises as the JAX one does, and a ``videos``
  list whose images lack ``video_id`` raises ``KeyError`` in both
  (ROADMAP C.3).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.coco_index import CocoIndex as JaxCocoIndex
from deft_tpu.data.datasets import get_dataset as jax_get_dataset
from deft_tpu.data.loader import DataLoader as JaxLoader
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu.train.trainer import loss_and_updates
from deft_tpu_torch import test as port_test
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.data.coco_index import CocoIndex
from deft_tpu_torch.data.datasets import STD, get_dataset
from deft_tpu_torch.data.loader import DataLoader
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.tools import eval_coco
from deft_tpu_torch.train import run as port_train
from deft_tpu_torch.train.trainer import training_keys
from torch_port_layouts import layout_coco
from torch_port_recipes import ROOT, jax_init_from, seeded_checkpoint

sys.path.insert(0, str(ROOT))
import tools.eval_coco as jax_eval_coco  # noqa: E402
from test_eval_coco import det, make_index  # noqa: E402

SIZE = ["--input_h", "64", "--input_w", "96", "--max_object", "8",
        "--dla_node", "conv"]
TRAIN_ARGV = ["tracking", "--dataset", "coco", "--batch_size", "2"] + SIZE
IMAGES = ("image", "pre_img", "pre_image")
IMAGE_BOUND = 4.4 / 255.0 / float(STD.min())
CATEGORIES = [{"id": 1, "name": "person"}, {"id": 3, "name": "car"},
              {"id": 7, "name": "dog"}]
BOX_TOL = 1e-3            # px
SCORE_TOL = 1e-4
COST_TOL = 1e-5           # the association costs' float32 rounding
LOSS_RTOL = 1e-4
# the val scenes: random weights fire in all 80 classes, so a scene holds
# one box detected in several classes, identical columns of the
# association's cost; the packages' costs differ by ~1e-7, and on seeds 2,
# 3, 7 and 8 that picks another of the equally good matchings
VAL_SEEDS = (2, 3, 4, 6, 7, 8)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's port models (the suite runs
    several test processes on one machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_layout")
    layout_coco(root / "data" / "coco", "train", CATEGORIES, seed=1)
    layout_coco(root / "data" / "coco", "val", CATEGORIES, seed=6)
    # a custom dataset's categories are 1..--num_classes
    layout_coco(root / "data" / "custom", "train", seed=3, categories=[
        {"id": i, "name": str(i)} for i in (1, 2, 3)])
    return root


def _batches(make, dataset, batch_size, seed, n=2):
    np.random.seed(seed)
    random.seed(seed)
    out = []
    for batch in make(dataset, batch_size, num_workers=1, seed=seed):
        out.append(batch)
        if len(out) == n:
            return out


def custom_argv(layout):
    custom = layout / "data" / "custom"
    return TRAIN_ARGV[:2] + [
        "custom", "--num_classes", "3", "--custom_dataset_img_path",
        str(custom / "train2017"), "--custom_dataset_ann_path",
        str(custom / "annotations" / "instances_train2017.json")
    ] + TRAIN_ARGV[3:]


@pytest.mark.parametrize("dataset", ["coco", "custom"])
def test_samples_equal_jax(layout, dataset):
    argv = TRAIN_ARGV if dataset == "coco" else custom_argv(layout)
    jcfg, _ = jax_parse_config(argv)
    pcfg, _ = parse_config(argv)
    data = str(layout / "data" / "coco")
    want = _batches(JaxLoader, jax_get_dataset(dataset)(jcfg, "train",
                                                         data_dir=data),
                    jcfg.batch_size, 3)
    got = _batches(DataLoader, get_dataset(dataset)(pcfg, "train",
                                                    data_dir=data),
                   pcfg.batch_size, 3)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            if k in IMAGES:
                assert np.abs(g[k] - w[k]).max() <= IMAGE_BOUND, k
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert w["mask"].sum() > 0
    if dataset == "coco":       # the json's categories, mapped to 1..3
        assert w["hm"].shape[-1] == 80 and w["cat"].max() <= 2


def _eval_cases():
    gts = [{"bbox": [0, 0, 10, 10]}, {"bbox": [50, 50, 10, 10]},
           {"bbox": [100, 100, 50, 50], "iscrowd": 1},
           {"bbox": [0, 0, 16, 16], "category_id": 2}]
    dets = [det([0, 0, 10, 10], 0.9), det([200, 200, 10, 10], 0.8),
            det([50, 50, 10, 10], 0.7), det([0, 0, 10, 6.2], 0.95),
            det([110, 110, 20, 20], 0.85),
            det([0, 0, 16, 16], 0.6, category_id=2)]
    yield [gts[0]], [dets[0]], (1,)
    yield gts[:2], dets[:3], (1,)
    yield [gts[0]], [dets[3]], (1,)
    yield [gts[0], gts[2]], [dets[0], dets[4]], (1,)
    yield gts, dets, (1, 2, 3)
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 200, (30, 2))
    rand_gts = [{"bbox": [*b, *rng.uniform(4, 120, 2)],
                 "image_id": int(i % 3) + 1, "category_id": int(i % 2) + 1,
                 "iscrowd": int(i % 11 == 0)} for i, b in enumerate(boxes)]
    rand_dets = [det(np.asarray(g["bbox"]) + rng.normal(0, 3, 4),
                     float(rng.uniform()), g["image_id"], g["category_id"])
                 for g in rand_gts[:25]]
    rand_dets += [det(rng.uniform(0, 150, 4), float(rng.uniform()),
                      int(rng.randint(1, 4)), int(rng.randint(1, 3)))
                  for _ in range(40)]
    yield rand_gts, rand_dets, (1, 2)


def test_eval_coco_equals_jax():
    for gts, dets, cats in _eval_cases():
        imgs = sorted({g.get("image_id", 1) for g in gts} | {1})
        index = make_index(gts, imgs=imgs, cats=cats)
        want = jax_eval_coco.evaluate(index, dets)
        got = eval_coco.evaluate(CocoIndex(dataset=index.dataset), dets)
        assert got == want
    dt, gt = np.random.RandomState(1).uniform(0, 50, (2, 6, 4))
    crowd = np.array([0, 1, 0, 0, 1, 0])
    np.testing.assert_array_equal(eval_coco.bbox_iou_xywh(dt, gt, crowd),
                                  jax_eval_coco.bbox_iou_xywh(dt, gt, crowd))


def test_run_eval_writes_the_same_json(layout, tmp_path):
    argv = TRAIN_ARGV + ["--dataset", "coco"]
    jcfg, _ = jax_parse_config(argv)
    pcfg, _ = parse_config(argv)
    data = str(layout / "data" / "coco")
    jds = jax_get_dataset("coco")(jcfg, "val", data_dir=data)
    pds = get_dataset("coco")(pcfg, "val", data_dir=data)
    assert pds.class_name == jds.class_name == ("person", "car", "dog")
    rng = np.random.RandomState(4)
    results = {}
    for a in jds.coco.dataset["annotations"]:
        b = np.asarray(a["bbox"]) + rng.normal(0, 1.5, 4)
        results.setdefault(a["image_id"], []).append(
            {"bbox": np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]],
                              np.float32),
             "score": float(rng.uniform(0.3, 1.0)),
             "class": jds.cat_ids[a["category_id"]], "tracking_id": 1})
    want = jds.run_eval(results, str(tmp_path / "jax"))
    got = pds.run_eval(results, str(tmp_path / "port"))
    assert got == want and want["AP50"] > 0.5
    assert ((tmp_path / "port" / "results_coco.json").read_bytes()
            == (tmp_path / "jax" / "results_coco.json").read_bytes())


def test_custom_run_eval_and_video_less_images_raise(layout, tmp_path):
    argv = custom_argv(layout)
    for parse, factory in ((jax_parse_config, jax_get_dataset),
                           (parse_config, get_dataset)):
        cfg, _ = parse(argv)
        ds = factory("custom")(cfg, "train")
        assert len(ds) == 8 and ds.class_name == ("0", "1", "2")
        with pytest.raises(NotImplementedError, match="no bundled evaluator"):
            ds.run_eval({}, str(tmp_path))
    with open(layout / "data" / "coco" / "annotations"
              / "instances_val2017.json") as f:
        blob = json.load(f)
    for im in blob["images"]:
        del im["video_id"]
    for index in (JaxCocoIndex, CocoIndex):
        with pytest.raises(KeyError, match="video_id"):
            index(dataset=json.loads(json.dumps(blob))).ensure_video_index()


def test_train_line_first_loss_equals_jax(layout, tmp_path):
    argv = TRAIN_ARGV + ["--data_dir", str(layout / "data"), "--exp_dir",
                         str(tmp_path), "--num_epochs", "1", "--num_iters",
                         "1", "--num_workers", "1", "--gpus", "-1"]
    stats = {}
    port_train.main(argv, stats)
    got = stats["first"]

    jcfg, _ = jax_parse_config(argv)
    pcfg, _ = parse_config(argv)
    data = str(layout / "data" / "coco")
    # the batch the port's loader gave the line (its images are within a
    # warp step of the JAX loader's, test_samples_equal_jax)
    (batch, _) = _batches(DataLoader, get_dataset("coco")(
        pcfg, "train", data_dir=data), pcfg.batch_size, pcfg.seed)
    keys = training_keys(batch, pcfg)
    init = {k: v.numpy() for k, v in create_model(
        pcfg.arch, pcfg, "cpu").state_dict().items()}
    params, batch_stats = TorchConverter(jcfg.dataset).convert_dla34(
        init, jcfg.heads, jcfg.dla_node, DLA_PLANS["34"][0])
    model = jax_create_model(jcfg.arch, jcfg)
    _, (want, _) = jax.jit(lambda p, s, b: loss_and_updates(
        model, jcfg, p, s, jnp.ones(()), jnp.ones(()), b))(
            params, batch_stats, {k: jnp.asarray(batch[k]) for k in keys})
    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1.0), (k, got[k], w)
    assert np.isfinite(got["joint"]) and got["hm"] > 0


def jax_test_module():
    spec = importlib.util.spec_from_file_location("deft_test_entry_coco",
                                                  ROOT / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_associations(monkeypatch, matching, tracker):
    """Per ``Tracker.update`` call (one frame) from now on, the (cost,
    thresh, matches) of each ``matching.linear_assignment`` it makes."""
    frames = []
    assign, update = matching.linear_assignment, tracker.Tracker.update

    def recorded_assign(cost, thresh):
        out = assign(cost, thresh)
        frames[-1].append((np.array(cost, np.float64), thresh,
                           {tuple(m) for m in np.asarray(out[0]).tolist()}))
        return out

    def recorded_update(self, *args, **kwargs):
        frames.append([])
        return update(self, *args, **kwargs)

    monkeypatch.setattr(matching, "linear_assignment", recorded_assign)
    monkeypatch.setattr(tracker.Tracker, "update", recorded_update)
    return frames


def association_tie(mine, theirs):
    """The first of a frame's associations whose matchings differ between
    the packages, as (port objective of JAX's matching less that of its
    own, bound, max|C_port - C_jax|): the objective is the sum of (cost -
    thresh) over the matched pairs, the bound (|M_port| + |M_jax|) x
    max|C_port - C_jax|.  Both matchings optimal for their own costs puts
    the difference in [0, bound], so within the bound either way: the two
    are equally good up to the costs' rounding, a tie.  None where every
    matching agrees."""
    assert len(mine) == len(theirs)
    for (cp, thresh, mp), (cj, thresh_j, mj) in zip(mine, theirs):
        assert cp.shape == cj.shape and thresh == thresh_j
        if mp == mj:
            continue
        finite = np.isfinite(cp)
        np.testing.assert_array_equal(finite, np.isfinite(cj))
        delta = np.abs(cp[finite] - cj[finite]).max()
        gap = (sum(cp[i, j] - thresh for i, j in mj)
               - sum(cp[i, j] - thresh for i, j in mp))
        return gap, (len(mp) + len(mj)) * delta, delta
    return None


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """One compile cache for the JAX test lines of every seed."""
    return tmp_path_factory.mktemp("jax_cache")


@pytest.mark.parametrize("seed", VAL_SEEDS)
def test_test_line_coco_equals_jax(tmp_path, monkeypatch, jax_cache, seed):
    import deft_tpu.tracking.matching as jax_matching
    import deft_tpu.tracking.tracker as jax_tracker
    import deft_tpu_torch.tracking.matching as port_matching
    import deft_tpu_torch.tracking.tracker as port_tracker
    from deft_tpu_torch.data.image_io import imread

    monkeypatch.setenv("DEFT_COMPILE_CACHE", str(jax_cache))
    val = layout_coco(tmp_path / "data" / "coco", "val", CATEGORIES,
                      seed=seed)
    cfg, _ = parse_config(["tracking", "--dataset", "coco", "--ltrb_amodal",
                           "--gpus", "-1"] + SIZE)
    frame = imread(str(tmp_path / "data" / "coco" / "val2017"
                       / "v1_001.png"))
    seeded_checkpoint(cfg, frame, tmp_path / "model_coco.pth", top=1.0)
    out = {}
    for name, main, modules in (
            ("jax", jax_test_module().main, (jax_matching, jax_tracker)),
            ("port", port_test.main, (port_matching, port_tracker))):
        exp = tmp_path / f"exp_{name}"
        frames = recorded_associations(monkeypatch, *modules)
        with (jax_init_from(tmp_path / "model_coco.pth") if name == "jax"
              else contextlib.nullcontext()):
            metrics = main(["tracking", "--dataset", "coco", "--ltrb_amodal",
                            "--track_thresh", "0.4", "--pre_thresh", "0.5",
                            "--compute_dtype", "float32", "--load_model",
                            str(tmp_path / "model_coco.pth"), "--data_dir",
                            str(tmp_path / "data"), "--exp_dir", str(exp),
                            "--gpus", "-1", "--save_results",
                            "--device_warp"] + SIZE)
        monkeypatch.undo()
        with open(exp / "tracking" / "default" / "save_results_coco.json"
                  ) as f:
            out[name] = (metrics, json.load(f), frames)
    (j_metrics, j_res, j_frames), (p_metrics, p_res, p_frames) = (
        out["jax"], out["port"])
    images = json.loads(val.read_text())["images"]
    assert sorted(p_res) == sorted(j_res) == sorted(
        str(im["id"]) for im in images)
    assert len(p_frames) == len(j_frames) == len(images) == 8
    diverged, n = set(), 0
    for im, mine, theirs in zip(sorted(images, key=lambda im: im["id"]),
                                p_frames, j_frames):
        items, ref = p_res[str(im["id"])], j_res[str(im["id"])]
        if im["video_id"] not in diverged:
            tie = association_tie(mine, theirs)
            if tie is not None:
                gap, bound, delta = tie
                assert abs(gap) <= bound and delta <= COST_TOL, (
                    im, gap, bound, delta)
                diverged.add(im["video_id"])
        if im["video_id"] in diverged:
            # which track took which detection may differ from here on
            np.testing.assert_allclose(sorted(i["score"] for i in items),
                                       sorted(i["score"] for i in ref),
                                       atol=SCORE_TOL)
            continue
        assert [i["tracking_id"] for i in items] == [
            i["tracking_id"] for i in ref], im
        for a, b in zip(items, ref):
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=BOX_TOL)
            assert abs(a["score"] - b["score"]) <= SCORE_TOL
            n += 1
    assert n >= 8
    assert set(p_metrics) == set(j_metrics) == {
        "AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100",
        "ARs", "ARm", "ARl"}
    if not diverged:
        assert p_metrics == pytest.approx(j_metrics, abs=1e-9)
