"""``python -m deft_tpu_torch.test`` against the JAX package's ``test.py``
on MOT17's test line, on the CPU.

The line is ``experiments/mot17_tracking.sh``'s, as it stands, with
``--load_model`` and ``--compute_dtype`` set, plus ``--data_dir``,
``--exp_dir`` (one per package), a small input (``--input_h 64 --input_w
96 --max_object 8``), ``--gpus -1`` (which the JAX package ignores),
``--save_results`` and ``--device_warp``: the JAX runner then warps on the
device as the port's always does (its host route warps with cv2 into
uint8, a different input).  Data: ``tools/make_synthetic_mot.py`` (one
16-frame 192x128 sequence, JPEG, noise added) and
``tools/convert_mot_to_coco.py``, whose ``val_half.json`` holds its last 8
frames.  Weights: the port's seeded network
(``torch_port_recipes.seeded_checkpoint``) as a reference ``.pth``, which
both packages load.

float32 (``--compute_dtype float32``): the ``save_results`` json has the
same images and, per image, the same track ids with boxes within
``BOX_TOL`` px and scores within ``SCORE_TOL`` (the runner test's
tolerances; convolutions sum in another order in the two frameworks); the
MOT txt files are byte-equal, so ``run_eval``'s metric dicts are equal.

bfloat16 (the recipe's own ``--compute_dtype bfloat16``): bf16 rounding
is chaotic through the deep network (``test_torch_port_bf16.py``), so the
heads of the two packages differ by about the bf16-fp32 gap.  That moves
scores by up to ~0.02 (bf16 keeps 8 bits: a logit near -0.4 moves in steps
of 0.002), enough to carry a detection near ``track_thresh`` across it and
to renumber the tracks after it.  So at bf16 the results hold the same
images and, pooled over the sequence, at least ``BF16_MATCHED`` of each
package's items have an item of the other package in the same image at
IoU >= ``BF16_IOU`` with a score within ``BF16_SCORE_TOL``; ids are not
compared (measured: 0.9 or more of the items of each package match).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from deft_tpu_torch import test as port_test
from deft_tpu_torch.config import mot_config
from torch_port_recipes import (ROOT, first_frame, mot_dataset,
                                recipe_test_argv, seeded_checkpoint)

SIZE = dict(input_h=64, input_w=96, max_object=8)
BOX_TOL = 1e-3            # px
SCORE_TOL = 1e-4
BF16_IOU = 0.7
BF16_SCORE_TOL = 3e-2
BF16_MATCHED = 0.8


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's port models: the suite runs
    several test processes on one machine, and each one's default of a
    thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_test_module():
    spec = importlib.util.spec_from_file_location("deft_test_entry",
                                                  ROOT / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mot(tmp_path_factory):
    root = tmp_path_factory.mktemp("mot_entry")
    data = mot_dataset(root / "data")
    frame = first_frame(data, "val_half.json", "train")
    seeded_checkpoint(mot_config(**SIZE), frame, root / "model.pth", seed=3)
    return root


def run_both(root, dtype, monkeypatch):
    """Both packages' ``main`` on the same argv: (JAX, port) as (metrics,
    save_results json, results dir)."""
    monkeypatch.setenv("DEFT_COMPILE_CACHE", str(root / "jax_cache"))
    out = []
    for name, main in (("jax", jax_test_module().main),
                       ("port", port_test.main)):
        exp = root / f"exp_{name}_{dtype}"
        argv = recipe_test_argv(
            "mot", load_model=root / "model.pth", compute_dtype=dtype,
            data_dir=root / "data", exp_dir=exp, gpus=-1,
            save_results=True, device_warp=True,
            **{k: v for k, v in SIZE.items()})
        metrics = main(argv)
        save = exp / "tracking" / "mot17_train"
        with open(save / "save_results_mot.json") as f:
            results = json.load(f)
        out.append((metrics, results, save / "results_mot17halfval"))
    return out


def check_results(got, want, box_tol, score_tol):
    assert sorted(got) == sorted(want)
    n = 0
    for image_id, items in want.items():
        mine = got[image_id]
        assert [i["tracking_id"] for i in mine] == [
            i["tracking_id"] for i in items], image_id
        for a, b in zip(mine, items):
            assert a["class"] == b["class"] and a["active"] == b["active"]
            np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                       atol=box_tol)
            assert abs(a["score"] - b["score"]) <= score_tol
            n += 1
    return n


def test_mot_float32_equals_jax(mot, monkeypatch):
    (j_metrics, j_res, j_dir), (p_metrics, p_res, p_dir) = run_both(
        mot, "float32", monkeypatch)
    assert len(j_res) == 8
    assert check_results(p_res, j_res, BOX_TOL, SCORE_TOL) >= 16
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(p_dir)) == ["SYN-01.txt"]
    for name in names:
        text = (j_dir / name).read_text()
        assert (p_dir / name).read_text() == text
        assert text.count("\n") >= 8
    assert p_metrics == j_metrics
    assert p_metrics["overall"]["num_objects"] > 0


def iou(a, b) -> float:
    w = min(a[2], b[2]) - max(a[0], b[0])
    h = min(a[3], b[3]) - max(a[1], b[1])
    inter = max(w, 0.0) * max(h, 0.0)
    area = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]))
    return inter / (area - inter)


def matched_share(got, want) -> float:
    """The share of ``got``'s items with an item of ``want`` in the same
    image at IoU >= BF16_IOU and a score within BF16_SCORE_TOL."""
    hits = n = 0
    for image_id, items in got.items():
        for a in items:
            n += 1
            hits += any(iou(a["bbox"], b["bbox"]) >= BF16_IOU
                        and abs(a["score"] - b["score"]) <= BF16_SCORE_TOL
                        for b in want[image_id])
    return hits / n


def test_mot_bfloat16_close_to_jax(mot, monkeypatch):
    (_, j_res, _), (p_metrics, p_res, _) = run_both(mot, "bfloat16",
                                                    monkeypatch)
    assert sorted(p_res) == sorted(j_res)
    assert sum(len(v) for v in j_res.values()) >= 16
    assert matched_share(p_res, j_res) >= BF16_MATCHED
    assert matched_share(j_res, p_res) >= BF16_MATCHED
    assert set(p_metrics) == {"per_seq", "overall"}
