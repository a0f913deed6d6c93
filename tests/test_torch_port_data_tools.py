"""The port's copies of the JAX repo's data tools against the originals in
``tools/``, on the CPU:

* ``convert_mot_to_coco``: on the same ``tools/make_synthetic_mot.py``
  layout (two sequences, JPEG), every json and every half-split
  ``gt_*_half.txt`` byte-equal;
* ``convert_mot_det_to_results``: on that layout with a ``det/det.txt``
  per sequence (one of them empty of the half's frames), the results json
  byte-equal;
* ``extract_nuscenes_difficulty_splits``: on the port's synthetic nuScenes
  json (``tests/torch_port_layouts.py``, two scenes of the six-camera rig
  through ``convert_nuscenes``), every split and the difficulty table
  byte-equal, and the same report (its output paths aside);
* ``bench_dcn``: its layer table counts 16 DLA-34 layers (the JAX tool's
  32, ROADMAP C.3), its ``make_offsets`` equals the JAX tool's for the
  same seed in every regime, and it refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import shutil
import sys

import numpy as np
import pytest

from deft_tpu_torch.tools import (bench_dcn, convert_mot_det_to_results,
                                  convert_mot_to_coco,
                                  extract_nuscenes_difficulty_splits)
from torch_port_layouts import layout_nuscenes_train
from torch_port_recipes import ROOT

sys.path.insert(0, str(ROOT))
from tools import bench_dcn as jax_bench_dcn  # noqa: E402
from tools import convert_mot_det_to_results as jax_det_results  # noqa: E402
from tools import convert_mot_to_coco as jax_mot_to_coco  # noqa: E402
from tools import (  # noqa: E402
    extract_nuscenes_difficulty_splits as jax_difficulty)
from tools.make_synthetic_mot import make_sequence  # noqa: E402


def files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and p.suffix in (".json", ".txt")}


def run_main(main, argv):
    """``main`` of a tool with ``argv``, its stdout captured."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["tool"] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.fixture(scope="module")
def mot(tmp_path_factory):
    """Two synthetic sequences, one copy per package."""
    root = tmp_path_factory.mktemp("mot_tools")
    base = root / "base"
    for seq, seed in (("SYN-01", 1), ("SYN-02", 2)):
        make_sequence(str(base / "train"), seq, n_frames=9, w=160, h=120,
                      n_obj=3, seed=seed)
    rng = np.random.RandomState(3)
    rows = [f"{f},-1,{x:.1f},{y:.1f},{w:.1f},{h:.1f},{s:.3f}"
            for f in range(1, 10) for x, y, w, h, s in
            rng.uniform([0, 0, 8, 8, 0.1], [140, 100, 30, 50, 1.0], (3, 5))]
    (base / "train" / "SYN-01" / "det").mkdir()
    (base / "train" / "SYN-01" / "det" / "det.txt").write_text(
        "\n".join(rows[:12]) + "\n")      # frames 1-4 only
    (base / "train" / "SYN-02" / "det").mkdir()
    (base / "train" / "SYN-02" / "det" / "det.txt").write_text(
        "\n".join(rows) + "\n")
    for name in ("jax", "port"):
        shutil.copytree(base, root / name)
    return root


def test_convert_mot_to_coco_byte_equal(mot):
    jax_mot_to_coco.convert(str(mot / "jax"), "train", half=True)
    convert_mot_to_coco.main(["--data_dir", str(mot / "port")])
    want, got = files(mot / "jax"), files(mot / "port")
    assert sorted(got) == sorted(want)
    assert {str(p) for p in want} >= {
        "annotations/train.json", "annotations/train_half.json",
        "annotations/val_half.json", "train/SYN-01/gt/gt_val_half.txt"}
    for path, data in want.items():
        assert got[path] == data, path


def test_convert_mot_det_to_results_byte_equal(mot):
    out = {}
    for name in ("jax", "port"):
        data = mot / name
        if not (data / "annotations" / "val_half.json").exists():
            jax_mot_to_coco.convert(str(data), "train", half=True)
        flags = ["--data_dir", str(data), "--ann", "annotations/val_half.json",
                 "--out", "annotations/public_dets.json"]
        if name == "jax":
            run_main(jax_det_results.main, flags)
        else:
            convert_mot_det_to_results.main(flags)
        out[name] = (data / "annotations" / "public_dets.json").read_bytes()
    assert out["port"] == out["jax"]
    assert b'"bbox"' in out["jax"] and b": []" in out["jax"]


def test_extract_nuscenes_difficulty_splits_equal(tmp_path):
    data = layout_nuscenes_train(tmp_path / "data", samples=4,
                                 size=(90, 160), seed=2, cameras=2)
    ann = str(data / "annotations" / "train.json")
    want_report = run_main(jax_difficulty.main, ["--ann", ann, "--out_dir",
                                                 tmp_path / "jax"])
    got_report = io.StringIO()
    with contextlib.redirect_stdout(got_report):
        extract_nuscenes_difficulty_splits.main(
            ["--ann", ann, "--out_dir", str(tmp_path / "port")])
    assert (got_report.getvalue().replace(str(tmp_path / "port"), "OUT")
            == want_report.replace(str(tmp_path / "jax"), "OUT"))
    assert "tracks:" in want_report
    want, got = files(tmp_path / "jax"), files(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) == 4
    for path, blob in want.items():
        assert got[path] == blob, path


def test_bench_dcn_table_offsets_and_refusal(monkeypatch):
    assert len(bench_dcn.LAYERS) == 7
    assert sum(layer[4] for layer in bench_dcn.LAYERS) == 16
    assert [layer[:4] for layer in bench_dcn.LAYERS] == [
        layer[:4] for layer in jax_bench_dcn.LAYERS]
    assert sum(layer[4] for layer in jax_bench_dcn.LAYERS) == 32
    for regime in ("zero", "trained", "uniform"):
        got = bench_dcn.make_offsets(np.random.RandomState(7), 17, 30, 9,
                                     regime)
        want = jax_bench_dcn.make_offsets(np.random.RandomState(7), 17, 30,
                                          9, regime)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        bench_dcn.main(["--iters", "2", "--regimes", "trained"])
