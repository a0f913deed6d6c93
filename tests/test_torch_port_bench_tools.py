"""The port's own copies of the JAX repo's numpy tools, each against its
original under ``tools/`` on the same inputs, and the measuring tools of the
bench slice that need no model:

* ``tools/eval_mot.py``, ``eval_kitti.py`` and ``eval_nuscenes.py``: equal
  scores (and the nuScenes table) on tracker outputs perturbed from the
  ground truth (misses, false positives, id switches, jitter);
* ``tools/convert_kittitrack_to_coco.py``: byte-equal JSON files;
* ``trace_device_ms``: the union of a hand-made trace's device intervals
  against the JAX tool's ``union_ms``, CPU events left out;
* ``profile_cascade``: the synthetic load equal to the one the JAX tool
  feeds its tracker (recorded from its ``main``), in both regimes;
* ``bench_loader`` and ``soak_kitti``'s half-protocol ground truth at a
  tiny size (the JAX soak's ``write_val_half_gt`` on the same layout).
"""

import json
import sys

import numpy as np
import pytest

import tools.convert_kittitrack_to_coco as jax_convert_kitti
import tools.eval_kitti as jax_eval_kitti
import tools.eval_mot as jax_eval_mot
import tools.eval_nuscenes as jax_eval_nuscenes
import tools.trace_device_ms as jax_trace
from deft_tpu_torch.data.synthetic_kitti import make_sequence
from deft_tpu_torch.data.synthetic_nuscenes import make_tables
from deft_tpu_torch.tools import (bench_loader, convert_kittitrack_to_coco,
                                  eval_kitti, eval_mot, eval_nuscenes,
                                  profile_cascade, soak_kitti,
                                  trace_device_ms)


def perturbed_mot_rows(gt_rows, rng):
    """Tracker output from MOT gt rows: 10% missed, ids swapped from frame
    10 on for one pair, jittered boxes, a few false positives."""
    out = []
    for f, tid, x, y, w, h in gt_rows:
        if rng.rand() < 0.1:
            continue
        if f >= 10 and tid in (1, 2):
            tid = 3 - tid
        out.append((f, tid, x + rng.normal(0, 2), y + rng.normal(0, 2), w, h))
    for f in range(1, 21, 4):
        out.append((f, 99, rng.uniform(0, 500), rng.uniform(0, 300), 40, 80))
    return out


def write_mot(path, rows, gt=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    tail = ",1,1,1" if gt else ",1,-1,-1,-1"
    path.write_text("".join(f"{f},{t},{x:.2f},{y:.2f},{w:.2f},{h:.2f}{tail}\n"
                            for f, t, x, y, w, h in rows))


def test_eval_mot_matches_tools(tmp_path):
    rng = np.random.RandomState(0)
    for s in range(2):
        gt = [(f, t, 30.0 * t + 2 * f, 20.0 + f, 40.0, 90.0)
              for f in range(1, 21) for t in range(1, 7)]
        write_mot(tmp_path / "gt" / f"SEQ-{s}" / "gt" / "gt_val_half.txt", gt,
                  gt=True)
        write_mot(tmp_path / "res" / f"SEQ-{s}.txt",
                  perturbed_mot_rows(gt, rng))
    args = (str(tmp_path / "gt"), str(tmp_path / "res"), "_val_half")
    want = jax_eval_mot.evaluate_mot_dir(*args)
    got = eval_mot.evaluate_mot_dir(*args)
    assert got == want
    assert 0.0 < got["overall"]["mota"] < 1.0
    assert got["overall"]["num_switches"] > 0


def test_eval_kitti_matches_tools(tmp_path):
    _, rows = make_sequence(n_frames=16, height=96, width=320, n_objects=6,
                            seed=3)
    rng = np.random.RandomState(1)
    res = []
    for row in rows:
        parts = row.split()
        if rng.rand() < 0.15:
            continue
        for i in range(6, 10):
            parts[i] = f"{float(parts[i]) + rng.normal(0, 1.5):.2f}"
        res.append(" ".join(parts + ["0.9"]))
    (tmp_path / "gt").mkdir()
    (tmp_path / "res").mkdir()
    (tmp_path / "gt" / "0000.txt").write_text("\n".join(rows) + "\n")
    (tmp_path / "res" / "0000.txt").write_text("\n".join(res) + "\n")
    args = (str(tmp_path / "gt"), str(tmp_path / "res"))
    want = jax_eval_kitti.evaluate_kitti_dir(*args)
    got = eval_kitti.evaluate_kitti_dir(*args)
    assert got == want
    assert got["overall"]["mota"] > 0.0


def test_eval_nuscenes_matches_tools(tmp_path):
    tables = make_tables(n_samples=6, n_objects=12, seed=2, cameras=2,
                         height=90, width=160)
    version = tmp_path / "v1.0-trainval"
    version.mkdir()
    for name, rows in tables.items():
        (version / f"{name}.json").write_text(json.dumps(rows))
    gt, order = eval_nuscenes.load_gt(str(tmp_path))
    rng = np.random.RandomState(4)
    cat_of = {c["token"]: c["name"] for c in tables["category"]}
    inst_cat = {i["token"]: cat_of[i["category_token"]]
                for i in tables["instance"]}
    results = {tok: [] for tokens in order for tok in tokens}
    for a in tables["sample_annotation"]:
        cls = eval_nuscenes.tracking_name(inst_cat[a["instance_token"]])
        if not cls or rng.rand() < 0.1:
            continue
        xy = np.asarray(a["translation"][:2]) + rng.normal(0, 0.5, 2)
        results[a["sample_token"]].append({
            "sample_token": a["sample_token"],
            "translation": [float(xy[0]), float(xy[1]), 0.5],
            "tracking_name": cls, "tracking_id": a["instance_token"][-4:],
            "tracking_score": float(rng.uniform(0.3, 1.0))})
    sub = tmp_path / "results.json"
    sub.write_text(json.dumps({"results": results}))
    want = jax_eval_nuscenes.evaluate_submission(str(sub), str(tmp_path))
    got = eval_nuscenes.evaluate_submission(str(sub), str(tmp_path))
    assert got == want
    assert eval_nuscenes.format_table(got) == \
        jax_eval_nuscenes.format_table(want)
    assert got["overall"]["gt"] > 0 and got["overall"]["amota"] > 0.0


def kitti_layout(root, n_frames):
    _, rows = make_sequence(n_frames=n_frames, height=96, width=320,
                            n_objects=8, seed=5, classes=("Car", "Van",
                                                          "Pedestrian"))
    images = root / "data_tracking_image_2" / "training" / "image_02" / "0000"
    images.mkdir(parents=True)
    for f in range(n_frames):
        (images / f"{f:06d}.png").write_bytes(b"")
    for d, text in (("label_02", "\n".join(rows) + "\n"),
                    ("calib", "P2: 700.0 0.0 160.0 0.0 0.0 700.0 48.0 0.0 "
                              "0.0 0.0 1.0 0.0\n")):
        (root / d).mkdir()
        (root / d / "0000.txt").write_text(text)


def test_convert_kittitrack_matches_tools(tmp_path, capsys):
    for name in ("jax", "port"):
        kitti_layout(tmp_path / name, 12)
    jax_convert_kitti.convert(str(tmp_path / "jax"), "train")
    convert_kittitrack_to_coco.convert(str(tmp_path / "port"), "train")
    want = sorted((tmp_path / "jax" / "annotations").iterdir())
    got = sorted((tmp_path / "port" / "annotations").iterdir())
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) >= 3
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes(), a.name
    train = json.loads((tmp_path / "port" / "annotations"
                        / "tracking_train.json").read_text())
    assert len(train["images"]) == 12 and train["annotations"]


def test_trace_union_matches_tools():
    rng = np.random.RandomState(6)
    starts = rng.uniform(0, 1000, 60)
    iv = [(float(s), float(s + d)) for s, d in
          zip(starts, rng.uniform(0, 40, 60))]
    assert trace_device_ms.union_ms(iv) == jax_trace.union_ms(iv)
    events = [{"ph": "X", "cat": "kernel", "pid": 0, "ts": s, "dur": e - s}
              for s, e in iv[:40]]
    events += [{"ph": "X", "cat": "gpu_memcpy", "pid": 0, "ts": s,
                "dur": e - s} for s, e in iv[40:50]]
    events += [{"ph": "X", "cat": "kernel", "pid": 1, "ts": s, "dur": e - s}
               for s, e in iv[50:]]
    events += [{"ph": "X", "cat": "cpu_op", "pid": 0, "ts": 0.0,
                "dur": 5000.0},
               {"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "GPU 0"}}]
    out = trace_device_ms.device_busy({"traceEvents": events}, frames=4)
    lane0 = jax_trace.union_ms(iv[:50])
    lane1 = jax_trace.union_ms(iv[50:])
    assert out["busy_ms[device 0]"] == round(lane0, 3)
    assert out["busy_ms[device 1]"] == round(lane1, 3)
    assert out["device_busy_ms_total"] == round(lane0 + lane1, 3)
    assert out["device_ms_per_frame"] == round((lane0 + lane1) / 4, 3)
    span = (max(e for _, e in iv) - min(s for s, _ in iv)) / 1000.0
    assert out["device_span_ms"] == round(span, 3)


class _Recorder:
    """Stands in for the JAX ``Tracker`` in ``tools/profile_cascade.py``:
    records what each update is fed."""
    fed = []

    def __init__(self, *args, **kwargs):
        self.tracked_stracks = self.lost_stracks = self.removed_stracks = []

    def update(self, dets, _pre, sims=None):
        self.fed.append((dets, sims))
        return []


@pytest.mark.parametrize("churn", [False, True])
def test_profile_cascade_load_matches_tools(monkeypatch, churn):
    import deft_tpu.tracking.tracker as jax_tracker
    import tools.profile_cascade as jax_profile

    _Recorder.fed = []
    monkeypatch.setattr(jax_tracker, "Tracker", _Recorder)
    monkeypatch.setattr(sys, "argv", ["profile_cascade", "--frames", "14",
                                      "--dets", "30"]
                        + (["--churn"] if churn else []))
    jax_profile.main()
    got = profile_cascade.make_frames(14, 30, churn,
                                      np.random.RandomState(0))
    assert len(got) == len(_Recorder.fed) == 14
    for (gd, gs), (wd, ws) in zip(got, _Recorder.fed):
        np.testing.assert_array_equal(gs, ws)
        assert len(gd) == len(wd)
        for a, b in zip(gd, wd):
            np.testing.assert_array_equal(a["bbox"], b["bbox"])
            assert (a["score"], a["class"]) == (b["score"], b["class"])


def test_profile_cascade_runs_the_port_tracker():
    out = profile_cascade.main(["--frames", "14", "--dets", "20",
                                "--worker"])
    assert out["tracked"] > 0 and out["mean"] > 0


def test_bench_loader_on_the_cpu(tmp_path):
    """The loader's rate per worker count over a synthetic MOT layout, and
    one train step's time at the same batch, at a tiny size."""
    import torch

    torch.manual_seed(0)
    data = bench_loader.synthetic_mot(tmp_path, 8, (60, 100))
    ann = json.loads((data / "annotations" / "train.json").read_text())
    assert len(ann["images"]) == 8 and ann["annotations"]
    out = bench_loader.main(["--h", "32", "--w", "64", "--batch", "2",
                             "--steps", "1", "--workers", "0,2", "--frames",
                             "4", "--data_dir", str(data), "--dla_node",
                             "conv", "--fp32", "--device", "cpu"])
    assert out["per_workers"]["0"] > 0 and out["per_workers"]["2"] > 0
    assert out["train_step_ms"] > 0
    assert out["samples"] == 4 and "peak_device_bytes" not in out


def test_soak_val_half_gt_matches_tools(tmp_path):
    import tools.soak_kitti as jax_soak

    data = tmp_path / "kitti_tracking"
    soak_kitti.generate(data, 2, 10, 5, (96, 320), 3)
    assert (data / "annotations" / "tracking_val_half.json").exists()
    jax_soak.write_val_half_gt(str(data), str(tmp_path / "jax"))
    soak_kitti.write_val_half_gt(data, tmp_path / "port")
    for seq in ("0000.txt", "0001.txt"):
        want = (tmp_path / "jax" / seq).read_text()
        assert (tmp_path / "port" / seq).read_text() == want
        assert want and all(int(line.split()[0]) >= 4
                            for line in want.splitlines())
