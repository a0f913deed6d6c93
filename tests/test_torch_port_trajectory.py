"""The port's ``TrajectoryDataset`` against the JAX package's, on the CPU.

Both read the same COCO json and draw from the same ``random`` and
``np.random`` seeds; the port's samples must equal the JAX ones exactly
(the same draws in the same order, the same float operations), including
the indices the retry loop replaces:

* 2-D: one ``tools/make_synthetic_mot.py`` sequence of 30 frames
  (``tools/convert_mot_to_coco.py``'s ``train.json``), 11-d features and 5
  future deltas;
* 3-D: ``synthetic_nuscenes.make_tables`` (20 samples, 3 cameras) through
  ``tools/convert_nuscenes.convert``, 18-d global-frame features and 4
  future deltas, windows within one camera.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

from torch_port_recipes import ROOT  # noqa: F401  (puts tools/ on the path)

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.trajectory_dataset import (
    TrajectoryDataset as JaxTrajectoryDataset)
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.data.datasets import get_dataset
from deft_tpu_torch.data.synthetic_nuscenes import make_tables

DRAWS = 24
ARGV = {"mot": ["tracking", "--dataset", "mot", "--dataset_version",
                "17trainval"],
        "nuscenes": ["tracking,ddd", "--dataset", "nuscenes"]}


def mot_train_json(root) -> str:
    """``mot17/annotations/train.json`` of a 30-frame synthetic sequence."""
    from convert_mot_to_coco import convert
    from make_synthetic_mot import make_sequence

    data = root / "mot17"
    make_sequence(str(data / "train"), "SYN-01", n_frames=30, w=192, h=128,
                  n_obj=4, seed=1)
    convert(str(data), "train", half=False)
    return str(data / "annotations" / "train.json")


def nuscenes_train_json(root, samples=20, cameras=3) -> str:
    """``make_tables`` as v1.0 tables, converted by the JAX package's
    ``tools/convert_nuscenes.py`` into ``annotations/train.json``."""
    from convert_nuscenes import convert

    version = root / "v1.0-trainval"
    version.mkdir(parents=True)
    for name, rows in make_tables(samples, cameras=cameras, height=90,
                                  width=160).items():
        (version / f"{name}.json").write_text(json.dumps(rows))
    convert(str(root), "v1.0-trainval", "train.json")
    return str(root / "annotations" / "train.json")


@pytest.fixture(scope="module")
def ann_paths(tmp_path_factory):
    return {"mot": mot_train_json(tmp_path_factory.mktemp("mot")),
            "nuscenes": nuscenes_train_json(tmp_path_factory.mktemp("ns"))}


def _draws(ds, indices, seed):
    random.seed(seed)
    np.random.seed(seed)
    return [ds[int(i)] for i in indices]


@pytest.mark.parametrize("dataset", ["mot", "nuscenes"])
def test_trajectories_equal_jax(ann_paths, dataset):
    jcfg, _ = jax_parse_config(ARGV[dataset])
    pcfg, _ = parse_config(ARGV[dataset])
    want_ds = JaxTrajectoryDataset(jcfg, "train", ann_paths[dataset])
    got_ds = get_dataset(dataset, prediction_model=True)(
        pcfg, "train", ann_paths[dataset])
    assert len(got_ds) == len(want_ds)
    # every index of the dataset, the invalid ones included, twice over
    indices = np.random.RandomState(7).randint(0, len(want_ds), DRAWS)
    want = _draws(want_ds, indices, 3)
    got = _draws(got_ds, indices, 3)
    dims = {"mot": (11, 5), "nuscenes": (18, 4)}[dataset]
    lengths = set()
    for (wt, wy), (gt, gy) in zip(want, got):
        assert gt.dtype == wt.dtype == np.float32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gy, wy)
        assert gt.shape[1] == dims[0] and gy.shape == (dims[1], 4)
        lengths.add(gt.shape[0])
    # the drops give trajectories of several lengths
    assert len(lengths) > 1
    assert got_ds._invalid == want_ds._invalid
    assert got_ds._valid_cache == want_ds._valid_cache


def test_nuscenes_windows_stay_in_one_camera(ann_paths):
    """Camera-major ``sample_data``: every valid window's images are of one
    sensor, so the common tracks of the window exist."""
    cfg, _ = parse_config(ARGV["nuscenes"])
    ds = get_dataset("nuscenes", prediction_model=True)(
        cfg, "train", ann_paths["nuscenes"])
    random.seed(0)
    np.random.seed(0)
    for i in range(ds.max_dis + 2, len(ds) - 1):
        if ds._index_valid(i):
            sensors = {ds._load_frame(j)[0]["sensor_id"]
                       for j in range(i - ds.max_dis, i + ds.max_dis_fut + 1)}
            assert len(sensors) == 1, i
    ds[ds.max_dis + 2]
    assert any(ds._valid_cache.values())


def test_default_paths_match_jax():
    """``train_prediction.py`` reads ``data/<dataset>/...`` under the
    working directory, whatever ``--data_dir`` says."""
    from deft_tpu.data.trajectory_dataset import default_paths as want
    from deft_tpu_torch.data.trajectory_dataset import default_paths as got

    for argv in (ARGV["mot"], ARGV["nuscenes"],
                 ["tracking", "--dataset", "kitti_tracking",
                  "--dataset_version", "train", "--data_dir", "elsewhere"]):
        assert (got(parse_config(argv)[0], "train")
                == want(jax_parse_config(argv)[0], "train"))
