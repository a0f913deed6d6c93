"""The port's nuScenes converter against the JAX package's, on the CPU.

``deft_tpu_torch/tools/convert_nuscenes.py::convert`` must write the JSON
of ``tools/convert_nuscenes.py::convert`` byte for byte on the full v1.0
tables of ``synthetic_nuscenes.make_tables`` (the same float64 arithmetic
through the port's copies of ``Quaternion`` and ``compute_box_3d``), for
several rigs, frame sizes and a scene filter; ``compute_box_3d`` and
``Quaternion.inverse`` equal the JAX package's exactly.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from torch_port_recipes import ROOT  # noqa: F401  (puts tools/ on the path)

from deft_tpu_torch.data.synthetic_nuscenes import frame_path, make_tables
from deft_tpu_torch.tools.convert_nuscenes import convert


def _tables(root, samples, cameras, size):
    version = root / "v1.0-trainval"
    version.mkdir(parents=True)
    for name, rows in make_tables(samples, cameras=cameras, height=size[0],
                                  width=size[1]).items():
        (version / f"{name}.json").write_text(json.dumps(rows))
    return root


@pytest.mark.parametrize("samples,cameras,size,scenes", [
    (4, 6, (900, 1600), None),
    (12, 2, (90, 160), None),
    (3, 6, (450, 800), {"scene-0001"}),
    (3, 1, (450, 800), {"scene-0002"}),
])
def test_convert_equals_jax(tmp_path, samples, cameras, size, scenes):
    from convert_nuscenes import convert as jax_convert

    root = _tables(tmp_path, samples, cameras, size)
    jax_convert(str(root), "v1.0-trainval", "want.json", scenes)
    convert(str(root), "v1.0-trainval", "got.json", scenes)
    want = (root / "annotations" / "want.json").read_text()
    got = (root / "annotations" / "got.json").read_text()
    assert got == want
    out = json.loads(got)
    if scenes == {"scene-0002"}:
        assert out["images"] == [] and out["annotations"] == []
        return
    assert len(out["images"]) == samples * cameras
    assert out["annotations"], "no box in view"
    # camera-major: each camera's frames in sample order, then the next's
    sensors = [im["sensor_id"] for im in out["images"]]
    assert sum(a != b for a, b in zip(sensors, sensors[1:])) == cameras - 1
    assert [im["frame_id"] for im in out["images"][:samples]] == list(
        range(1, samples + 1))
    assert out["images"][0]["file_name"] == frame_path(0, 0)
    for key in ("location", "dim", "rotation_y", "depth", "alpha",
                "amodel_center", "attributes", "velocity"):
        assert key in out["annotations"][0], key
    assert {a["attributes"] for a in out["annotations"]} - {0}


def test_box_and_quaternion_match_jax():
    from deft_tpu.inference.ddd import compute_box_3d as jax_box
    from deft_tpu.inference.geometry import Quaternion as JaxQuaternion
    from deft_tpu_torch.inference.ddd import compute_box_3d
    from deft_tpu_torch.inference.geometry import Quaternion

    rng = np.random.RandomState(0)
    for _ in range(20):
        dim = rng.uniform(0.5, 5, 3)
        loc = rng.uniform(-20, 20, 3)
        rot = rng.uniform(-np.pi, np.pi)
        np.testing.assert_array_equal(compute_box_3d(dim, loc, rot),
                                      jax_box(dim, loc, rot))
        q = rng.normal(size=4)
        np.testing.assert_array_equal(Quaternion(q).inverse.q,
                                      JaxQuaternion(q).inverse.q)
