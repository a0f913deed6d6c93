"""``python -m deft_tpu_torch.test`` under test-time geometry against the
JAX package's ``test.py``, on the CPU: MOT17's test line as
``test_torch_port_test_entry.py`` runs it (its data, seeded weights,
small input, ``--device_warp`` and tolerances; float32), plus the flag.

* ``--flip_test`` and ``--keep_res``: the ``save_results`` json has the
  same images and, per image, the same track ids with boxes within
  ``BOX_TOL`` px and scores within ``SCORE_TOL``; the MOT txt files are
  byte-equal, so ``run_eval``'s metric dicts are equal (under
  ``keep_res`` both runners warp on the host, by integer shifts);
* ``--fix_short 64``: the JAX runner warps with cv2 and the port with its
  numpy copy of cv2's warp, up to one uint8 step apart
  (``test_torch_port_geometry.py``), so the port's line alone: every
  frame of the split has results and the evaluator scores them.
"""

import json

import pytest

from deft_tpu_torch import test as port_test
from test_torch_port_test_entry import (BOX_TOL, SCORE_TOL,  # noqa: F401
                                        SIZE, check_results, few_threads,
                                        jax_test_module, mot)
from torch_port_recipes import recipe_test_argv


def run(root, main, name, flags):
    """``main`` on the line with ``flags``: (metrics, save_results json,
    results dir)."""
    exp = root / f"exp_{name}_{'_'.join(flags)}"
    argv = recipe_test_argv(
        "mot", load_model=root / "model.pth", compute_dtype="float32",
        data_dir=root / "data", exp_dir=exp, gpus=-1, save_results=True,
        device_warp=True, **flags, **SIZE)
    metrics = main(argv)
    save = exp / "tracking" / "mot17_train"
    with open(save / "save_results_mot.json") as f:
        results = json.load(f)
    return metrics, results, save / "results_mot17halfval"


@pytest.mark.parametrize("flags", [{"flip_test": True}, {"keep_res": True}],
                         ids=["flip_test", "keep_res"])
def test_mot_line_equals_jax(mot, monkeypatch, flags):
    monkeypatch.setenv("DEFT_COMPILE_CACHE", str(mot / "jax_cache"))
    j_metrics, j_res, j_dir = run(mot, jax_test_module().main, "jax", flags)
    p_metrics, p_res, p_dir = run(mot, port_test.main, "port", flags)
    assert len(j_res) == 8
    # tracks in at least half the frames (flip's average halves the peaks)
    assert check_results(p_res, j_res, BOX_TOL, SCORE_TOL) >= 4
    text = (j_dir / "SYN-01.txt").read_text()
    assert (p_dir / "SYN-01.txt").read_text() == text
    assert p_metrics == j_metrics


def test_mot_line_fix_short_runs(mot):
    metrics, results, out = run(mot, port_test.main, "port",
                                {"fix_short": 64})
    assert len(results) == 8
    assert sum(len(items) for items in results.values()) >= 8
    assert (out / "SYN-01.txt").is_file()
    assert metrics["overall"]["num_objects"] > 0
