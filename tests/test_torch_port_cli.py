"""``deft_tpu_torch.cli`` and the new entry modules, on the CPU.

* Every ``train.py`` / ``test.py`` line of ``experiments/*.sh`` parses to
  the same ``Config``, field by field, and the same runtime options under
  the port's ``parse_config`` as under ``deft_tpu.cli``'s.
* ``--gpus`` keeps the reference's meaning: ``-1`` is the CPU, otherwise the
  first id names the CUDA device; ``deft_tpu_torch.test.main`` with the
  default ``--gpus`` raises where CUDA is absent, before it reads anything.
* The port's CLI and test-entry modules import neither JAX nor
  ``deft_tpu``, nor cv2 or PIL (checked in a fresh interpreter), and no
  module of the port imports cv2 or PIL outside a function.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from deft_tpu import cli as jax_cli
from deft_tpu_torch import cli as port_cli
from deft_tpu_torch import test as port_test
from torch_port_recipes import ROOT, recipe_lines

LINES = recipe_lines()


def test_every_recipe_line_is_found():
    scripts = sorted({(r, s) for r, s, _ in LINES})
    assert scripts == [(r, s) for r in ("kitti", "mot", "nuscenes")
                       for s in ("test.py", "train.py",
                                 "train_prediction.py")]


@pytest.mark.parametrize("key", sorted(LINES), ids=lambda k: f"{k[0]}-{k[1]}")
def test_recipe_line_parses_as_jax(key):
    argv = LINES[key]
    want, want_extras = jax_cli.parse_config(argv)
    got, got_extras = port_cli.parse_config(argv)
    ref = dataclasses.asdict(want)
    mine = dataclasses.asdict(got)
    assert set(mine) == set(ref)
    for name, value in ref.items():
        assert mine[name] == value, name
    assert got_extras.pop("device") == torch.device("cuda", 0)
    assert got_extras == want_extras


@pytest.mark.parametrize("gpus, device", [
    ("-1", torch.device("cpu")), ("0", torch.device("cuda", 0)),
    ("2,3", torch.device("cuda", 2))])
def test_gpus_picks_the_device(gpus, device):
    _, extras = port_cli.parse_config(["tracking", "--gpus", gpus])
    assert extras["device"] == device


def test_aliases_and_tuples():
    cfg, _ = port_cli.parse_config([
        "tracking", "--AFE", "false", "--max_frame_dist_AFE", "3",
        "--lr_step", "30,50", "--exp_id", "x", "--exp_dir", "e"])
    assert cfg.afe is False and cfg.max_frame_dist_afe == 3
    assert cfg.lr_step == (30, 50)
    assert cfg.save_dir == os.path.join("e", "tracking", "x")


def test_main_on_the_default_device_raises_without_cuda(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["tracking", "--dataset", "mot", "--data_dir",
            str(tmp_path / "none"), "--exp_dir", str(tmp_path / "exp")]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_test.main(argv)
    assert not (tmp_path / "exp").exists()


def test_debug_and_save_video_are_refused(tmp_path):
    for flag in (["--debug", "1"], ["--save_video"]):
        with pytest.raises(NotImplementedError, match="visualizer"):
            port_test.main(["tracking", "--gpus", "-1", "--exp_dir",
                            str(tmp_path)] + flag)


NEW_MODULES = ("deft_tpu_torch.cli", "deft_tpu_torch.test",
               "deft_tpu_torch.data.image_io",
               "deft_tpu_torch.data.coco_index",
               "deft_tpu_torch.data.generic_dataset",
               "deft_tpu_torch.data.datasets.mot",
               "deft_tpu_torch.data.datasets.kitti_tracking",
               "deft_tpu_torch.data.datasets.nuscenes",
               "deft_tpu_torch.utils.logger")


def test_new_modules_import_no_jax_cv2_or_pil():
    code = (
        "import sys, importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deft_tpu', 'cv2', 'PIL'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


_TOP_LEVEL_DECODER = re.compile(r"^(import|from)\s+(cv2|PIL)\b", re.M)


def test_no_module_imports_cv2_or_pil_at_import_time():
    files = sorted((ROOT / "deft_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        hit = _TOP_LEVEL_DECODER.search(path.read_text())
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0)}"
