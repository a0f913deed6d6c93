"""The PyTorch port's configuration, and its independence from JAX.

``deft_tpu_torch`` keeps its own copy of the configuration; every preset
must equal ``deft_tpu.config``'s field for field.  The port and
``chip_smoke.py`` must import neither JAX, flax nor anything of ``deft_tpu``
(the machine with the card has no JAX): checked in a fresh interpreter,
since this test process has JAX loaded already, and by a scan of the
sources.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from deft_tpu import config as jax_config
from deft_tpu_torch import config as port_config

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("preset", ["mot_config", "kitti_config",
                                    "nuscenes_config"])
@pytest.mark.parametrize("overrides", [{}, {"input_h": 64, "input_w": 128,
                                            "dla_node": "conv"}])
def test_presets_match_jax(preset, overrides):
    ref = getattr(jax_config, preset)(**overrides)
    got = getattr(port_config, preset)(**overrides)
    ref_fields = dataclasses.asdict(ref)
    got_fields = dataclasses.asdict(got)
    assert set(got_fields) == set(ref_fields)
    for name, value in ref_fields.items():
        assert got_fields[name] == value, name


def test_defaults_match_jax():
    assert dataclasses.asdict(port_config.Config()) == dataclasses.asdict(
        jax_config.Config())


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import deft_tpu_torch, deft_tpu_torch.inference.detector, "
        "deft_tpu_torch.convert, deft_tpu_torch.csrc.build, "
        "deft_tpu_torch.ops.cuda_dcn, deft_tpu_torch.train.run, "
        "deft_tpu_torch.train.trainer, deft_tpu_torch.train.losses, "
        "deft_tpu_torch.train.checkpoint, deft_tpu_torch.data.loader, "
        "deft_tpu_torch.data.generic_dataset, deft_tpu_torch.ops.gaussian, "
        "deft_tpu_torch.tools.make_synthetic_mot, "
        "deft_tpu_torch.tools.make_synthetic_kitti, "
        "deft_tpu_torch.tools.make_synthetic_nuscenes\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deft_tpu', 'tools', 'train', 'test', "
        "'bench', 'train_prediction') or m.startswith('make_synthetic_'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax)\b|from\s+(jax|jaxlib|flax)\b"
    r"|import\s+deft_tpu(\.|\s|$)|from\s+deft_tpu(\.|\s)"
    # the JAX repo's root modules, and its generators imported bare
    r"|(import|from)\s+(tools|train|test|bench|train_prediction"
    r"|make_synthetic_\w+)(\.|\s|$))", re.M)


@pytest.mark.parametrize("line, refused", [
    ("import jax.numpy as jnp", True),
    ("from flax import linen", True),
    ("import deft_tpu", True),
    ("from deft_tpu.ops import iou", True),
    ("from tools import make_synthetic_mot", True),
    ("import tools.make_synthetic_kitti", True),
    ("    from train import main", True),
    ("import test", True),
    ("from bench import run", True),
    ("from train_prediction import main", True),
    ("from make_synthetic_nuscenes import generate", True),
    ("import make_synthetic_mot", True),
    ("from deft_tpu_torch import test as port_test", False),
    ("from deft_tpu_torch.tools import make_synthetic_mot", False),
    ("from deft_tpu_torch.train import run", False),
    ("import deft_tpu_torch.bench", False),
    ("from testing_helpers import x", False),
    ("from recipe_lines import RECIPES", False),
])
def test_forbidden_imports_pattern(line, refused):
    assert (_FORBIDDEN.search(line + "\n") is not None) == refused


def test_sources_import_no_jax():
    files = sorted((ROOT / "deft_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "recipe_lines.py",
              ROOT / "tests" / "torch_port_layouts.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()}"
