"""Nothing the benchmark runs loads JAX, the JAX package or the JAX
repository's root scripts, compared by whole top-level module names; the
plain reference imports nothing of the program under test."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmarks import run

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "benchmarks" / "reference"

SCRIPT = """
import sys, torch
from benchmarks import run, control
from benchmarks.tests.tiny import run_cell
run_cell("mot17-track", seconds=2.0, trace=1)
names = sorted({n.split(".")[0] for n in sys.modules})
print(",".join(names))
print("FORBIDDEN:" + ",".join(run.forbidden_modules(run.Path.cwd())))
"""


def test_no_forbidden_module_after_runs():
    """A traced run of the cell in a fresh process; then the
    top-level names of every module the process holds."""
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    names = set(lines[-2].split(","))
    assert lines[-1] == "FORBIDDEN:"
    assert not names & {"jax", "jaxlib", "flax", "deft_tpu"}
    assert "deft_tpu_torch" in names and "benchmarks" in names
    for script in run.ROOT_SCRIPTS:
        if script in names:
            assert script == "test"          # the standard library's


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    """``deft_tpu_torch`` is allowed, ``deft_tpu`` and a root script of the
    checkout are not."""
    fake = type(sys)("deft_tpu.models")
    monkeypatch.setitem(sys.modules, "deft_tpu.models", fake)
    assert run.forbidden_modules(ROOT) == ["deft_tpu"]
    monkeypatch.delitem(sys.modules, "deft_tpu.models")
    script = type(sys)("bench")
    script.__file__ = str(ROOT / "bench.py")
    monkeypatch.setitem(sys.modules, "bench", script)
    assert run.forbidden_modules(ROOT) == ["bench"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "scipy", "math", "typing",
                           "collections", "__future__", "benchmarks"), (
                path.name, name)
            if top == "benchmarks":
                assert name.startswith("benchmarks.reference"), name
