"""The port's synthetic data generators (``deft_tpu_torch/tools/
make_synthetic_{mot,kitti,nuscenes}.py``) against the JAX repo's tools in
``tools/``, on the CPU, at small sizes:

* the pixels each tool hands its encoder, captured before any JPEG by
  replacing ``cv2.imwrite`` (the JAX tools import cv2 inside their
  functions, and the port's ``image_io.imwrite_jpeg`` calls it where cv2
  imports): MOT's default regime and nuScenes bit for bit, MOT
  ``--natural`` within one uint8 step on at most 1e-4 of the values (its
  cubic upsampling is ``ops/warp.py::resize_cubic``, not cv2's);
* the text files (``gt.txt``, ``label_02``, ``calib``, the ten nuScenes
  tables) byte-equal, and KITTI's PNG frames decoding to the JAX tool's
  pixels;
* the JPEG files: byte-equal to the JAX tool's through cv2, PIL's route
  byte-equal to cv2's, and ``EncoderMissing`` with neither;
* the chain generator -> ``convert_mot_to_coco`` of each package;
* each tool's flags and defaults, and ``python -m`` on each.

The MOT tool draws ``randint(10, h - 90)``, which needs a height above
100: at 160x96 both packages raise, so the default regime runs at 160x112.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from deft_tpu_torch.data import image_io
from deft_tpu_torch.ops.warp import resize_cubic
from deft_tpu_torch.tools import convert_mot_to_coco
from deft_tpu_torch.tools import make_synthetic_kitti as port_kitti
from deft_tpu_torch.tools import make_synthetic_mot as port_mot
from deft_tpu_torch.tools import make_synthetic_nuscenes as port_nuscenes

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools import convert_mot_to_coco as jax_mot_to_coco  # noqa: E402
from tools import make_synthetic_kitti as jax_kitti  # noqa: E402
from tools import make_synthetic_mot as jax_mot  # noqa: E402
from tools import make_synthetic_nuscenes as jax_nuscenes  # noqa: E402

TOOLS = {"mot": (port_mot, jax_mot), "kitti": (port_kitti, jax_kitti),
         "nuscenes": (port_nuscenes, jax_nuscenes)}
# --natural at 640x360 x 2 frames: frame values off by one uint8 step after
# the truncating cast, measured with cv2 5.0 (of 1,382,400 values)
NATURAL_OFF_BY_ONE = 2


def run_main(main, argv, port: bool):
    """A tool's ``main`` on ``argv`` (the port's takes it, the JAX tool's
    reads ``sys.argv``), its stdout captured."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["tool"] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(out):
            main([str(a) for a in argv]) if port else main()
    finally:
        sys.argv = saved
    return out.getvalue()


def run_both(tool, tmp_path, argv):
    """The tool of each package with ``--out <tmp>/<package>`` + argv:
    {package: root}."""
    roots = {}
    for package, module in zip(("port", "jax"), TOOLS[tool]):
        roots[package] = tmp_path / package
        run_main(module.main, ["--out", roots[package]] + argv,
                 port=package == "port")
    return roots


@pytest.fixture
def captured(monkeypatch):
    """``cv2.imwrite`` replaced: {path: the array it was given}; nothing is
    written."""
    frames = {}

    def imwrite(path, img, *args):
        frames[str(path)] = np.array(img, copy=True)
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return frames


def by_package(frames, roots):
    """{package: {path under its root: array}}."""
    return {package: {os.path.relpath(p, root): a for p, a in frames.items()
                      if p.startswith(str(root) + os.sep)}
            for package, root in roots.items()}


def text_files(root, suffixes=(".txt", ".json")):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.suffix in suffixes}


def test_mot_default_regime(tmp_path, captured):
    roots = run_both("mot", tmp_path, ["--seqs", 2, "--frames", 6,
                                       "--size", "160x112"])
    got = by_package(captured, roots)
    assert len(got["port"]) == 12 and got["port"].keys() == got["jax"].keys()
    for name, frame in got["jax"].items():
        assert frame.shape == (112, 160, 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(got["port"][name], frame, err_msg=name)
    texts = {p: text_files(r) for p, r in roots.items()}
    assert len(texts["port"]) == 2 and texts["port"] == texts["jax"]


def test_mot_natural(tmp_path, captured):
    roots = run_both("mot", tmp_path, ["--seqs", 1, "--frames", 2, "--size",
                                       "640x360", "--natural"])
    got = by_package(captured, roots)
    assert len(got["port"]) == 2 and got["port"].keys() == got["jax"].keys()
    values = off = 0
    for name, frame in got["jax"].items():
        diff = np.abs(got["port"][name].astype(np.int16) - frame)
        assert diff.max() <= 1, name
        values += frame.size
        off += int(np.count_nonzero(diff))
    assert off <= 1e-4 * values
    assert off == NATURAL_OFF_BY_ONE
    assert text_files(roots["port"]) == text_files(roots["jax"])


@pytest.mark.parametrize("w, h", [(160, 96), (640, 360), (1920, 1080)])
def test_resize_cubic_against_cv2(w, h):
    """``resize_cubic`` on ``_natural_bg``'s low-frequency field: within
    9.6e-7 of cv2's INTER_CUBIC (measured: at most 9.54e-7)."""
    base = np.random.RandomState(w).normal(
        0, 1, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    want = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(base, w, h)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 9.6e-7


@pytest.mark.parametrize("argv", [
    ["--seqs", 2, "--frames", 5],
    ["--rich", "--objects", 12, "--seed", 3, "--seqs", 1, "--frames", 4],
], ids=["default", "rich_main"])
def test_kitti_main(tmp_path, argv):
    """Through ``main``: the rich scene at its 384x1280."""
    roots = run_both("kitti", tmp_path, argv)
    texts = {p: text_files(r) for p, r in roots.items()}
    assert texts["port"] == texts["jax"] and len(texts["port"]) >= 2
    pngs = sorted(p.relative_to(roots["jax"])
                  for p in roots["jax"].rglob("*.png"))
    assert pngs == sorted(p.relative_to(roots["port"])
                          for p in roots["port"].rglob("*.png"))
    assert len(pngs) == argv[argv.index("--frames") + 1] * (
        argv[argv.index("--seqs") + 1])
    for name in pngs:
        want = cv2.imread(str(roots["jax"] / name))
        np.testing.assert_array_equal(
            image_io.imread(str(roots["port"] / name)), want, str(name))


def test_kitti_rich_sequence(tmp_path):
    """``make_rich_sequence`` at 256x96, 12 objects, 20 frames, where cars
    are cut by the left edge (``int`` truncates toward zero before the
    clamp, and the label's 3-D x keeps the unclamped x1) and by the right
    one."""
    for package, module in (("port", port_kitti), ("jax", jax_kitti)):
        module.make_rich_sequence(str(tmp_path / package), "0007",
                                  n_frames=20, w=256, h=96, n_obj=12, seed=2)
    texts = {p: text_files(tmp_path / p) for p in ("port", "jax")}
    assert texts["port"] == texts["jax"]
    rows = texts["jax"][Path("label_02/0007.txt")].decode().splitlines()
    left = [r for r in rows if float(r.split()[6]) == 0.0]
    right = [r for r in rows if float(r.split()[8]) == 256.0]
    assert len(rows) == 13 and len(left) == 6 and len(right) == 6
    assert all(float(r.split()[13]) < -2.5 for r in left)
    for f in range(20):
        name = f"data_tracking_image_2/training/image_02/0007/{f:06d}.png"
        np.testing.assert_array_equal(
            image_io.imread(str(tmp_path / "port" / name)),
            cv2.imread(str(tmp_path / "jax" / name)), name)


def test_nuscenes_generate(tmp_path, captured):
    roots = {}
    for package, module in (("port", port_nuscenes), ("jax", jax_nuscenes)):
        roots[package] = tmp_path / package
        with contextlib.redirect_stdout(io.StringIO()):
            module.generate(str(roots[package]), 3, 200, 112)
    texts = {p: text_files(r) for p, r in roots.items()}
    assert len(texts["port"]) == 10 and texts["port"] == texts["jax"]
    got = by_package(captured, roots)
    assert len(got["port"]) == 6 and got["port"].keys() == got["jax"].keys()
    drawn = 0
    for name, frame in got["jax"].items():
        np.testing.assert_array_equal(got["port"][name], frame, err_msg=name)
        drawn += int(np.any(frame != 90))
    assert drawn == 6


def test_jpeg_bytes_cv2_route(tmp_path):
    """Real files: the port's ``.jpg`` bytes are the JAX tool's (both through
    ``cv2.imwrite``), default and natural regimes, and nuScenes."""
    for tag, argv in (("default", ["--seqs", 1, "--frames", 3, "--size",
                                   "160x112"]),
                      ("natural", ["--seqs", 1, "--frames", 2, "--size",
                                   "320x180", "--natural"])):
        roots = run_both("mot", tmp_path / tag, argv)
        jpgs = sorted(p.relative_to(roots["jax"])
                      for p in roots["jax"].rglob("*.jpg"))
        assert len(jpgs) == argv[3]
        for name in jpgs:
            data = (roots["port"] / name).read_bytes()
            assert data.startswith(b"\xff\xd8\xff"), name
            assert data == (roots["jax"] / name).read_bytes(), name
    roots = run_both("nuscenes", tmp_path / "nuscenes",
                     ["--samples", 2, "--width", 200, "--height", 112])
    jpgs = sorted(p.relative_to(roots["jax"])
                  for p in roots["jax"].rglob("*.jpg"))
    assert len(jpgs) == 4
    for name in jpgs:
        assert (roots["port"] / name).read_bytes() == (
            roots["jax"] / name).read_bytes(), name


def test_jpeg_pil_route(tmp_path, monkeypatch):
    """With cv2's import failing, PIL writes the bytes cv2 writes (quality
    95, 4:2:0) for the generators' frames."""
    rng = np.random.RandomState(0)
    frames = {"natural": port_mot._natural_bg(rng, 320, 180),
              "noise": rng.randint(0, 256, (112, 160, 3)).astype(np.uint8)}
    for name, frame in frames.items():
        image_io.imwrite_jpeg(str(tmp_path / f"cv2_{name}.jpg"), frame)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, frame in frames.items():
        image_io.imwrite_jpeg(str(tmp_path / f"pil_{name}.jpg"), frame)
        assert (tmp_path / f"pil_{name}.jpg").read_bytes() == (
            tmp_path / f"cv2_{name}.jpg").read_bytes(), name
    run_main(port_mot.main, ["--out", tmp_path / "mot", "--seqs", 1,
                             "--frames", 2, "--size", "160x112"], port=True)
    monkeypatch.undo()
    jax_root = tmp_path / "jax"
    run_main(jax_mot.main, ["--out", jax_root, "--seqs", 1, "--frames", 2,
                            "--size", "160x112"], port=False)
    for f in (1, 2):
        name = f"train/SYN-01/img1/{f:06d}.jpg"
        assert (tmp_path / "mot" / name).read_bytes() == (
            jax_root / name).read_bytes(), name


def test_jpeg_encoder_missing(tmp_path, monkeypatch):
    """Neither cv2 nor PIL: ``EncoderMissing`` names the file, and no
    ``.jpg`` (nor any other frame) is left behind."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(image_io.EncoderMissing) as err:
        port_mot.main(["--out", str(tmp_path), "--seqs", "1", "--frames",
                       "2", "--size", "160x112"])
    first = tmp_path / "train" / "SYN-01" / "img1" / "000001.jpg"
    assert str(first) in str(err.value) and "cv2 or PIL" in str(err.value)
    assert not list(tmp_path.rglob("*.jpg"))
    assert not list((tmp_path / "train" / "SYN-01" / "img1").iterdir())
    with pytest.raises(image_io.EncoderMissing):
        port_nuscenes.generate(str(tmp_path / "nus"), 1, 64, 48)
    assert not list((tmp_path / "nus").rglob("*.jpg"))


def test_mot_chain_through_converter(tmp_path):
    """Generator then ``convert_mot_to_coco``, each package's own: the same
    ``annotations/*.json`` and ``gt_*_half.txt``."""
    roots = run_both("mot", tmp_path, ["--seqs", 2, "--frames", 8, "--size",
                                       "160x112"])
    run_main(convert_mot_to_coco.main, ["--data_dir", roots["port"]],
             port=True)
    run_main(jax_mot_to_coco.main, ["--data_dir", roots["jax"]], port=False)
    texts = {p: text_files(r) for p, r in roots.items()}
    names = {str(p) for p in texts["jax"]}
    assert {"annotations/train.json", "annotations/val_half.json",
            "train/SYN-02/gt/gt_val_half.txt"} <= names
    assert texts["port"] == texts["jax"]


class _Parsed(Exception):
    pass


def parser_of(main, port: bool) -> argparse.ArgumentParser:
    """The ``ArgumentParser`` that ``main`` builds, caught at its parse."""
    caught = []

    def parse_args(self, args=None, namespace=None):
        caught.append(self)
        raise _Parsed

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(_Parsed):
            run_main(main, [], port)
    finally:
        argparse.ArgumentParser.parse_args = saved
    return caught[0]


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_flags_match_jax(tool):
    port, jax = (parser_of(m.main, p)
                 for m, p in zip(TOOLS[tool], (True, False)))

    def flags(parser):
        return [(a.option_strings, a.dest, a.default, a.type, a.const,
                 a.nargs, type(a).__name__, a.help) for a in parser._actions]

    assert flags(port) == flags(jax)
    assert len(flags(port)) >= 5


def test_run_as_module(tmp_path):
    """``python -m deft_tpu_torch.tools.make_synthetic_<x>`` for the three
    tools, in one interpreter (``runpy``, as ``-m`` runs a module)."""
    code = (
        "import runpy, sys\n"
        "for name, argv in (\n"
        "        ('mot', ['--out', 'mot', '--seqs', '1', '--frames', '2',\n"
        "                 '--size', '160x112']),\n"
        "        ('kitti', ['--out', 'kitti', '--seqs', '1', '--frames', '2']),\n"
        "        ('nuscenes', ['--out', 'nus', '--samples', '1', '--width',\n"
        "                      '64', '--height', '48'])):\n"
        "    sys.argv = ['make_synthetic_' + name] + argv\n"
        "    runpy.run_module('deft_tpu_torch.tools.make_synthetic_' + name,\n"
        "                     run_name='__main__', alter_sys=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "synthetic MOT data at mot/train" in out.stdout
    assert "synthetic KITTI data at kitti" in out.stdout
    assert "1 samples x 2 cameras" in out.stdout
    assert len(list((tmp_path / "mot").rglob("*.jpg"))) == 2
    assert len(list((tmp_path / "kitti").rglob("*.png"))) == 2
    assert len(list((tmp_path / "nus").rglob("*.jpg"))) == 2
