"""``deft_tpu_torch.data.image_io`` against ``cv2.imread``, on the CPU.

With cv2 and PIL taken away (``sys.modules`` entries set to None, so their
imports fail), ``imread`` decodes PNG and PGM / PPM with the standard
library and numpy; it must give exactly what ``cv2.imread`` gives for files
cv2 writes:

* ``tools/make_synthetic_kitti.py`` frames as written (cv2's default PNG
  filter is Sub on every row);
* the same frames and a noise / gradient image rewritten with
  ``IMWRITE_PNG_ALL_FILTERS``, whose rows between them use all five
  filters (checked);
* RGBA (alpha dropped) and gray (expanded) PNGs, binary PPM and PGM.

With cv2 taken away and PIL present, ``imread`` decodes through PIL, to
the same arrays.  Also: ``imwrite_png`` round-trips through both decoders,
a missing or broken file gives None, and a JPEG without a decoder raises
naming it.  The module's own ``cv2`` binding stays usable as the
reference.
"""

import os
import sys
import zlib

import cv2
import numpy as np
import pytest

from deft_tpu_torch.data import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_synthetic_kitti import make_sequence  # noqa: E402


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 cannot be imported for the duration of the test."""
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.fixture
def no_decoders(no_cv2, monkeypatch):
    """Neither cv2 nor PIL can be imported for the duration of the test."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def _filters(path):
    """The filter type of every row of an 8-bit PNG."""
    data = open(path, "rb").read()
    idat = b"".join(body for kind, body in image_io._png_chunks(data)
                    if kind == b"IDAT")
    h = cv2.imread(path, cv2.IMREAD_UNCHANGED).shape[0]
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)
               .reshape(h, -1)[:, 0].tolist())


def _pattern(h=48, w=64, seed=0):
    """Noise, then gradients, then gradients with noise: rows on which
    libpng's adaptive filtering picks each of the five filters."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([(xx * 4) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256],
                    -1)
    mixed = np.stack([(xx * 4) % 256, (yy * 5) % 256, (xx * yy // 7) % 256],
                     -1) + rng.randint(0, 30, (h, w, 3))
    return np.concatenate([rng.randint(0, 256, (h, w, 3)), grad,
                           np.clip(mixed, 0, 255)]).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of the files the module docstring lists."""
    d = tmp_path_factory.mktemp("images")
    make_sequence(str(d), "0000", n_frames=3, seed=0)
    frames = sorted((d / "data_tracking_image_2" / "training" / "image_02"
                     / "0000").glob("*.png"))
    out = {f"kitti_{i}": str(p) for i, p in enumerate(frames)}
    all_filters = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
    for i, p in enumerate(frames):
        path = str(d / f"kitti_all_{i}.png")
        cv2.imwrite(path, cv2.imread(str(p)), all_filters)
        out[f"kitti_all_{i}"] = path
    pattern = _pattern()
    rgba = np.concatenate([pattern, np.arange(pattern[..., :1].size,
                                              dtype=np.int64).reshape(
        pattern.shape[:2] + (1,)).astype(np.uint8)], axis=2)
    for name, image, params in (
            ("pattern", pattern, all_filters),
            ("rgba", rgba, all_filters),
            ("gray", pattern[..., 1], all_filters)):
        out[name] = str(d / f"{name}.png")
        cv2.imwrite(out[name], image, params)
    out["ppm"] = str(d / "pattern.ppm")
    cv2.imwrite(out["ppm"], pattern)
    out["pgm"] = str(d / "gray.pgm")
    cv2.imwrite(out["pgm"], pattern[..., 2])
    return out


def test_files_cover_every_filter(files):
    seen = set()
    for name, path in files.items():
        if path.endswith(".png"):
            seen |= _filters(path)
    assert seen == {0, 1, 2, 3, 4}
    assert _filters(files["kitti_0"]) == {1}     # cv2's default: Sub


@pytest.mark.parametrize("name", ["kitti_0", "kitti_1", "kitti_2",
                                  "kitti_all_0", "kitti_all_1", "kitti_all_2",
                                  "pattern", "rgba", "gray", "ppm", "pgm"])
def test_stdlib_decoder_equals_cv2(files, name, no_decoders):
    path = files[name]
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    got = image_io.imread(path)
    want = cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["kitti_all_0", "rgba", "gray", "ppm"])
def test_pil_decoder_equals_cv2(files, name, no_cv2):
    import PIL.Image  # noqa: F401  (the decoder imread falls back to)
    np.testing.assert_array_equal(image_io.imread(files[name]),
                                  cv2.imread(files[name]))


@pytest.mark.parametrize("gray", [False, True])
def test_imwrite_png_round_trip(tmp_path, gray, no_decoders):
    image = _pattern(24, 40, seed=3)
    image = image[..., 0] if gray else image
    path = str(tmp_path / "x.png")
    image_io.imwrite_png(path, image)
    got = image_io.imread(path)
    want = np.repeat(image[..., None], 3, 2) if gray else image
    np.testing.assert_array_equal(got, want)
    assert _filters(path) == {0}
    np.testing.assert_array_equal(cv2.imread(path), want)


def test_jpeg_without_decoder_raises(tmp_path, no_decoders):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _pattern())
    with pytest.raises(image_io.DecoderMissing, match="JPEG needs cv2 or PIL"):
        image_io.imread(path)


def test_missing_and_broken_files_give_none(tmp_path, files, no_decoders):
    assert image_io.imread(str(tmp_path / "absent.png")) is None
    data = open(files["pattern"], "rb").read()
    broken = tmp_path / "broken.png"
    broken.write_bytes(data[: len(data) // 2])
    assert image_io.imread(str(broken)) is None


def test_unsupported_png_raises(tmp_path, no_decoders):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, (_pattern().astype(np.uint16) * 257))
    with pytest.raises(image_io.DecoderMissing, match="16-bit"):
        image_io.imread(path)


def test_cv2_is_used_when_present(files):
    np.testing.assert_array_equal(image_io.imread(files["pattern"]),
                                  cv2.imread(files["pattern"]))
