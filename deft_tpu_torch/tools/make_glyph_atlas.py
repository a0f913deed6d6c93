"""Writes ``deft_tpu_torch/utils/glyphs.npz``, the text atlas of the numpy
visualizer (``utils/visualize.py``), from ``cv2.putText``'s Hershey
simplex font (public domain):

    python -m deft_tpu_torch.tools.make_glyph_atlas [--out PATH]

It needs cv2, so it runs where cv2 is installed, never on the drawing path.
For every style the JAX visualizer draws text in (``STYLES``: scale,
thickness, line type) it renders each of the 95 printable ASCII glyphs
alone, white on black, and stores its coverage (uint8, 255 = covered) with
its offset from the text origin and its advance.  cv2 (5.0) places each
glyph of a string at a whole-pixel advance from the one before, so a string
is its glyphs' coverages placed one after another (cv2 5.0 smooths the
strokes at LINE_8 as well); ``check`` renders random strings both ways,
white on black, and asserts that they agree within one step.

It also measures cv2's LINE_AA line filter (``measure_aa``): ``aa/filter``
[32, 3], the weight (0..255) of the three pixels across a horizontal line
at each 1/32 px position, and ``aa/slope`` [33], the total weight of a
line of slope s/32 over a horizontal one's.

Layout of the file, per style ``s`` (``style_key``): ``s/index`` [95, 6]
int32 rows (start in ``s/coverage``, height, width, x offset, y offset,
advance) and ``s/coverage``, every glyph's rows concatenated.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIRST, LAST = 32, 126           # the printable ASCII glyphs
# (scale, thickness, LINE_AA?) of every putText in deft_tpu/utils/
# visualize.py: labels 0.4/1/AA, plot_tracking's header 0.5/1/LINE_8 and
# ids 0.6/2/AA, track ids 0.5/1/AA
STYLES = ((0.4, 1, True), (0.5, 1, False), (0.6, 2, True), (0.5, 1, True))
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "utils", "glyphs.npz")
_CANVAS = (96, 160)
_ORG = (40, 60)


def style_key(scale: float, thickness: int, antialiased: bool) -> str:
    return f"s{scale:g}_t{thickness}_{'aa' if antialiased else 'l8'}"


def _render(cv2, text: str, style, org=_ORG, shape=_CANVAS) -> np.ndarray:
    scale, thickness, aa = style
    img = np.zeros(shape + (3,), np.uint8)
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale,
                (255, 255, 255), thickness, cv2.LINE_AA if aa else cv2.LINE_8)
    return img[..., 0]


def _offset_of(cv2, prefix: str, char: str, style) -> int:
    """Columns from the origin to ``char`` drawn after ``prefix``."""
    alone = _render(cv2, char, style).astype(np.int32)
    after = (_render(cv2, prefix + char, style).astype(np.int32)
             - _render(cv2, prefix, style).astype(np.int32))
    for dx in range(_CANVAS[1] - _ORG[0]):
        moved = np.zeros_like(alone)
        moved[:, dx:] = alone[:, :alone.shape[1] - dx]
        if np.array_equal(moved, after):
            return dx
    raise AssertionError(f"no whole-pixel offset for {prefix!r}+{char!r}")


def build(cv2) -> dict:
    arrays = {}
    for style in STYLES:
        space = _offset_of(cv2, " ", "H", style)
        index = np.zeros((LAST - FIRST + 1, 6), np.int32)
        chunks, start = [], 0
        for code in range(FIRST, LAST + 1):
            char = chr(code)
            img = _render(cv2, char, style)
            ys, xs = np.nonzero(img)
            if len(ys):
                y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
                cov = img[y0:y1, x0:x1]
            else:
                y0 = x0 = 0
                cov = np.zeros((0, 0), np.uint8)
            advance = (space if char == " "
                       else _offset_of(cv2, char + " ", "H", style) - space)
            index[code - FIRST] = (start, cov.shape[0], cov.shape[1],
                                   x0 - _ORG[0], y0 - _ORG[1], advance)
            chunks.append(cov.reshape(-1))
            start += cov.size
        key = style_key(*style)
        arrays[f"{key}/index"] = index
        arrays[f"{key}/coverage"] = np.concatenate(chunks)
    arrays.update(measure_aa(cv2))
    return arrays


def _alpha(out: np.ndarray) -> np.ndarray:
    """The LINE_AA weight a (0..255) whose write on black gives ``out``:
    (255 * a + 127) >> 8."""
    a = np.arange(256)
    written = (255 * a + 127) >> 8
    return np.searchsorted(written, np.asarray(out, np.int64))


def measure_aa(cv2) -> dict:
    filt = np.zeros((32, 3), np.int32)
    for k in range(32):
        img = np.zeros((16, 80, 3), np.uint8)
        y = 8 * 32 + k
        cv2.line(img, (2 * 32, y), (70 * 32, y), (255, 255, 255), 1,
                 cv2.LINE_AA, 5)
        yy = (y << 11) + (1 << 15)
        base, dist = (yy >> 16) - 1, (yy >> 11) & 31
        filt[dist] = _alpha(img[base:base + 3, 40, 0])
    slope = np.zeros(33, np.float64)
    flat = filt.sum(1).mean()
    for s in range(33):
        img = np.zeros((300, 300, 3), np.uint8)
        dx = 256
        dy = dx if s == 32 else int(round(dx * (s + 0.5) / 32))
        cv2.line(img, (10, 10), (10 + dx, 10 + dy), (255, 255, 255), 1,
                 cv2.LINE_AA)
        major = img[:, 30:250, 0] if s < 32 else img[30:250, :, 0].T
        slope[s] = _alpha(major).sum(0).mean() / flat
    return {"aa/filter": filt, "aa/slope": slope}


def check(cv2, path: str, strings: int = 200, seed: int = 0):
    """Random strings through cv2 and through the atlas, white on black,
    within one step; returns the largest difference."""
    from deft_tpu_torch.utils.visualize import put_text

    rng = np.random.RandomState(seed)
    worst = 0
    for style in STYLES:
        for _ in range(strings // len(STYLES)):
            text = "".join(chr(c) for c in rng.randint(FIRST, LAST + 1,
                                                       rng.randint(1, 12)))
            org = (int(rng.randint(-5, 60)), int(rng.randint(0, 70)))
            want = _render(cv2, text, style, org, (80, 200))
            got = np.zeros((80, 200, 3), np.uint8)
            put_text(got, text, org, style[0], (255, 255, 255), style[1],
                     style[2], atlas=path)
            diff = np.abs(got[..., 0].astype(int) - want.astype(int)).max()
            worst = max(worst, int(diff))
            assert diff <= 1, (style, text, org, diff)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    import cv2

    np.savez_compressed(args.out, **build(cv2))
    print(f"wrote {args.out}; random strings against cv2: worst step "
          f"{check(cv2, args.out)}")


if __name__ == "__main__":
    main()
