"""Visual debugging board, the counterpart of ``deft_tpu/utils/visualize.py``:
heatmap colormap blending, detection and track overlays with stable per-id
colours, 3-D box projection and bird's-eye-view panels, the per-frame
tracking plots of ``--save_video`` (``plot_tracking``,
``plot_tracking_ddd``) and the ``--debug`` board (``Debugger``).

The JAX module draws with cv2, which the card's machine lacks, so this one
draws in numpy alone, with cv2's pixel rules (cv2 5.0):

* thick LINE_8 lines (``line``, ``arrowed_line``): each segment a convex
  polygon 2 x thickness/2 wide in 16.16 fixed point, scan-filled and
  outlined as cv2 does, with a round cap of radius (thickness + 1) // 2
  at each end: axis-aligned segments as cv2 draws them, others within a
  few pixels (a rounding apart on about 1% of segments);
* ``rectangle`` at thickness 2, every board's: its edges as slices
  (``_band``), the polygon fill's pixels at a tenth of its time;
* ``circle_filled``: the pixels within the radius;
* LINE_AA lines: cv2's three-pixel filter per step along the major axis,
  with the effective weights and slope corrections measured from cv2
  (``glyphs.npz``, ``aa/*``), at most a full write per pixel; thicker
  ones the polygon filled solid, its edges so filtered, and disc caps;
* ``put_text``: cv2's Hershey simplex glyphs from the atlas
  ``glyphs.npz`` (``tools/make_glyph_atlas.py``), placed at cv2's whole
  pixel advances, their coverages blended (cv2 5.0 smooths Hershey text
  at every line type; the type changes the coverage);
* ``apply_colormap_jet``: cv2's 256-entry JET table; ``add_weighted``:
  cv2's float32 blend (a fused multiply-add) rounded half to even;
  ``resize``: ``ops/warp.py::resize_linear`` (cv2's INTER_LINEAR).

``VideoWriter`` writes an ``mp4v`` file through ``cv2.VideoWriter`` where
cv2 imports, as the JAX one does; where it does not (the card's machine),
each frame goes to ``video_<id>/<n:06d>.png`` beside the path it was given
(``data/image_io.py::imwrite_png``), and the log says so once.  Boards are
saved as PNG through the same writer.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional

import numpy as np

from deft_tpu_torch.data.image_io import imwrite_png
from deft_tpu_torch.ops.warp import resize_linear

ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "glyphs.npz")
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_FIRST_GLYPH, _LAST_GLYPH = 32, 126
_log = logging.getLogger(__name__)

# cv2's COLORMAP_JET, BGR, for gray levels 0..255
_JET_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080")
JET = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)

_ATLASES: Dict[str, dict] = {}


def _atlas(path: Optional[str] = None) -> dict:
    path = path or ATLAS_PATH
    if path not in _ATLASES:
        with np.load(path) as data:
            _ATLASES[path] = {k: data[k] for k in data.files}
    return _ATLASES[path]


def _style_key(scale: float, thickness: int, antialiased: bool) -> str:
    return f"s{scale:g}_t{thickness}_{'aa' if antialiased else 'l8'}"


# ---- pixel writes ------------------------------------------------------------

def _set(img, ys, xs, color):
    """Solid colour at the pixels (ys, xs) that lie in the image."""
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = np.asarray(color, np.uint8)[:img.shape[2]]


def _blend(img, ys, xs, alpha, color):
    """cv2's LINE_AA write: c += ((colour - c) * a + 127) >> 8 with a in
    0..256, at each (ys, xs) in the image, in order."""
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    alpha = np.broadcast_to(np.asarray(alpha, np.int64), ys.shape)
    ok = ((ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
          & (alpha > 0))
    ys, xs, alpha = ys[ok], xs[ok], alpha[ok]
    col = np.asarray(color, np.int64)[:img.shape[2]]
    # one pixel may be written twice by one primitive: apply in order
    flat = ys * img.shape[1] + xs
    _, first = np.unique(flat, return_index=True)
    if len(first) == len(flat):
        cur = img[ys, xs].astype(np.int64)
        img[ys, xs] = (cur + (((col - cur) * alpha[:, None] + 127) >> 8)
                       ).astype(np.uint8)
        return
    for y, x, a in zip(ys, xs, alpha):
        cur = img[y, x].astype(np.int64)
        img[y, x] = (cur + (((col - cur) * a + 127) >> 8)).astype(np.uint8)


# ---- lines -------------------------------------------------------------------

def _div_trunc(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, p1, p2):
    """cv2's ``clipLine`` of a segment to [0, width-1] x [0, height-1]
    (16.16 fixed point when the sizes are): the clipped ends, or None."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def _line2_points(p1, p2, shape):
    """cv2's ``Line2``: the 8-connected pixels of a segment between 16.16
    fixed-point ends, clipped to an image of ``shape``."""
    clipped = _clip_line(shape[1] << _XY_SHIFT, shape[0] << _XY_SHIFT, p1, p2)
    if clipped is None:
        return []
    (x1, y1), (x2, y2) = clipped
    half = _XY_ONE >> 1
    pts = [((x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT)]
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
        step = _div_trunc(dy << _XY_SHIFT, dx | 1)
        count = (x2 - x1) >> _XY_SHIFT
        x, y = (x1 + half) >> _XY_SHIFT, y1 + half
        for k in range(count + 1):
            pts.append((x + k, (y + k * step) >> _XY_SHIFT))
    else:
        if dy < 0:
            x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
        step = _div_trunc(dx << _XY_SHIFT, dy | 1)
        count = (y2 - y1) >> _XY_SHIFT
        y, x = (y1 + half) >> _XY_SHIFT, x1 + half
        for k in range(count + 1):
            pts.append(((x + k * step) >> _XY_SHIFT, y + k))
    return pts


def _bresenham(p1, p2):
    """cv2's 8-connected ``LineIterator`` from p1 to p2 (whole pixels)."""
    (x, y), (x2, y2) = p1, p2
    sx, sy = (1 if x2 >= x else -1), (1 if y2 >= y else -1)
    dx, dy = abs(x2 - x), abs(y2 - y)
    major_x = dx >= dy
    if not major_x:
        dx, dy = dy, dx
    err = dx - 2 * dy
    pts = []
    for _ in range(dx + 1):
        pts.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if major_x:
            x += sx
            y += sy if minor else 0
        else:
            y += sy
            x += sx if minor else 0
    return pts


def _fill_convex(img, pts, color, antialiased: bool):
    """cv2's ``FillConvexPoly`` of 16.16 fixed-point vertices: the outline
    (``Line2``, or ``LineAA``), then per row the span between the two
    edges' x, which steps from each edge's upper vertex."""
    n = len(pts)
    for i in range(n):
        if antialiased:
            _line_aa_fixed(img, pts[i - 1], pts[i], color)
        else:
            line_pts = _line2_points(pts[i - 1], pts[i], img.shape)
            if line_pts:
                xs, ys = zip(*line_pts)
                _set(img, ys, xs, color)
    delta = _XY_ONE >> 1
    delta1, delta2 = ((_XY_ONE - 1, 0) if antialiased else (delta, delta))
    xs = [(p[0] + delta) >> _XY_SHIFT for p in pts]
    ys = [(p[1] + delta) >> _XY_SHIFT for p in pts]
    if (max(xs) < 0 or max(ys) < 0 or min(xs) >= img.shape[1]
            or min(ys) >= img.shape[0]):
        return
    imin = min(range(n), key=lambda i: pts[i][1])
    y = (pts[imin][1] + delta) >> _XY_SHIFT
    ymax = min((max(p[1] for p in pts) + delta) >> _XY_SHIFT,
               img.shape[0] - 1)
    edges = [{"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": y},
             {"idx": imin, "di": n - 1, "x": -_XY_ONE, "dx": 0, "ye": y}]
    left_to_scan = n
    ymin = y
    rows, spans = [], []
    while True:
        if not antialiased or y < ymax or y == ymin:
            for e in edges:
                if y < e["ye"]:
                    continue
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while left_to_scan > 0:
                    left_to_scan -= 1
                    ty = (pts[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=((xe - xs) * 2 + (ty - y))
                                 // (2 * (ty - y)))
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
        if left_to_scan < 0:
            break
        if y >= 0:
            lo, hi = sorted((edges[0]["x"], edges[1]["x"]))
            rows.append(y)
            spans.append(((lo + delta1) >> _XY_SHIFT,
                          (hi + delta2) >> _XY_SHIFT))
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break
    width = img.shape[1]
    col = np.asarray(color, np.uint8)[:img.shape[2]]
    for row, (x1, x2) in zip(rows, spans):
        if x2 >= 0 and x1 < width:
            img[row, max(x1, 0):min(x2, width - 1) + 1] = col


def _disc(img, center, radius, color):
    cx, cy = center
    r = int(radius)
    ys, xs = np.mgrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
    inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    _set(img, ys[inside], xs[inside], color)


def _band(img, p0, p1, color):
    """``_thick_line`` of an axis-aligned LINE_8 segment of thickness 2, as
    slices: the polygon is the segment's rows (or columns) -1..+1, the
    outline lies inside it, and each end's radius-1 cap adds the pixel
    past it (clipping the segment first changes no pixel in the image).
    The rectangles of every board take it: the same pixels as the polygon
    fill, about ten times faster (PERF.md)."""
    (x0, y0), (x1, y1) = p0, p1
    h, w = img.shape[:2]
    col = np.asarray(color, np.uint8)[:img.shape[2]]
    if y0 == y1:
        xa, xb = min(x0, x1), max(x0, x1)
        img[max(y0 - 1, 0):max(y0 + 2, 0), max(xa, 0):max(xb + 1, 0)] = col
        _set(img, (y0, y0), (xa - 1, xb + 1), color)
    else:
        ya, yb = min(y0, y1), max(y0, y1)
        img[max(ya, 0):max(yb + 1, 0), max(x0 - 1, 0):max(x0 + 2, 0)] = col
        _set(img, (ya - 1, yb + 1), (x0, x0), color)


def _thick_line(img, p0, p1, color, thickness, antialiased):
    """cv2's ``ThickLine`` for thickness > 1 between whole-pixel ends,
    which cv2 (5.0) first clips to the image grown by the thickness."""
    m = thickness
    clipped = _clip_line(img.shape[1] + 2 * m, img.shape[0] + 2 * m,
                         (p0[0] + m, p0[1] + m), (p1[0] + m, p1[1] + m))
    if clipped is None:
        return
    p0, p1 = ((x - m, y - m) for x, y in clipped)
    f0 = (int(p0[0]) << _XY_SHIFT, int(p0[1]) << _XY_SHIFT)
    f1 = (int(p1[0]) << _XY_SHIFT, int(p1[1]) << _XY_SHIFT)
    dx = float(p0[0] - p1[0])
    dy = float(p1[1] - p0[1])
    r2 = dx * dx + dy * dy
    half = (thickness << (_XY_SHIFT - 1)) + (thickness & 1) * _XY_ONE * 0.5
    if r2 > 0:
        r = half / math.sqrt(r2)
        dpx, dpy = int(round(dy * r)), int(round(dx * r))
        pts = [(f0[0] + dpx, f0[1] + dpy), (f0[0] - dpx, f0[1] - dpy),
               (f1[0] - dpx, f1[1] - dpy), (f1[0] + dpx, f1[1] + dpy)]
        _fill_convex(img, pts, color, antialiased)
    radius = (thickness + 1) // 2
    for c in (p0, p1):
        if antialiased:
            _cap_aa(img, c, thickness << (_XY_SHIFT - 1), color)
        else:
            _disc(img, (int(c[0]), int(c[1])), radius, color)


def _line_aa_fixed(img, p1, p2, color):
    """A LINE_AA segment between 16.16 fixed-point ends: per step along the
    major axis three pixels across it, weighted by the filter measured
    from cv2 at the step's sub-pixel position (1/32 px) and by the slope's
    correction."""
    data = _atlas()
    filt, slope_corr = data["aa/filter"], data["aa/slope"]
    clipped = _clip_line(img.shape[1] << _XY_SHIFT, img.shape[0] << _XY_SHIFT,
                         p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    swap = abs(y2 - y1) > abs(x2 - x1)
    if swap:
        x1, y1, x2, y2 = y1, x1, y2, x2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    ax = x2 - x1
    step = _div_trunc((y2 - y1) << _XY_SHIFT, ax | 1)
    count = ((x2 + _XY_ONE) >> _XY_SHIFT) - (x1 >> _XY_SHIFT)
    j = -(x1 & (_XY_ONE - 1))
    y = y1 + ((step * j) >> _XY_SHIFT) + (_XY_ONE >> 1)
    slope_idx = min(abs(step) >> (_XY_SHIFT - 5), 32)
    k = np.arange(count + 1, dtype=np.int64)
    yk = y + k * step
    base = (yk >> _XY_SHIFT) - 1
    dist = (yk >> (_XY_SHIFT - 5)) & 31
    weights = filt[dist] * slope_corr[slope_idx]           # [K, 3]
    ends = np.ones(len(k))
    if len(k) >= 2:
        ends[0] = ends[-2] = 0.62
        ends[-1] = 0.0
    weights = np.minimum(np.round(weights * ends[:, None]), 256).astype(np.int64)
    major = (x1 >> _XY_SHIFT) + k
    minors = base[:, None] + np.arange(3)[None, :]
    majors = np.broadcast_to(major[:, None], minors.shape)
    ys, xs = (majors, minors) if swap else (minors, majors)
    _blend(img, ys.reshape(-1), xs.reshape(-1), weights.reshape(-1), color)


def _cap_aa(img, center, radius: int, color):
    """cv2's LINE_AA cap: ``EllipseEx``'s polygon of a circle of 16.16
    ``radius`` (its angle step 90 degrees below 3 px, 30 below 10, 18
    below 15, else 5), filled as ``_fill_convex`` fills."""
    r_px = (radius + (_XY_ONE >> 1)) >> _XY_SHIFT
    step = 90 if r_px < 3 else 30 if r_px < 10 else 18 if r_px < 15 else 5
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    pts = []
    for deg in range(0, 360, step):
        p = (cx + int(round(radius * math.cos(math.radians(deg)))),
             cy + int(round(radius * math.sin(math.radians(deg)))))
        if not pts or p != pts[-1]:
            pts.append(p)
    _fill_convex(img, pts, color, True)


def line(img, p0, p1, color, thickness: int = 1, antialiased: bool = False):
    """``cv2.line(img, p0, p1, color, thickness, LINE_AA or LINE_8)`` on a
    uint8 [H, W, 3] image, in place; ends are whole pixels."""
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if thickness > 1:
        _thick_line(img, p0, p1, color, thickness, antialiased)
    elif antialiased:
        _line_aa_fixed(img, (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT),
                       (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT), color)
    else:
        xs, ys = zip(*_bresenham(p0, p1))
        _set(img, ys, xs, color)
    return img


def rectangle(img, p1, p2, color, thickness: int = 1):
    """``cv2.rectangle(img, p1, p2, color, thickness)`` (LINE_8): its four
    edges as ``line``, at thickness 2 (every board's) as ``_band``."""
    (x1, y1), (x2, y2) = p1, p2
    corners = [(int(x1), int(y1)), (int(x2), int(y1)), (int(x2), int(y2)),
               (int(x1), int(y2))]
    for i in range(4):
        if thickness == 2:
            _band(img, corners[i], corners[(i + 1) % 4], color)
        else:
            line(img, corners[i], corners[(i + 1) % 4], color, thickness)
    return img


def arrowed_line(img, pt1, pt2, color, thickness: int = 1,
                 tip_length: float = 0.1):
    """``cv2.arrowedLine`` (LINE_8): the shaft, then two tip strokes at
    +-45 degrees, ``tip_length`` of the shaft long."""
    line(img, pt1, pt2, color, thickness)
    tip = math.hypot(pt1[0] - pt2[0], pt1[1] - pt2[1]) * tip_length
    angle = math.atan2(pt1[1] - pt2[1], pt1[0] - pt2[0])
    for sign in (1, -1):
        p = (int(round(pt2[0] + tip * math.cos(angle + sign * math.pi / 4))),
             int(round(pt2[1] + tip * math.sin(angle + sign * math.pi / 4))))
        line(img, p, pt2, color, thickness)
    return img


def circle_filled(img, center, radius: int, color):
    """``cv2.circle(img, center, radius, color, -1)``: the pixels within
    ``radius`` of the centre."""
    _disc(img, (int(center[0]), int(center[1])), int(radius), color)
    return img


def put_text(img, text: str, org, scale: float, color, thickness: int = 1,
             antialiased: bool = False, atlas: Optional[str] = None):
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, LINE_AA or LINE_8)`` at a style of the atlas, in place:
    each glyph's coverage a blends c += ((colour - c) * a + 127) >> 8."""
    data = _atlas(atlas)
    key = _style_key(scale, thickness, antialiased)
    index, coverage = data[f"{key}/index"], data[f"{key}/coverage"]
    h, w = img.shape[:2]
    col = np.asarray(color, np.int64)[:img.shape[2]]
    pen_x, org_y = int(org[0]), int(org[1])
    for char in text:
        code = ord(char)
        if not _FIRST_GLYPH <= code <= _LAST_GLYPH:
            code = ord("?")
        start, gh, gw, dx, dy, advance = (int(v) for v in
                                          index[code - _FIRST_GLYPH])
        x0, y0 = pen_x + dx, org_y + dy
        pen_x += advance
        ya, yb = max(y0, 0), min(y0 + gh, h)
        xa, xb = max(x0, 0), min(x0 + gw, w)
        if ya >= yb or xa >= xb:
            continue
        cov = coverage[start:start + gh * gw].reshape(gh, gw)[
            ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int64)
        patch = img[ya:yb, xa:xb]
        alpha = (cov * 256 + 127) // 255
        cur = patch.astype(np.int64)
        patch[...] = (cur + (((col - cur) * alpha[..., None] + 127) >> 8)
                      ).astype(np.uint8)
    return img


# ---- colour maps and blends --------------------------------------------------

def apply_colormap_jet(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, COLORMAP_JET)``: uint8 [H, W] -> BGR."""
    return JET[np.asarray(gray, np.uint8)]


def add_weighted(a: np.ndarray, wa: float, b: np.ndarray, wb: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` of two uint8 images, as its float32 loop
    computes it: fma(a, wa, b * wb) (one rounding) plus gamma, rounded half
    to even."""
    bw = b.astype(np.float32) * np.float32(wb)
    out = (a.astype(np.float64) * np.float64(np.float32(wa))
           + bw.astype(np.float64)).astype(np.float32) + np.float32(gamma)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR)."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img.copy()
    return resize_linear(img, out_w, out_h)


# ---- the JAX module's drawing functions --------------------------------------

def get_color(idx: int):
    """Stable id -> BGR colour (image.py:415-419)."""
    idx = int(idx) * 3
    return ((37 * idx) % 255, (17 * idx) % 255, (29 * idx) % 255)


def blend_heatmap(img: np.ndarray, hm: np.ndarray, alpha: float = 0.5):
    """Overlay a [h, w] or [h, w, C] heatmap on a uint8 image."""
    if hm.ndim == 3:
        hm = hm.max(axis=-1)
    hm8 = np.clip(hm * 255, 0, 255).astype(np.uint8)
    hm8 = resize(hm8, img.shape[1], img.shape[0])
    return add_weighted(img, 1 - alpha, apply_colormap_jet(hm8), alpha, 0)


def draw_detections(img: np.ndarray, dets, thresh: float = 0.3,
                    class_names=None):
    out = img.copy()
    for d in dets:
        if d.get("score", 1.0) < thresh:
            continue
        b = np.asarray(d["bbox"], int)
        cls = int(d.get("class", 1))
        color = get_color(cls)
        rectangle(out, (b[0], b[1]), (b[2], b[3]), color, 2)
        label = f"{class_names[cls - 1]}" if class_names else f"c{cls}"
        put_text(out, f"{label} {d.get('score', 0):.2f}",
                 (b[0], max(b[1] - 4, 10)), 0.4, color, 1, True)
    return out


def plot_tracking(img: np.ndarray, tracks, frame_id: int = 0,
                  fps: float = 0.0, show_ids: bool = True):
    """Per-frame track overlay (image.py:422-470).  ``tracks``: objects
    with ``tlwh`` and ``track_id`` (``STrack``) or dicts with ``bbox``
    (tlbr) and ``tracking_id``."""
    out = np.ascontiguousarray(img.copy())
    put_text(out, f"frame {frame_id} fps {fps:.1f} n {len(tracks)}",
             (4, 14), 0.5, (0, 0, 255), 1)
    for t in tracks:
        if hasattr(t, "tlwh"):
            x, y, w, h = t.tlwh
            tid = t.track_id
        else:
            bx = t["bbox"]
            x, y, w, h = bx[0], bx[1], bx[2] - bx[0], bx[3] - bx[1]
            tid = t.get("tracking_id", 0)
        color = get_color(tid)
        p1 = (int(x), int(y))
        p2 = (int(x + w), int(y + h))
        rectangle(out, p1, p2, color, 2)
        if show_ids:
            put_text(out, str(int(tid)), (p1[0], max(p1[1] - 4, 10)), 0.6,
                     color, 2, True)
    return out


def draw_box_3d(img: np.ndarray, corners_2d: np.ndarray, color=(0, 255, 0)):
    """Projected 3-D box (ddd_utils.py:71-117): ``corners_2d`` [8, 2]."""
    c = corners_2d.astype(int)
    face_idx = [[0, 1, 5, 4], [1, 2, 6, 5], [3, 0, 4, 7], [2, 3, 7, 6]]
    for ind, face in enumerate(face_idx):
        for j in range(4):
            line(img, c[face[j]], c[face[(j + 1) % 4]], color,
                 2 if ind == 0 else 1, True)
    return img


def plot_tracking_ddd(img: np.ndarray, tracks, calib: np.ndarray,
                      frame_id: int = 0):
    """3-D track overlay: projected boxes coloured by id
    (image.py:473-526)."""
    from deft_tpu_torch.inference.ddd import compute_box_3d, project_to_image

    out = np.ascontiguousarray(img.copy())
    for t in tracks:
        box = getattr(t, "org_ddd_box", None)
        if box is None:
            continue
        box = np.asarray(box, np.float64)   # [h, w, l, x, y, z, rot]
        corners = compute_box_3d(box[:3], box[3:6], box[6])
        pts = project_to_image(corners.astype(np.float32), calib)
        draw_box_3d(out, pts, get_color(t.track_id))
    return out


def bird_eye_view(tracks, size: int = 384, max_range: float = 60.0):
    """BEV panel of 3-D tracks (debugger's bird-view board).  A track's box
    is its ``org_ddd_box``, else its ``ddd_bbox``; the JAX function picks
    with ``or``, which raises on an array box (ROADMAP C.3)."""
    canvas = np.full((size, size, 3), 230, np.uint8)
    line(canvas, (size // 2, size), (size // 2, 0), (180, 180, 180), 1)
    for t in tracks:
        box = getattr(t, "org_ddd_box", None)
        if box is None:
            box = getattr(t, "ddd_bbox", None)
        if box is None:
            continue
        box = np.asarray(box, np.float64)
        x, z = box[3], box[5]
        px = int(size / 2 + x / max_range * size / 2)
        pz = int(size - z / max_range * size)
        if 0 <= px < size and 0 <= pz < size:
            circle_filled(canvas, (px, pz), 4, get_color(t.track_id))
    return canvas


class VideoWriter:
    """Overlay video sink (test.py:200-292's ``cv2.VideoWriter``): an
    ``mp4v`` file where cv2 imports, else one PNG per frame in
    ``video_<id>/`` beside ``path`` (module docstring).  ``frames`` counts
    the frames written."""

    def __init__(self, path: str, fps: int = 10):
        self.path = path
        self.fps = fps
        self.frames = 0
        self._writer = None
        self.png_dir = None

    def write(self, frame: np.ndarray):
        if self._writer is None and self.png_dir is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            try:
                import cv2
            except ImportError:
                cv2 = None
            if cv2 is not None:
                self._writer = cv2.VideoWriter(
                    self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps,
                    (frame.shape[1], frame.shape[0]))
            else:
                self.png_dir = os.path.splitext(self.path)[0]
                os.makedirs(self.png_dir, exist_ok=True)
                _log.warning("cv2 is not installed: %s is written as PNG "
                             "frames in %s", os.path.basename(self.path),
                             self.png_dir)
        if self._writer is not None:
            self._writer.write(frame)
        else:
            imwrite_png(os.path.join(self.png_dir, f"{self.frames:06d}.png"),
                        np.ascontiguousarray(frame))
        self.frames += 1

    def release(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def _class_palette(n: int) -> np.ndarray:
    """Deterministic per-class BGR palette (PASCAL-VOC bit-reversal map)."""
    out = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c = i + 1
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        out[i] = (b, g, r)
    return out


class Debugger:
    """Named-image debug board (debugger.py:21-899 surface: themes,
    per-class heatmap colormaps, boxes, pose skeletons, track ids, arrows,
    blend and save)."""

    # COCO-17 skeleton (debugger.py:40-85): edges, left/right edge colours,
    # per-joint colours
    num_joints = 17
    edges = [
        [0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 6], [5, 7],
        [7, 9], [6, 8], [8, 10], [5, 11], [6, 12], [11, 12], [11, 13],
        [13, 15], [12, 14], [14, 16],
    ]
    ec = [
        (255, 0, 0), (0, 0, 255), (255, 0, 0), (0, 0, 255), (255, 0, 0),
        (0, 0, 255), (255, 0, 255), (255, 0, 0), (255, 0, 0), (0, 0, 255),
        (0, 0, 255), (255, 0, 0), (0, 0, 255), (255, 0, 255), (255, 0, 0),
        (255, 0, 0), (0, 0, 255), (0, 0, 255),
    ]
    colors_hp = [(128, 0, 128)] + [(128, 0, 0), (0, 0, 128)] * 8

    def __init__(self, cfg=None, dataset=None, theme: Optional[str] = None):
        self.imgs: Dict[str, np.ndarray] = {}
        self.cfg = cfg
        self.theme = theme or getattr(cfg, "debugger_theme", "white")
        self.class_names = list(getattr(dataset, "class_name", []) or [])
        self.down_ratio = getattr(cfg, "down_ratio", 4)
        self._palette = _class_palette(max(len(self.class_names), 80))
        self.track_color: Dict[int, tuple] = {}

    def clear(self):
        self.imgs = {}

    def _class_color(self, cat: int):
        c = self._palette[int(cat) % len(self._palette)].astype(np.float32)
        if self.theme == "white":
            # dark-on-light: invert and cap brightness (debugger.py:35-37)
            c = np.clip(255.0 - c, 0.0, 0.6 * 255.0)
        return tuple(int(v) for v in c)

    def add_img(self, img, img_id="default"):
        self.imgs[img_id] = np.ascontiguousarray(img.copy())

    def add_blend_img(self, back, fore, img_id="blend", trans=0.7):
        """Blend a coloured foreground (``gen_colormap``'s) over an image;
        a single-channel float foreground gets the JET blend."""
        back = np.ascontiguousarray(back)
        if fore.ndim == 3 and fore.dtype == np.uint8:
            if fore.shape[:2] != back.shape[:2]:
                fore = resize(fore, back.shape[1], back.shape[0])
            out = back.astype(np.float32) * (1.0 - trans) + \
                fore.astype(np.float32) * trans
            self.imgs[img_id] = np.clip(out, 0, 255).astype(np.uint8)
        else:
            self.imgs[img_id] = blend_heatmap(back, fore, alpha=trans)

    # ---- per-class heatmap colormaps (debugger.py:133-171; NHWC here) -----

    def _gen_colormap(self, hm: np.ndarray, colors: np.ndarray, output_res):
        hm = hm.copy().astype(np.float32)
        hm[hm == 1] = 0.5                   # ignore regions (debugger.py:136)
        h, w, c = hm.shape
        if output_res is None:
            output_res = (h * self.down_ratio, w * self.down_ratio)
        colors = colors.reshape(-1, 3)[:c].reshape(1, 1, c, 3).astype(
            np.float32)
        cm = (hm[..., None] * colors).max(axis=2).astype(np.uint8)
        return resize(cm, output_res[1], output_res[0])

    def gen_colormap(self, hm: np.ndarray, output_res=None) -> np.ndarray:
        """[h, w, C] class heatmap -> coloured uint8 map, one colour per
        class (debugger.py:133-152)."""
        colors = np.array([self._class_color(i) for i in range(hm.shape[-1])],
                          np.float32)
        return self._gen_colormap(hm, colors, output_res)

    def gen_colormap_hp(self, hm: np.ndarray, output_res=None) -> np.ndarray:
        """[h, w, J] keypoint heatmap -> per-joint coloured map
        (debugger.py:154-171)."""
        colors = np.array(self.colors_hp, np.float32)
        if self.theme == "white":
            colors = 255.0 - colors
        return self._gen_colormap(hm, colors, output_res)

    # ---- overlays ----------------------------------------------------------

    def add_coco_bbox(self, bbox, cat, conf=1.0, img_id="default"):
        b = np.asarray(bbox, int)
        color = self._class_color(int(cat))
        rectangle(self.imgs[img_id], (b[0], b[1]), (b[2], b[3]), color, 2)
        name = (self.class_names[int(cat)] if int(cat) < len(self.class_names)
                else str(int(cat)))
        put_text(self.imgs[img_id], f"{name} {conf:.2f}",
                 (b[0], max(b[1] - 4, 10)), 0.4, color, 1, True)

    def add_tracking_id(self, ct, tracking_id, img_id="default"):
        """Track-id label at the object centre (debugger.py:264-277)."""
        put_text(self.imgs[img_id], f"{int(tracking_id)}",
                 (int(ct[0]), int(ct[1])), 0.5, (255, 0, 255), 1, True)

    def add_coco_hp(self, points, tracking_id=0, img_id="default"):
        """COCO-17 pose skeleton (debugger.py:278-310): per-joint dots and
        left/right coloured limbs, clipped to the image."""
        pts = np.asarray(points, np.int32).reshape(self.num_joints, 2)
        img = self.imgs[img_id]
        h, w = img.shape[:2]
        for j in range(self.num_joints):
            if 0 <= pts[j, 0] < w and 0 <= pts[j, 1] < h:
                circle_filled(img, (pts[j, 0], pts[j, 1]), 3,
                              self.colors_hp[j])
        for j, e in enumerate(self.edges):
            if (pts[e].min() > 0 and pts[e, 0].max() < w
                    and pts[e, 1].max() < h):
                line(img, pts[e[0]], pts[e[1]], self.ec[j], 2, True)

    def add_arrow(self, start, end, img_id="default"):
        arrowed_line(self.imgs[img_id], tuple(int(v) for v in start),
                     tuple(int(v) for v in end), (255, 0, 255), 2)

    def save_all_imgs(self, path, prefix=""):
        os.makedirs(path, exist_ok=True)
        for name, img in self.imgs.items():
            imwrite_png(os.path.join(path, f"{prefix}{name}.png"), img)
