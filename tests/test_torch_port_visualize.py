"""The port's numpy visualizer (``deft_tpu_torch/utils/visualize.py``)
against the JAX package's cv2 one (``deft_tpu/utils/visualize.py``), on
the same seeded inputs, on the CPU.

Tolerances:

* exact: ``_class_palette``, ``get_color``, ``JET``, ``blend_heatmap`` and
  ``add_blend_img`` at the image's size, the thick rectangles of
  ``plot_tracking`` and ``add_coco_bbox`` (the board outside the text), the
  filled circles and line of ``bird_eye_view``;
* the colormaps, which cv2 resizes in fixed point: within
  ``RESIZE_TOL`` per channel;
* text, LINE_AA lines and arrows: the pixels either package changes
  (``marks``) overlap at IoU >= ``MARK_IOU``, and where both change a
  pixel the mean absolute difference per channel is <= ``MARK_MAD``;
* the line rasterizers alone against ``cv2.line`` (``test_lines_against_
  cv2``): axis-aligned LINE_8 segments of thickness 2 exactly, through
  ``_band`` and through the general polygon fill; thick LINE_8 segments
  of any direction within ``LINE8_PIXELS`` pixels per segment (cv2's
  polygon and the port's differ by a rounding on about 1% of segments);
  LINE_AA segments of thickness 1 and 2, slope +-1 included, as marks.

Backgrounds are smooth gradients with a few flat boxes, like the frames
the boards are drawn on.  ``tools/make_glyph_atlas.py``'s own check holds
the text atlas to cv2 within one step on random strings.
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest

import deft_tpu.utils.visualize as jax_vis
import deft_tpu_torch.utils.visualize as vis
from deft_tpu_torch.data.image_io import imread

MARK_IOU = 0.9
MARK_MAD = 16.0
RESIZE_TOL = 1
LINE8_PIXELS = 3


class Info:
    class_name = ["person", "car", "bike"]


class Track:
    """The attributes the drawing functions read from an ``STrack``."""

    def __init__(self, tid, tlwh, ddd=None):
        self.track_id = tid
        self.tlwh = np.asarray(tlwh, np.float64)
        self.org_ddd_box = ddd


def background(seed: int, h: int = 120, w: int = 160) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([40 + xx * 0.8, 60 + yy * 0.9, 120 + 0 * xx], -1)
    for _ in range(3):
        x0, y0 = rng.randint(0, w - 20), rng.randint(0, h - 20)
        img[y0:y0 + 20, x0:x0 + 20] = rng.randint(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def boxes(seed: int, n: int = 6, h: int = 120, w: int = 160):
    """Boxes [x1, y1, x2, y2], some reaching past the image."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-20, w - 10, n)
    y1 = rng.uniform(-20, h - 10, n)
    return np.stack([x1, y1, x1 + rng.uniform(8, 60, n),
                     y1 + rng.uniform(8, 60, n)], 1)


def tracks(seed: int):
    return [Track(int(i * 7 + 1), [b[0], b[1], b[2] - b[0], b[3] - b[1]])
            for i, b in enumerate(boxes(seed))]


def assert_marks_close(got, want, base):
    changed_got = (got != base).any(-1)
    changed_want = (want != base).any(-1)
    union = (changed_got | changed_want).sum()
    both = changed_got & changed_want
    assert union > 0
    iou = both.sum() / union
    mad = np.abs(got[both].astype(int) - want[both].astype(int)).mean()
    assert iou >= MARK_IOU, iou
    assert mad <= MARK_MAD, mad


# ---- exact ---------------------------------------------------------------


def _palette_and_colors():
    np.testing.assert_array_equal(vis._class_palette(80),
                                  jax_vis._class_palette(80))
    for i in range(600):
        assert vis.get_color(i) == jax_vis.get_color(i)
    gray = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(
        vis.apply_colormap_jet(gray), cv2.applyColorMap(gray,
                                                        cv2.COLORMAP_JET))


def _blends():
    rng = np.random.RandomState(1)
    img = background(1)
    for hm in (rng.uniform(0, 1, (120, 160)).astype(np.float32),
               rng.uniform(0, 1, (120, 160, 3)).astype(np.float32)):
        for alpha in (0.5, 0.7):
            np.testing.assert_array_equal(
                vis.blend_heatmap(img, hm, alpha),
                jax_vis.blend_heatmap(img, hm, alpha))
    fore = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    boards = []
    for module in (vis, jax_vis):
        dbg = module.Debugger(dataset=Info())
        dbg.add_blend_img(img, fore, "a")
        dbg.add_blend_img(img, np.full((120, 160), 0.25, np.float32), "b")
        boards.append(dbg.imgs)
    for key in ("a", "b"):
        np.testing.assert_array_equal(boards[0][key], boards[1][key])


def _rectangles():
    for seed in range(8):
        base = background(seed)
        got, want = base.copy(), base.copy()
        for b in boxes(seed).astype(int):
            color = vis.get_color(seed + b[0])
            vis.rectangle(got, (b[0], b[1]), (b[2], b[3]), color, 2)
            cv2.rectangle(want, (b[0], b[1]), (b[2], b[3]), color, 2)
        np.testing.assert_array_equal(got, want)
    # the boards drawn by plot_tracking away from its header text
    got = vis.plot_tracking(background(3), tracks(3), show_ids=False)
    want = jax_vis.plot_tracking(background(3), tracks(3), show_ids=False)
    np.testing.assert_array_equal(got[20:], want[20:])


def _circles_and_bev():
    for r in range(0, 12):
        got = np.zeros((40, 40, 3), np.uint8)
        want = got.copy()
        vis.circle_filled(got, (17, 21), r, (9, 200, 30))
        cv2.circle(want, (17, 21), r, (9, 200, 30), -1)
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(4)
    ts = [Track(i + 1, [0, 0, 1, 1], ddd=[1.5, 1.6, 4.0, x, 1.0, z, 0.1])
          for i, (x, z) in enumerate(zip(rng.uniform(-40, 40, 12),
                                         rng.uniform(-5, 70, 12)))]
    np.testing.assert_array_equal(vis.bird_eye_view(ts),
                                  jax_vis.bird_eye_view(ts))


@pytest.mark.parametrize("case", [_palette_and_colors, _blends, _rectangles,
                                  _circles_and_bev],
                         ids=lambda f: f.__name__.strip("_"))
def test_exact(case):
    case()


def test_colormaps_within_the_resize_step():
    rng = np.random.RandomState(5)
    hm = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    hm[2, 3, 0] = hm[7, 9, 2] = 1.0               # ignore regions
    hp = rng.uniform(0, 1, (12, 16, 17)).astype(np.float32)
    for theme in ("white", "black"):
        ours = vis.Debugger(dataset=Info(), theme=theme)
        theirs = jax_vis.Debugger(dataset=Info(), theme=theme)
        for got, want in ((ours.gen_colormap(hm), theirs.gen_colormap(hm)),
                          (ours.gen_colormap_hp(hp),
                           theirs.gen_colormap_hp(hp)),
                          (ours.gen_colormap(hm, (30, 50)),
                           theirs.gen_colormap(hm, (30, 50)))):
            assert got.shape == want.shape and got.dtype == np.uint8
            assert np.abs(got.astype(int) - want.astype(int)).max() <= (
                RESIZE_TOL)
    small = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    got, want = [m.Debugger(dataset=Info()) for m in (vis, jax_vis)]
    got.add_blend_img(background(5), small, "x")
    want.add_blend_img(background(5), small, "x")
    assert np.abs(got.imgs["x"].astype(int)
                  - want.imgs["x"].astype(int)).max() <= RESIZE_TOL


# ---- the line rasterizers ------------------------------------------------


def segments(seed: int, n: int = 200):
    """Seeded whole-pixel segments of a 120x160 image, ends up to 30 px
    past it; every fourth vertical, every fourth horizontal, and the four
    diagonals of slope +-1 through the centre."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (x0, y0, x1, y1) in enumerate(
            rng.uniform(-30, 190, (n, 4)).astype(int)):
        out.append(((x0, y0), (x0, y1) if i % 4 == 0 else
                    (x1, y0) if i % 4 == 1 else (x1, y1)))
    return out + [((20, 10), (110, 100)), ((110, 100), (20, 10)),
                  ((40, 110), (140, 10)), ((-10, 70), (60, 0))]


def _axis_aligned():
    for i, (p0, p1) in enumerate(segments(20)):
        if p0[0] != p1[0] and p0[1] != p1[1]:
            continue
        base = background(i % 4)
        want = cv2.line(base.copy(), p0, p1, (30, 200, 90), 2, cv2.LINE_8)
        for draw in (lambda img: vis._band(img, p0, p1, (30, 200, 90)),
                     lambda img: vis._thick_line(img, p0, p1, (30, 200, 90),
                                                 2, False)):
            got = base.copy()
            draw(got)
            np.testing.assert_array_equal(got, want, err_msg=str((p0, p1)))


def _line8():
    for thickness in (2, 3):
        for i, (p0, p1) in enumerate(segments(21 + thickness)):
            base = background(i % 4)
            got = vis.line(base.copy(), p0, p1, (30, 200, 90), thickness)
            want = cv2.line(base.copy(), p0, p1, (30, 200, 90), thickness,
                            cv2.LINE_8)
            assert (got != want).any(-1).sum() <= LINE8_PIXELS, (p0, p1)


def _line_aa():
    for thickness in (1, 2):
        lines = segments(30 + thickness, n=48)
        for k in range(0, len(lines), 6):       # boards of 6 segments
            base = background(k)
            got, want = base.copy(), base.copy()
            for j, (p0, p1) in enumerate(lines[k:k + 6]):
                # every other one near white: the full weights of cv2's
                # filter show there
                color = vis.get_color(j + k) if j % 2 else (250, 245, 255)
                vis.line(got, p0, p1, color, thickness, True)
                cv2.line(want, p0, p1, color, thickness, cv2.LINE_AA)
            assert_marks_close(got, want, base)


@pytest.mark.parametrize("case", [_axis_aligned, _line8, _line_aa],
                         ids=lambda f: f.__name__.strip("_"))
def test_lines_against_cv2(case):
    case()


# ---- text, antialiased lines, arrows ---------------------------------------


def _detections(module, base, seed):
    rng = np.random.RandomState(seed)
    dets = [{"bbox": b, "score": float(s), "class": int(c)}
            for b, s, c in zip(boxes(seed), rng.uniform(0, 1, 6),
                               rng.randint(1, 4, 6))]
    return module.draw_detections(base, dets, 0.2, Info.class_name)


def _tracking(module, base, seed):
    ts = tracks(seed)
    dicts = [{"bbox": [t.tlwh[0], t.tlwh[1], t.tlwh[0] + t.tlwh[2],
                       t.tlwh[1] + t.tlwh[3]], "tracking_id": t.track_id + 1}
             for t in ts]
    out = module.plot_tracking(base, ts, frame_id=seed, fps=12.5)
    return module.plot_tracking(out, dicts, frame_id=seed + 100)


def _board(module, base, seed):
    dbg = module.Debugger(dataset=Info())
    dbg.add_img(base, "generic")
    rng = np.random.RandomState(seed)
    for b, cat in zip(boxes(seed), rng.randint(0, 3, 6)):
        dbg.add_coco_bbox(b, cat, float(rng.uniform()), img_id="generic")
        dbg.add_tracking_id(((b[0] + b[2]) / 2, (b[1] + b[3]) / 2),
                            rng.randint(0, 300), img_id="generic")
    return dbg.imgs["generic"]


def _arrows(module, base, seed):
    dbg = module.Debugger(dataset=Info())
    dbg.add_img(base, "generic")
    rng = np.random.RandomState(seed)
    for _ in range(5):
        start = rng.uniform(0, 150, 2)
        dbg.add_arrow(start, start + rng.uniform(-40, 40, 2), "generic")
    return dbg.imgs["generic"]


def _pose(module, base, seed):
    dbg = module.Debugger(dataset=Info(), theme="black")
    dbg.add_img(base, "generic")
    rng = np.random.RandomState(seed)
    centre = rng.uniform(40, 100, 2)
    dbg.add_coco_hp(centre + rng.uniform(-30, 30, (17, 2)), img_id="generic")
    return dbg.imgs["generic"]


def _boxes_3d(module, base, seed):
    rng = np.random.RandomState(seed)
    calib = np.array([[120, 0, 80, 0], [0, 120, 60, 0], [0, 0, 1, 0]],
                     np.float32)
    ts = [Track(i + 1, [0, 0, 1, 1],
                ddd=[1.5, 1.7, 4.0, rng.uniform(-4, 4), 1.5,
                     rng.uniform(8, 20), rng.uniform(-3, 3)])
          for i in range(3)]
    return module.plot_tracking_ddd(base, ts, calib)


@pytest.mark.parametrize("draw", [_detections, _tracking, _board, _arrows,
                                  _pose, _boxes_3d],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("seed", [0, 1])
def test_marks_close_to_cv2(draw, seed):
    base = background(seed + 10)
    got = draw(vis, base.copy(), seed)
    want = draw(jax_vis, base.copy(), seed)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert_marks_close(got, want, base)


def test_save_all_imgs_names_and_pixels(tmp_path):
    boards = {}
    for name, module in (("port", vis), ("jax", jax_vis)):
        dbg = module.Debugger(dataset=Info())
        dbg.add_img(background(2), "generic")
        dbg.add_img(background(3), "previous")
        dbg.save_all_imgs(str(tmp_path / name), prefix="00001_")
        boards[name] = sorted(os.listdir(tmp_path / name))
    assert boards["port"] == boards["jax"] == ["00001_generic.png",
                                              "00001_previous.png"]
    for name in boards["port"]:
        np.testing.assert_array_equal(imread(str(tmp_path / "port" / name)),
                                      imread(str(tmp_path / "jax" / name)))


def test_video_writer_mp4_and_png_frames(tmp_path, monkeypatch):
    frames = [background(i) for i in range(3)]
    writer = vis.VideoWriter(str(tmp_path / "video_1.mp4"))
    for f in frames:
        writer.write(f)
    writer.release()
    assert writer.frames == 3 and writer.png_dir is None
    capture = cv2.VideoCapture(str(tmp_path / "video_1.mp4"))
    assert int(capture.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    capture.release()
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    writer = vis.VideoWriter(str(tmp_path / "video_2.mp4"))
    for f in frames:
        writer.write(f)
    writer.release()
    assert sorted(os.listdir(tmp_path / "video_2")) == [
        "000000.png", "000001.png", "000002.png"]
    monkeypatch.undo()
    np.testing.assert_array_equal(
        imread(str(tmp_path / "video_2" / "000001.png")), frames[1])


def test_bird_eye_view_takes_array_boxes():
    """The trackers keep ``org_ddd_box`` as an array; the JAX function's
    ``getattr(...) or getattr(...)`` raises on one (ROADMAP C.3), the port
    draws it as the same box given as a list."""
    box = np.array([1.5, 1.6, 4.0, 3.0, 1.0, 20.0, 0.1])
    with pytest.raises(ValueError, match="truth value"):
        jax_vis.bird_eye_view([Track(3, [0, 0, 1, 1], ddd=box)])
    np.testing.assert_array_equal(
        vis.bird_eye_view([Track(3, [0, 0, 1, 1], ddd=box)]),
        jax_vis.bird_eye_view([Track(3, [0, 0, 1, 1], ddd=list(box))]))
