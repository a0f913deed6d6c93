"""T4's launch plan and window arithmetic, on the CPU.

``csrc/dcn_onehot.cu`` stages a zero-padded bf16 window of the input per
(pixel tile, channel slice) in shared memory and reads every bilinear
corner from it in window coordinates, with no bounds test.  The kernel runs
only on the card; this file holds what decides its grid and its indexing in
plain code:

* ``plan_onehot`` at the 14 DLA-34 layer shapes (a 544x960 MOT frame and a
  448x800 nuScenes camera) and radii 0, 1, 4, 8: every window fits a block's
  shared memory, the tiles and slices cover every pixel and channel exactly
  once, and every layer launches at least one block per SM of an H100;
* a walk of the plan's tiles that builds each tile's window and gathers the
  four corners of every entry from it with the kernel's window coordinates
  equals ``deform_sample_onehot_reference`` bit for bit, odd shapes and
  offsets past the clamp included;
* the source layout: T4 has its own library, T1/T2's no longer holds it.
"""

import re

import numpy as np
import pytest
import torch

from deft_tpu_torch.csrc import build
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.tools import ablate_fused, ablate_onehot

# (H, W, C, Cout) of DLA-34's DCNv2 layers: a 544x960 MOT frame, then a
# 448x800 nuScenes camera
DLA34_LAYERS = [(136, 240, 64, 64), (68, 120, 128, 64), (68, 120, 128, 128),
                (34, 60, 256, 128), (34, 60, 256, 256), (34, 60, 256, 64),
                (17, 30, 512, 256),
                (112, 200, 64, 64), (56, 100, 128, 64), (56, 100, 128, 128),
                (28, 50, 256, 128), (28, 50, 256, 256), (28, 50, 256, 64),
                (14, 25, 512, 256)]
H100_SMS = 132


@pytest.mark.parametrize("radius", [0, 1, 4, 8])
@pytest.mark.parametrize("h,w,c,cout", DLA34_LAYERS)
def test_plan_onehot_fits_covers_and_fills(h, w, c, cout, radius):
    plan = cuda_dcn.plan_onehot(h, w, c, radius, sms=H100_SMS)
    rows, cols = cuda_dcn.onehot_window(plan.tile_h, plan.tile_w, radius)
    assert plan.window_bytes == rows * cols * plan.slice_c * 2
    assert plan.smem_bytes <= cuda_dcn.SMEM_PER_BLOCK
    # whole warps of pixels, ONEHOT_THREADS_PER_PIXEL threads each
    threads = plan.tile_h * plan.tile_w
    assert threads % 32 == 0 and threads <= 256
    # every pixel and channel in exactly one (tile, slice)
    assert (plan.tiles_h - 1) * plan.tile_h < h <= plan.tiles_h * plan.tile_h
    assert (plan.tiles_w - 1) * plan.tile_w < w <= plan.tiles_w * plan.tile_w
    assert plan.slice_c in cuda_dcn.ONEHOT_SLICES
    assert (plan.slices - 1) * plan.slice_c < c <= plan.slices * plan.slice_c
    assert plan.blocks >= H100_SMS


@pytest.mark.parametrize("radius", [56, 100])
def test_plan_onehot_refuses_a_window_that_does_not_fit(radius):
    """At radius 55 only the smallest tile and slice fit a block's shared
    memory; from 56 on, nothing does, and the plan raises."""
    small = cuda_dcn.plan_onehot(34, 60, 256, 55)
    assert ((small.tile_h, small.tile_w) == cuda_dcn.ONEHOT_TILES[-1]
            and small.slice_c == cuda_dcn.ONEHOT_SLICES[-1])
    with pytest.raises(ValueError):
        cuda_dcn.plan_onehot(34, 60, 256, radius)
    with pytest.raises(ValueError):
        cuda_dcn.plan_onehot(34, 60, 256, -1)


def onehot_walk(x, offsets, mask, radius, plan):
    """T4 as dcn_onehot.cu indexes it, in plain PyTorch: per (tile, slice)
    of ``plan``, the zero-padded window of x rounded to bf16, rows
    h0 - r - 1 .. h0 + TH + r + 1 and columns likewise; each entry's window
    row ly + ky + 1 + fy + r and column px - w0 - 1 (asserted inside the
    window); the four corners read from the window; the reference's
    arithmetic on them.  Asserts that every output element is written
    exactly once."""
    h, w, c = x.shape
    th, tw, cs = plan.tile_h, plan.tile_w, plan.slice_c
    rows, cols = cuda_dcn.onehot_window(th, tw, radius)
    xb = x.to(torch.bfloat16).float()
    pad = radius + 2
    k = torch.arange(9)
    ky, kx = k // 3, (k % 3 - 1).float()
    out = torch.zeros((h * w, 9, c))
    written = torch.zeros((h * w, 9, c), dtype=torch.int32)
    for ty in range(plan.tiles_h):
        for tx in range(plan.tiles_w):
            h0, w0 = ty * th, tx * tw
            win = torch.zeros((rows, cols, c))
            r0, c0 = h0 - radius - 1, w0 - radius - 1
            gr = slice(max(r0, 0), min(r0 + rows, h))
            gc = slice(max(c0, 0), min(c0 + cols, w))
            win[gr.start - r0: gr.stop - r0, gc.start - c0: gc.stop - c0] = \
                xb[gr, gc]
            ly, lx = torch.meshgrid(torch.arange(th), torch.arange(tw),
                                    indexing="ij")
            keep = ((h0 + ly) < h) & ((w0 + lx) < w)
            ly, lx = ly[keep], lx[keep]                      # [n]
            hh, ww = h0 + ly, w0 + lx
            dy = offsets[hh, ww, :, 0].clamp(-radius, radius)   # [n, 9]
            dx = offsets[hh, ww, :, 1].clamp(-radius, radius)
            fy = torch.floor(dy)
            pos = (ww.float()[:, None] + pad + kx) + dx
            px = torch.floor(pos)
            wx0 = (1.0 - (pos - px)).to(torch.bfloat16).float()
            wx1 = (1.0 - ((px + 1.0) - pos)).to(torch.bfloat16).float()
            wy0 = torch.clamp(1.0 - (dy - fy).abs(), min=0.0)
            wy1 = torch.clamp(1.0 - (dy - (fy + 1.0)).abs(), min=0.0)
            wr = ly[:, None] + ky + fy.long() + radius
            wc = px.long() - w0 - 1
            assert wr.min() >= 0 and wr.max() + 1 < rows
            assert wc.min() >= 0 and wc.max() + 1 < cols
            p = hh * w + ww
            for s in range(plan.slices):
                ch = slice(s * cs, min((s + 1) * cs, c))
                part = win[..., ch]

                def corner(dr, dc):
                    return part[wr + dr, wc + dc]            # [n, 9, cs]

                g0 = (wx0[..., None] * corner(0, 0)
                      + wx1[..., None] * corner(0, 1))
                g1 = (wx0[..., None] * corner(1, 0)
                      + wx1[..., None] * corner(1, 1))
                acc = g0 * wy0[..., None] + g1 * wy1[..., None]
                out[p, :, ch] = acc * mask[hh, ww][..., None]
                written[p, :, ch] += 1
    assert bool((written == 1).all())
    return out.reshape(h * w, 9 * c).to(torch.bfloat16)


def _inputs(h, w, c, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    offs = torch.from_numpy(
        rng.uniform(-spread, spread, (h, w, 9, 2)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(h, w, 9).astype(np.float32))
    return x, offs, mask


@pytest.mark.parametrize("radius", [0, 1, 4])
@pytest.mark.parametrize("h,w,c", [(9, 7, 3), (11, 21, 40), (17, 30, 512)])
def test_window_walk_equals_the_plain_version(h, w, c, radius):
    """On the plan the card would get, offsets spread over +-6 px (past the
    clamp at every radius here): the window walk gives the plain version's
    bits."""
    x, offs, mask = _inputs(h, w, c, h * w + c + radius)
    plan = cuda_dcn.plan_onehot(h, w, c, radius, sms=H100_SMS)
    got = onehot_walk(x, offs, mask, radius, plan)
    ref = cuda_dcn.deform_sample_onehot_reference(x, offs, mask, radius)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("slice_c", cuda_dcn.ONEHOT_SLICES)
@pytest.mark.parametrize("tile", cuda_dcn.ONEHOT_TILES)
def test_window_walk_on_every_tile_and_slice(tile, slice_c):
    """Every (tile, slice) the planner can pick, on a shape that leaves
    ragged tiles and a ragged slice (C = 40), radius 1, offsets at and past
    the clamp: the plain version's bits."""
    h, w, c, radius = 11, 21, 40, 1
    x, offs, mask = _inputs(h, w, c, 3, spread=1.5)
    plan = cuda_dcn._onehot_plan(h, w, c, radius, *tile, slice_c)
    got = onehot_walk(x, offs, mask, radius, plan)
    ref = cuda_dcn.deform_sample_onehot_reference(x, offs, mask, radius)
    assert torch.equal(got, ref)


def test_window_row_from_the_float_reciprocal():
    """The fill finds a window cell's row as (cell + 0.5) * (1 / ww) in
    float32 (IEEE products, as the card's FMUL): exact for every cell of
    every window that fits a block, up to the largest radius."""
    for radius in range(0, 56):
        for th, tw in cuda_dcn.ONEHOT_TILES:
            rows, cols = cuda_dcn.onehot_window(th, tw, radius)
            cells = np.arange(rows * cols)
            inv = np.float32(1.0) / np.float32(cols)
            row = ((cells.astype(np.float32) + np.float32(0.5)) * inv
                   ).astype(np.int64)
            assert (row == cells // cols).all(), (radius, th, tw)


def test_onehot_has_its_own_library():
    """T4 builds from dcn_onehot.cu into its own library; dcn_sample.cu
    (T1, T2) no longer holds it."""
    assert "dcn_onehot" in build.kernel_names()
    assert cuda_dcn._LIBRARY["dcn_sample_onehot"] == "dcn_onehot"
    assert cuda_dcn._LIBRARY["dcn_sample_tap"] == "dcn_sample"
    assert "onehot" not in (build.CSRC / "dcn_sample.cu").read_text().replace(
        "deform_conv_onehot", "").replace("_onehot_kernel", "").replace(
        "dcn_onehot.cu", "")
    src = (build.CSRC / "dcn_onehot.cu").read_text()
    assert 'extern "C" int dcn_sample_onehot(' in src


def test_ablation_empties_each_phase_of_the_onehot_kernel():
    """ablate_onehot puts one guarded return at the top of the window fill
    and of the blend, and nothing else."""
    src = (build.CSRC / "dcn_onehot.cu").read_text()
    patched = ablate_fused.ablatable(src, ablate_onehot.PHASES)
    assert patched.count("#ifdef ABLATE_NO_FILL\n") == 1
    assert patched.count("#ifdef ABLATE_NO_SAMPLE\n") == 1
    assert re.sub(r"#ifdef ABLATE_\w+\n *return;\n#endif\n", "",
                  patched) == src
