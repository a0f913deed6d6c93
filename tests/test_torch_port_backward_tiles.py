"""T5's tiled route on the CPU: its launch plan and its algorithm.

``csrc/dcn_backward.cu::dcn_backward_tiled`` works per (pixel tile, run of
channel slices) on a window of x and a float32 dx window in shared memory:
it bins the tile's (pixel, tap) entries by window cell, sums each entry's
dmask and doffsets terms in entry order (staging the tile's rows of g), lets
lane groups own bins and add their entries' corner terms into the dx window,
bins of one row and column parity at a time (disjoint 2x2 corner blocks, so
plain adds), then adds the window into dx once; the slices' per-entry sums
are added in slice order.  The kernel runs only on the card; this file holds
what decides its grid and its arithmetic in plain code:

* ``plan_backward`` at every DLA-34 layer shape ``chip_smoke.py`` runs (a
  544x960 MOT frame, a 384x1280 KITTI frame, a 448x800 nuScenes camera, a
  512x512 COCO frame) at radius 4, for a float32 and a bfloat16 x: a plan that fits a block's
  shared memory, covers every pixel and channel once, and launches a block
  on every SM of an H100, each block taking 1, 2, 4 or 8 of the slices;
  none (the unclamped route) for a negative radius or a window that does
  not fit;
* ``deform_sample_backward_tiled_reference``, the kernel's algorithm in
  plain PyTorch, against ``deform_sample_backward_reference`` (offsets at
  exactly +-r, at integer positions and past the clamp) and against the
  JAX package's ``jax.vjp`` of ``deform_conv_onehot`` away from integer
  positions, on shapes that are not multiples of the tile, with the
  tolerance of T5's card test (1e-5 x max|plain|);
* the source: before its flush the tiled kernel's only atomics are integer
  ones on the shared bins; dx is written in the flush alone.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.ops.pallas_dcn import deform_conv_onehot
from deft_tpu_torch.csrc import build
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.tools import ablate_backward, ablate_fused, bench_dcn

H100_SMS = 132


def _smoke_layers():
    """(H, W, C) of chip_smoke.py's LAYERS (``bench_dcn.LAYERS``, which it
    imports), KITTI_LAYERS, NUSCENES_LAYERS and COCO_LAYERS, the last
    three read from its source (importing it loads every phase's
    modules)."""
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    layers = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("KITTI_LAYERS", "NUSCENES_LAYERS",
                                           "COCO_LAYERS")):
            layers[node.targets[0].id] = ast.literal_eval(node.value)
    assert len(layers) == 3
    layers["LAYERS"] = bench_dcn.LAYERS
    return sorted({tuple(shape[:3]) for rows in layers.values()
                   for shape in rows})


SMOKE_LAYERS = _smoke_layers()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (as ``test_torch_port_train_dcn.py``): the suite
    runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("h,w,c", SMOKE_LAYERS)
def test_plan_backward_fits_covers_and_fills(h, w, c, x_bytes):
    plan = cuda_dcn.plan_backward(h, w, c, 4, H100_SMS, x_bytes)
    assert plan is not None
    rows, cols = cuda_dcn.onehot_window(plan.tile_h, plan.tile_w, 4)
    entries = plan.tile_h * plan.tile_w * 9
    # the x window in its dtype, the float32 dx window, the tile's rows of
    # g, 28 bytes an entry, the bins
    assert plan.smem_bytes >= (rows * cols * (x_bytes + 4)
                               + entries * x_bytes) * plan.slice_c
    assert plan.smem_bytes == cuda_dcn.backward_smem_bytes(
        rows * cols, entries, plan.slice_c, x_bytes, x_bytes)
    assert plan.smem_bytes <= cuda_dcn.SMEM_PER_BLOCK
    assert plan.resident >= 1
    # whole chunks of 32 entries; tile_w a power of two
    assert (plan.tile_h * plan.tile_w) % 32 == 0
    assert plan.tile_w & (plan.tile_w - 1) == 0
    # every pixel and channel in exactly one (tile, slice)
    assert (plan.tiles_h - 1) * plan.tile_h < h <= plan.tiles_h * plan.tile_h
    assert (plan.tiles_w - 1) * plan.tile_w < w <= plan.tiles_w * plan.tile_w
    assert plan.slice_c in cuda_dcn.BACKWARD_SLICES
    assert (plan.slices - 1) * plan.slice_c < c <= plan.slices * plan.slice_c
    assert plan.workspace == (plan.slices * h * w * 9 * 3
                              if plan.slices > 1 else 0)
    assert plan.slice_run in (1, 2, 4, 8) and plan.slice_run <= max(
        plan.slices, 1)
    assert plan.blocks >= H100_SMS


def test_plan_backward_has_no_plan_without_a_window():
    """No clamp, no window: the unclamped route.  At radius 22 only the
    smallest tile and slice fit a block's shared memory with a float32 x
    and g; from 23 on, nothing does (bf16: up to 26)."""
    assert cuda_dcn.plan_backward(34, 60, 256, -1) is None
    small = cuda_dcn.plan_backward(34, 60, 256, 22)
    assert ((small.tile_h, small.tile_w) == cuda_dcn.BACKWARD_TILES[-1]
            and small.slice_c == cuda_dcn.BACKWARD_SLICES[-1])
    for radius in (23, 100):
        assert cuda_dcn.plan_backward(34, 60, 256, radius) is None
    assert cuda_dcn.plan_backward(34, 60, 256, 26, x_bytes=2) is not None
    assert cuda_dcn.plan_backward(34, 60, 256, 27, x_bytes=2) is None


def _backward_inputs(h, w, c, radius, seed, integer_free=False):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    off = rng.uniform(-radius - 1.5, radius + 1.5, (h, w, 9, 2))
    if integer_free:
        # never on an integer position, where JAX takes a subgradient
        off = np.where(np.abs(off - np.round(off)) < 0.05, off + 0.1, off)
    else:
        pick = rng.uniform(0, 1, off.shape)
        off = np.where(pick < 0.15, radius, off)           # at the clamp
        off = np.where((pick >= 0.15) & (pick < 0.3), -radius, off)
        off = np.where((pick >= 0.3) & (pick < 0.4), np.round(off), off)
    mask = rng.uniform(0.1, 1, (h, w, 9)).astype(np.float32)
    g = rng.normal(0, 1, (h * w, 9 * c)).astype(np.float32)
    return x, off.astype(np.float32), mask, g


def _close(got, want, rel=1e-5):
    for name, a, b in zip(("dx", "doffsets", "dmask"), got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(),
                                                    scale)


# shapes that are not multiples of the tiles; plans with ragged tiles and
# slices, one tile and one slice, and the planner's own
PLANS = [(4, 8, 8), (8, 16, 16), (16, 32, 64), None]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "planner" if p is None
                         else f"{p[0]}x{p[1]}x{p[2]}")
@pytest.mark.parametrize("radius", [0, 1, 4])
@pytest.mark.parametrize("h,w,c", [(13, 19, 40), (9, 7, 3)])
def test_tiled_model_matches_plain(h, w, c, radius, plan):
    """Offsets at exactly +-r, at integer positions and past the clamp: the
    tiled walk gives the plain version's dx, doffsets and dmask."""
    x, off, mask, g = (torch.from_numpy(a) for a in _backward_inputs(
        h, w, c, radius, seed=h + c + radius))
    if plan is not None:
        plan = cuda_dcn._backward_plan(h, w, c, radius, *plan)
    got = cuda_dcn.deform_sample_backward_tiled_reference(g, x, off, mask,
                                                          radius, plan)
    want = cuda_dcn.deform_sample_backward_reference(g, x, off, mask, radius)
    _close([t.numpy() for t in got], [t.numpy() for t in want])
    # the clamp's gradient: offsets past +-radius get none
    assert bool((got[1][off.abs() > radius] == 0).all())


def test_tiled_model_on_a_bf16_x():
    """A bfloat16 x stays bfloat16 in the window: dx within one bf16 step
    of the plain version, doffsets and dmask within 1e-5."""
    x, off, mask, g = (torch.from_numpy(a) for a in _backward_inputs(
        13, 19, 40, 4, seed=5))
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    plan = cuda_dcn.plan_backward(13, 19, 40, 4, x_bytes=2)
    got = cuda_dcn.deform_sample_backward_tiled_reference(gb, xb, off, mask,
                                                          4, plan)
    want = cuda_dcn.deform_sample_backward_reference(gb, xb, off, mask, 4)
    assert got[0].dtype == torch.bfloat16
    dx_err = (got[0].float() - want[0].float()).abs().max()
    assert dx_err <= 2.0 ** -7 * want[0].float().abs().max()
    _close([got[1].numpy(), got[2].numpy()], [want[1].numpy(),
                                              want[2].numpy()])


def _jax_sampling_vjp(x, off, mask, g, radius):
    """dx, doffsets, dmask of the JAX package's sampling: ``jax.vjp`` of
    ``deform_conv_onehot`` with an identity weight (Cout = 9C, tap-major),
    so that the patches' gradient is g itself."""
    h, w, c = x.shape
    eye = jnp.eye(9 * c, dtype=jnp.float32)
    zero = jnp.zeros(9 * c, jnp.float32)
    _, vjp = jax.vjp(lambda a, o, m: deform_conv_onehot(a, o, m, eye, zero,
                                                        radius=radius),
                     jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask))
    return [np.asarray(v) for v in vjp(jnp.asarray(g.reshape(h, w, 9 * c)))]


@pytest.mark.parametrize("radius", [0, 1, 4])
@pytest.mark.parametrize("h,w,c", [(13, 19, 40), (9, 7, 3)])
def test_tiled_model_matches_jax_vjp(h, w, c, radius):
    """Away from integer positions, on the planner's plan and on the
    smallest tile and slice: the JAX package's gradients of the sampling
    within 1e-5 x max|JAX|."""
    x, off, mask, g = _backward_inputs(h, w, c, radius, seed=7 * h + radius,
                                       integer_free=True)
    want = _jax_sampling_vjp(x, off, mask, g, radius)
    for plan in (None, cuda_dcn._backward_plan(h, w, c, radius, 4, 8, 8)):
        got = cuda_dcn.deform_sample_backward_tiled_reference(
            *(torch.from_numpy(a) for a in (g, x, off, mask)), radius, plan)
        _close([t.numpy() for t in got], want)


def test_tiled_model_refuses_no_clamp():
    x, off, mask, g = (torch.from_numpy(a) for a in _backward_inputs(
        9, 7, 3, 1, seed=1))
    with pytest.raises(ValueError):
        cuda_dcn.deform_sample_backward_tiled_reference(g, x, off, mask, -1)


def _tiled_kernel_source():
    src = (build.CSRC / "dcn_backward.cu").read_text()
    start = src.index("dcn_backward_tiled_kernel(")
    end = src.index("\n}\n", start)
    return src[start:end]


def test_tiled_kernel_adds_into_dx_only_in_its_flush():
    """In the tiled kernel every atomic before the flush is an integer one
    on the shared bins' counters; dx appears in the flush alone, whose one
    global add path is ``add4`` and its scalar tail."""
    body = _tiled_kernel_source()
    at = body.index("auto flush = [&]() {")
    before_flush, flush = body[:at], body[at:]
    targets = re.findall(r"atomicAdd\(\s*([A-Za-z_]\w*)", before_flush)
    assert targets and set(targets) == {"count"}
    assert not re.search(r"\bred\.", before_flush)    # no PTX reduction
    assert "add4(" not in before_flush
    assert not re.search(r"\bdx\s*[+\[]", before_flush)
    assert re.findall(r"atomicAdd\(\s*([A-Za-z_]\w*)", flush) == ["dst"]
    assert "add4(dst, " in flush and re.search(r"\bdx\s*\+", flush)


def test_ablation_empties_each_phase_of_the_tiled_kernel():
    """ablate_backward puts one guarded return at the top of the window
    fill, of the sums, of the scatter and of the flush, and nothing
    else."""
    src = (build.CSRC / "dcn_backward.cu").read_text()
    patched = ablate_fused.ablatable(src, ablate_backward.PHASES)
    assert patched.count("#ifdef ABLATE_NO_FILL\n") == 1
    assert patched.count("#ifdef ABLATE_NO_FLUSH\n") == 1
    assert patched.count("#ifdef ABLATE_NO_SCATTER\n") == 1
    assert patched.count("#ifdef ABLATE_NO_SUMS\n") == 1
    assert re.sub(r"#ifdef ABLATE_\w+\n *return;\n#endif\n", "",
                  patched) == src
    assert "defined(ABLATE_SCALAR_FLUSH)" in src


def test_backward_entries_share_one_library():
    assert cuda_dcn._LIBRARY["dcn_backward_tiled"] == "dcn_backward"
    assert cuda_dcn._LIBRARY["dcn_backward"] == "dcn_backward"
    src = (build.CSRC / "dcn_backward.cu").read_text()
    assert 'extern "C" int dcn_backward_tiled(' in src
