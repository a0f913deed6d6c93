"""DCNv2 sampling: the hand-written CUDA kernels, their wrappers and their
plain versions.  The counterpart of ``deft_tpu/ops/pallas_dcn.py``.

Every function takes the JAX functions' layouts: x ``[H, W, C]``, offsets
``[H, W, 9, 2]`` (dy, dx) float32, mask ``[H, W, 9]`` float32, weight
``[9*C, Cout]`` tap-major, bias ``[Cout]``.  Sampling is modulated deformable
im2col: for every output pixel and tap of the 3x3 kernel, a bilinear sample of
``x`` at the tap's position plus its offset (clamped to +-radius; a negative
radius means no clamp, for ``deform_sample`` only), with zeros outside the
image, times the tap's mask; patches are tap-major ``[H*W, 9*C]``.

One kernel per TPU kernel of the JAX package, each with its launch counter
(callers reset it to 0 before a run and read it after, to prove the run went
through the kernel), its wrapper and its plain version:

============================  ===============================  ======================
function (counter)            computes                         replaces (pallas_dcn)
============================  ===============================  ======================
``deform_sample``             float32 sampling of x as given   ``_cm_kernel`` :585
(``LAUNCHES``)                                                 and the XLA onehot
``deform_sample_tap``         sampling of x rounded to bf16,   ``_dcn_tap_kernel``
(``LAUNCHES_TAP``)            float32 blend, x's dtype out     :338 (:387, :438)
``deform_sample_onehot``      x and the horizontal weights     ``_onehot_kernel``
(``LAUNCHES_ONEHOT``)         rounded to bf16, bf16 out        :463 (:511)
``deform_conv_fused``         bf16-rounded sampling + float32  ``_dcn_kernel``
(``LAUNCHES_FUSED``)          product + bias in one kernel     :224 (:270)
``deform_sample_backward``    the sampling's backward: dx,     no Pallas kernel: the
(``LAUNCHES_BACKWARD``: the   doffsets, dmask from the         ``jax.vjp`` of
tiled route;                  patches' gradient                ``deform_conv_onehot``
``LAUNCHES_BACKWARD_ENTRY``:                                   :167 (:733-787)
the unclamped route)
============================  ===============================  ======================

``DeformSample`` is the autograd function around the samplers on the
training route: its forward is the sampler it is given (T1 on a float32 x,
T4 on a bfloat16 x, as inference picks them), its backward T5.  The weight
and bias gradients and ``g @ weight.T`` stay autograd of the ``torch.mm`` /
``addmm`` that follow the sampling, as the JAX package leaves those plain
products to XLA.  ``trainable(sample)`` is a sampler with that backward.

Which ``dcn_impl`` computes which function (``models/dcn.py`` dispatches):

* ``gather``: ``deform_conv`` with no clamp (``models/dcn.py::deform_sample``);
* ``hybrid``, ``onehot``, ``shift``: ``deform_conv``, float32, clamped.  On a
  TPU the hybrid runs ``_cm_kernel``'s bf16 slab for C <= 128, but on the CPU,
  where the tests hold the port, the JAX package computes all three in
  float32 (``deform_conv_hybrid`` takes ``deform_conv_onehot`` off the TPU),
  and that is the function the port keeps;
* ``pallas``: ``deform_conv_tap`` (T2), for every sample of a batch;
* ``pallas_cm``: ``deform_conv_cm``, T1's function as the TPU computes it (a
  bf16 copy of x through ``deform_sample``, bf16 patches, bf16-rounded
  weight, float32 product); batched, ``deform_conv`` as the JAX package does;
* ``deform_conv_fused`` (T3) and ``deform_conv_onehot_sampled`` (T4) have no
  ``dcn_impl``: nothing in the JAX package calls their TPU kernels.

That list is for a float32 x.  Under a bfloat16 x (``compute_dtype=
"bfloat16"``) ``models/dcn.py``'s docstring says which function each
``dcn_impl`` takes; the default hybrid then samples through T1 or T4.

On a CUDA tensor every wrapper launches its kernel (built on first use, see
``csrc/build.py``) or raises; on a CPU tensor it computes the ``*_reference``
plain version of the same function.  Nothing falls back from the card to a
plain version.  Each launch follows a plan computed here from the layer's
shape and the card's SM count: ``plan_sample`` sizes T1's and T2's (entry
tile, channel slice) grid, ``plan_onehot`` T4's (pixel tile, channel slice)
grid and its shared-memory window, ``plan_fused`` picks T3's block tile and
its split of the reduction, whose float32 workspace the wrapper allocates,
``plan_backward`` T5's (pixel tile, channel slice, slices a block takes)
grid, its shared memory and whether its per-entry sums need a workspace.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

KK = 9                     # taps of the 3x3 kernel
SMS = 132                  # streaming multiprocessors of an H100 SXM
SAMPLE_TILE = 256          # (pixel, tap) entries per block, dcn_sample.cu
SAMPLE_PER_SM = 4          # blocks per SM plan_sample aims at
ONEHOT_TILES = ((16, 16), (8, 16), (8, 8), (4, 8))   # dcn_onehot.cu (TH, TW)
ONEHOT_SLICES = (64, 32, 16, 8)                      # its channel slices
ONEHOT_THREADS_PER_PIXEL = 3   # dcn_onehot.cu's TPP
ONEHOT_ENTRY_BYTES = 32    # shared memory per thread (its warp's entry slots)
ONEHOT_FILL_COST = 0.7     # a window element's time against an output's
ONEHOT_MIN_SLICE = 32      # channels of a slice plan_onehot prefers at least
ONEHOT_MIN_PIXELS = 64     # pixels of a tile plan_onehot prefers at least
SMEM_PER_BLOCK = 232448    # dynamic shared memory an H100 block may use
FUSED_BK = 32              # reduction chunk of dcn_fused.cu
FUSED_BM = {64: 64, 128: 64, 256: 32}   # dcn_fused.cu: BN -> BM of a block
FUSED_PER_SM = 1           # blocks per SM plan_fused aims at
BACKWARD_TILES = ((16, 32), (16, 16), (8, 32), (8, 16), (8, 8), (4, 8))
BACKWARD_SLICES = (64, 32, 16, 8)                    # dcn_backward.cu's CS
BACKWARD_BLOCKS_PER_SM = 2   # dcn_backward.cu's tiled launch bounds:
                             # registers for 2 blocks of 512 threads
BACKWARD_ENTRY_BYTES = 28  # shared memory per entry: weights, cell, order
# plan_backward's costs, in a sampled element's time (see
# backward_block_waves): fitted to the plan sweep of
# tools/ablate_backward.py on an H100 (PERF.md)
BACKWARD_TILE_COST = 13.9    # per entry and window cell, once a block
BACKWARD_SLICE_FIXED = 37800.0   # per slice a block takes
BACKWARD_WINDOW_COST = 0.66  # per window cell and channel of a slice
BACKWARD_SLICE_COST = 4.0    # per entry of a slice, where partial sums
                             # go through the workspace
SMEM_PER_SM = 233472       # shared memory of an H100 SM
SMEM_RESERVED = 1024       # of it held back per resident block

# Kernel launches made through each wrapper (see the module docstring).
LAUNCHES = 0
LAUNCHES_TAP = 0
LAUNCHES_ONEHOT = 0
LAUNCHES_FUSED = 0
LAUNCHES_BACKWARD = 0
LAUNCHES_BACKWARD_ENTRY = 0
COUNTERS = ("LAUNCHES", "LAUNCHES_TAP", "LAUNCHES_ONEHOT", "LAUNCHES_FUSED",
            "LAUNCHES_BACKWARD", "LAUNCHES_BACKWARD_ENTRY")


def launch_counts() -> dict:
    """Every launch counter, by its name in ``COUNTERS``."""
    return {name: globals()[name] for name in COUNTERS}


def add_launches(counts: dict):
    """Add ``counts`` (``launch_counts``' names) to the counters: the
    launches of a captured CUDA graph, counted once more at each replay
    (``inference/runner.py``)."""
    for name, n in counts.items():
        globals()[name] += n

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {                       # library -> entry -> argtypes
    "dcn_sample": {name: [_P] * 4 + [_I] * 6 + [_P]
                   for name in ("dcn_sample", "dcn_sample_tap")},
    "dcn_onehot": {"dcn_sample_onehot": [_P] * 4 + [_I] * 9 + [_P]},
    "dcn_fused": {"dcn_fused": [_P] * 7 + [_I] * 9 + [_P]},
    "dcn_backward": {"dcn_backward": [_P] * 7 + [_I] * 6 + [_P],
                     "dcn_backward_tiled": [_P] * 8 + [_I] * 11 + [_P]},
}
_LIBRARY = {entry: library for library, entries in _SIGNATURES.items()
            for entry in entries}
_libs = {}
_lib_lock = threading.Lock()


class SamplePlan(NamedTuple):
    """Grid of dcn_sample.cu: ``tiles`` blocks of ``SAMPLE_TILE`` entries
    by ``slices`` channel slices of ``slice_c`` channels."""
    tiles: int
    slices: int
    slice_c: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.slices


def plan_sample(h: int, w: int, c: int, sms: int = SMS) -> SamplePlan:
    """Channel slices for ``SAMPLE_PER_SM`` blocks per SM where the entry
    tiles alone give fewer.  A slice narrower than C is a multiple of 8
    channels (one bf16 pack, two float32 packs) and at least 16."""
    tiles = math.ceil(h * w * KK / SAMPLE_TILE)
    need = math.ceil(SAMPLE_PER_SM * sms / tiles)
    slice_c = c if need <= 1 else max(16, c // need // 8 * 8)
    slice_c = min(slice_c, c)
    return SamplePlan(tiles, math.ceil(c / slice_c), slice_c)


class OnehotPlan(NamedTuple):
    """Grid of dcn_onehot.cu: ``tiles_h`` x ``tiles_w`` pixel tiles of
    ``tile_h`` x ``tile_w`` (``threads`` per block) by ``slices`` channel
    slices of ``slice_c``; each block stages a bf16 window of
    ``window_bytes`` in shared memory."""
    tile_h: int
    tile_w: int
    slice_c: int
    tiles_h: int
    tiles_w: int
    slices: int
    window_bytes: int

    @property
    def blocks(self) -> int:
        return self.tiles_h * self.tiles_w * self.slices

    @property
    def threads(self) -> int:
        return ONEHOT_THREADS_PER_PIXEL * self.tile_h * self.tile_w

    @property
    def smem_bytes(self) -> int:
        """The window plus the warps' entry slots: the dynamic shared memory
        the wrapper launches the block with (the kernel refuses less than
        its layout takes)."""
        return self.window_bytes + self.threads * ONEHOT_ENTRY_BYTES


def onehot_window(tile_h: int, tile_w: int, radius: int) -> tuple:
    """(rows, columns) of the input a tile's samples can reach at clamp
    ``radius``: from r + 1 before the tile to r + 1 after it (corner pairs
    of row and column shifts in [-r - 1, r + 1])."""
    return tile_h + 2 * radius + 3, tile_w + 2 * radius + 3


def _onehot_plan(h, w, c, radius, tile_h, tile_w, slice_c) -> OnehotPlan:
    rows, cols = onehot_window(tile_h, tile_w, radius)
    return OnehotPlan(tile_h, tile_w, slice_c, math.ceil(h / tile_h),
                      math.ceil(w / tile_w), math.ceil(c / slice_c),
                      rows * cols * slice_c * 2)


def onehot_busiest_sm(plan: OnehotPlan, sms: int = SMS) -> float:
    """The work of the busiest SM when ``plan``'s blocks spread evenly over
    ``sms``: ceil(blocks / sms) blocks, each writing TH x TW x 9 x Cs
    outputs and filling its window at ``ONEHOT_FILL_COST`` outputs per
    element.  That cost is measured: on an H100 at the 7 MOT layer shapes,
    the time the window fill adds per element (full kernel less the kernel
    without its fill) over the time the blend and store add per output
    (full less the kernel without them) is 0.52-0.86 by layer, 0.71 over a
    frame (``tools/ablate_onehot.py``; PERF.md).  Every DLA-34 layer's
    blocks fit on the card at once, so the busiest SM sets the time."""
    per_block = (plan.tile_h * plan.tile_w * KK * plan.slice_c
                 + ONEHOT_FILL_COST * plan.window_bytes / 2)
    return math.ceil(plan.blocks / sms) * per_block


def plan_onehot(h: int, w: int, c: int, radius: int,
                sms: int = SMS) -> OnehotPlan:
    """T4's tile and channel slice.  Of the tiles of ``ONEHOT_TILES`` and
    the slices of ``ONEHOT_SLICES`` no wider than C (rounded up to 8) whose
    window fits a block's shared memory, it keeps in turn, each time only
    where some plan passes: those that launch a block on every SM; those
    whose slices hold ``ONEHOT_MIN_SLICE`` channels (or all of C), since
    fewer lanes then share each entry's weights and their corner reads
    collide in shared memory (16 channels cost 1.4-2x per output on the
    card, 8 channels 2-6x; PERF.md); those whose tiles hold
    ``ONEHOT_MIN_PIXELS`` pixels, since smaller blocks re-read a window 9x
    their tile.  Of what is left, the one whose busiest SM does the least
    work (``onehot_busiest_sm``); ties go to the wider slice, then the
    larger tile.  On an H100 the picks at the 7 MOT layer shapes sum to
    within 0.6% of the fastest plan of each layer over a frame (6% off at
    17x30x512, whose faster plans launch fewer blocks than SMs or use 16
    channels; PERF.md).  The window grows with the radius and the tile shrinks; raises
    ``ValueError`` where even the smallest tile's window does not fit."""
    _check_clamped(radius, "plan_onehot")
    c8 = -(-c // 8) * 8
    fits = [plan for cs in ONEHOT_SLICES if cs <= c8
            for th, tw in ONEHOT_TILES
            for plan in [_onehot_plan(h, w, c, radius, th, tw, cs)]
            if plan.smem_bytes <= SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"plan_onehot: radius {radius} needs a window larger "
                         f"than a block's {SMEM_PER_BLOCK} bytes of shared "
                         f"memory")
    for keep in (lambda p: p.blocks >= sms,
                 lambda p: p.slice_c >= min(ONEHOT_MIN_SLICE, c8),
                 lambda p: p.tile_h * p.tile_w >= ONEHOT_MIN_PIXELS):
        fits = [plan for plan in fits if keep(plan)] or fits
    return min(fits, key=lambda plan: onehot_busiest_sm(plan, sms))


class FusedPlan(NamedTuple):
    """Launch of dcn_fused.cu: ``bm`` x ``bn`` block tiles, the reduction's
    ``chunks`` of ``FUSED_BK`` in ``splits`` runs of ``chunks_per_split``,
    and a float32 workspace of ``workspace`` elements (0 for one split)."""
    bm: int
    bn: int
    tiles: int
    chunks: int
    splits: int
    chunks_per_split: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def plan_fused(h: int, w: int, c: int, cout: int,
               sms: int = SMS) -> FusedPlan:
    """One column tile holds up to 256 output channels (BN = 64, 128 or 256
    by Cout); the reduction splits on chunk boundaries, in equal runs but the
    last, until the layer launches ``FUSED_PER_SM`` blocks per SM (while it
    has chunks to split)."""
    bn = 64 if cout <= 64 else 128 if cout <= 128 else 256
    bm = FUSED_BM[bn]
    tiles = math.ceil(h * w / bm) * math.ceil(cout / bn)
    chunks = math.ceil(KK * c / FUSED_BK)
    need = math.ceil(FUSED_PER_SM * sms / tiles)
    per_split = chunks if need <= 1 else max(1, chunks // need)
    splits = math.ceil(chunks / per_split)
    workspace = splits * h * w * cout if splits > 1 else 0
    return FusedPlan(bm, bn, tiles, chunks, splits, per_split, workspace)


class BackwardPlan(NamedTuple):
    """Grid of dcn_backward.cu's tiled route: ``tiles_h`` x ``tiles_w``
    pixel tiles of ``tile_h`` x ``tile_w``, each block taking ``slice_run``
    of the ``slices`` channel slices of ``slice_c`` in turn; each block
    holds ``smem_bytes`` of shared memory (the x window, the float32 dx
    window, the tile's rows of g, its entries and their bins;
    ``backward_smem_bytes``).  Several slices add their per-entry sums in a
    float32 workspace of ``workspace`` elements."""
    tile_h: int
    tile_w: int
    slice_c: int
    tiles_h: int
    tiles_w: int
    slices: int
    slice_run: int
    smem_bytes: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.tiles_h * self.tiles_w * -(-self.slices // self.slice_run)

    @property
    def resident(self) -> int:
        """Blocks an SM holds at once: its registers hold
        ``BACKWARD_BLOCKS_PER_SM``, its shared memory may hold fewer."""
        return min(BACKWARD_BLOCKS_PER_SM,
                   SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED))


def backward_smem_bytes(cells: int, entries: int, slice_c: int,
                        x_bytes: int, g_bytes: int) -> int:
    """dcn_backward.cu's ``tiled_smem_bytes``: the x window [cells][Cs] in
    x's dtype, the float32 dx window [cells][Cs], the tile's rows of g
    [entries][Cs] in g's dtype, ``BACKWARD_ENTRY_BYTES`` per entry and two
    int arrays over the cells (the bins), each part rounded up to 16
    bytes."""
    up = lambda n: -(-n // 16) * 16                       # noqa: E731
    return (up(cells * slice_c * x_bytes) + cells * slice_c * 4
            + entries * slice_c * g_bytes + entries * BACKWARD_ENTRY_BYTES
            + up((cells + 1) * 4) + up(cells * 4))


def _backward_plan(h, w, c, radius, tile_h, tile_w, slice_c, x_bytes=4,
                   g_bytes=None, slice_run=1) -> BackwardPlan:
    rows, cols = onehot_window(tile_h, tile_w, radius)
    slices = math.ceil(c / slice_c)
    smem = backward_smem_bytes(rows * cols, tile_h * tile_w * KK, slice_c,
                               x_bytes, x_bytes if g_bytes is None
                               else g_bytes)
    return BackwardPlan(tile_h, tile_w, slice_c, math.ceil(h / tile_h),
                        math.ceil(w / tile_w), slices, slice_run, smem,
                        slices * h * w * KK * 3 if slices > 1 else 0)


def backward_block_waves(plan: BackwardPlan, radius: int,
                        sms: int = SMS) -> float:
    """The time of ``plan``'s launch in a sampled element's time: waves of
    blocks (ceil(blocks / (sms x resident))) times a block's time, which
    is ``BACKWARD_TILE_COST`` per entry and window cell (the entries and
    their bins, once a block) plus, per slice the block takes,
    ``BACKWARD_SLICE_FIXED`` (its barriers and latencies), TH x TW x 9 x Cs
    sampled elements, ``BACKWARD_WINDOW_COST`` per window cell and channel
    and, with several slices, ``BACKWARD_SLICE_COST`` per entry.  Fitted to
    297 swept plans at the 7 MOT layer shapes on an H100 (median error
    10%), it picks each shape's fastest plan or one within 6% of it."""
    rows, cols = onehot_window(plan.tile_h, plan.tile_w, radius)
    entries = plan.tile_h * plan.tile_w * KK
    per_slice = (BACKWARD_SLICE_FIXED + entries * plan.slice_c
                 + BACKWARD_WINDOW_COST * rows * cols * plan.slice_c
                 + (BACKWARD_SLICE_COST * entries if plan.slices > 1 else 0))
    per_block = (BACKWARD_TILE_COST * (entries + rows * cols)
                 + plan.slice_run * per_slice)
    waves = math.ceil(plan.blocks / (sms * max(plan.resident, 1)))
    return waves * per_block


def plan_backward(h: int, w: int, c: int, radius: int, sms: int = SMS,
                  x_bytes: int = 4, g_bytes: int = None):
    """T5's tile and channel slice for an x of ``x_bytes`` and a g of
    ``g_bytes`` per element (x's by default), or None where the tiled route
    does not apply: a negative radius (no clamp, so no window bounds the
    corners) or a radius whose smallest window does not fit a block's
    shared memory.  Of the tiles of ``BACKWARD_TILES`` and the slices of
    ``BACKWARD_SLICES`` no wider than C (rounded up to 8) whose shared
    memory fits ``SMEM_PER_BLOCK``, each with 1, 2, 4 or 8 slices a block
    (no more than C has), it keeps those that launch a block on every SM (if
    any does) and of them the one ``backward_block_waves`` times fastest;
    ties go to the wider slice, then the larger tile."""
    if radius < 0:
        return None
    c8 = -(-c // 8) * 8
    fits = [plan for cs in BACKWARD_SLICES if cs <= c8
            for th, tw in BACKWARD_TILES
            for run in (1, 2, 4, 8) if run == 1 or run <= -(-c // cs)
            for plan in [_backward_plan(h, w, c, radius, th, tw, cs, x_bytes,
                                        g_bytes, run)]
            if plan.smem_bytes <= SMEM_PER_BLOCK]
    if not fits:
        return None
    fits = [plan for plan in fits if plan.blocks >= sms] or fits
    return min(fits, key=lambda plan: backward_block_waves(plan, radius, sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _entry(library: str, name: str):
    """Build (if needed) and load ``library`` once per process; return its C
    entry point ``name``."""
    with _lib_lock:
        if library not in _libs:
            from deft_tpu_torch.csrc.build import build

            lib = ctypes.CDLL(str(build(library)))
            for fn_name, argtypes in _SIGNATURES[library].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[library] = lib
    return getattr(_libs[library], name)


def _check_inputs(x, offsets, mask):
    if x.dim() != 3:
        raise ValueError(f"x must be [H, W, C], got {tuple(x.shape)}")
    h, w, _ = x.shape
    if tuple(offsets.shape) != (h, w, KK, 2):
        raise ValueError(f"offsets must be [{h}, {w}, {KK}, 2], got "
                         f"{tuple(offsets.shape)}")
    if tuple(mask.shape) != (h, w, KK):
        raise ValueError(f"mask must be [{h}, {w}, {KK}], got "
                         f"{tuple(mask.shape)}")
    if offsets.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("offsets and mask must be float32")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == offsets.device == mask.device):
        raise ValueError("x, offsets and mask must be on one device")


def _check_clamped(radius: int, name: str):
    if radius < 0:
        raise ValueError(f"{name} needs a clamp radius >= 0, got {radius}")


def _check_weight(x, weight, bias):
    c = x.shape[2]
    if weight.dim() != 2 or weight.shape[0] != KK * c:
        raise ValueError(f"weight must be [{KK * c}, Cout], got "
                         f"{tuple(weight.shape)}")
    if tuple(bias.shape) != (weight.shape[1],):
        raise ValueError(f"bias must be [{weight.shape[1]}], got "
                         f"{tuple(bias.shape)}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("weight and bias must be float32")
    if not (weight.device == bias.device == x.device):
        raise ValueError("weight and bias must be on x's device")


def _on_card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors the kernels can index; raises for anything else."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    h, w, c = tensors[0].shape
    if h * w * KK * c >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for the kernel's indexing")
    return True


def _launch(entry: str, out: torch.Tensor, *args) -> torch.Tensor:
    """Call a C entry point on the current stream of ``out``'s device."""
    fn = _entry(_LIBRARY[entry], entry)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out


def _sample_on_card(entry: str, x, offsets, mask, radius: int) -> torch.Tensor:
    h, w, c = x.shape
    plan = plan_sample(h, w, c, _sm_count(x.device.index))
    out = torch.empty((h * w, KK * c), dtype=x.dtype, device=x.device)
    return _launch(entry, out, x.data_ptr(), offsets.data_ptr(),
                   mask.data_ptr(), out.data_ptr(), h, w, c, int(radius),
                   _DTYPES[x.dtype], plan.slice_c)


# ---- plain versions ----------------------------------------------------------

def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def _tap_grid(dev):
    """Tap offsets (ky, kx) of the 3x3 kernel, each [9] float32."""
    k = torch.arange(KK, device=dev)
    return ((k // 3 - 1).float(), (k % 3 - 1).float())


def deform_sample_reference(x: torch.Tensor, offsets: torch.Tensor,
                            mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch deformable im2col: the 4-corner gather of
    ``deft_tpu/models/dcn.py::deform_sample`` plus the +-radius clamp of
    ``deform_conv_onehot`` (``deft_tpu/ops/pallas_dcn.py:167-221``).
    Float32 arithmetic; returns ``[H*W, 9*C]`` in x's dtype."""
    _check_inputs(x, offsets, mask)
    h, w, c = x.shape
    dev = x.device
    xf = x.float()
    if radius >= 0:
        offsets = offsets.clamp(-radius, radius)
    ky, kx = _tap_grid(dev)
    base_y = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
              + ky[None, :])                                  # [H, KK]
    base_x = (torch.arange(w, dtype=torch.float32, device=dev)[:, None]
              + kx[None, :])                                  # [W, KK]
    yy = base_y[:, None, :] + offsets[..., 0]                 # [H, W, KK]
    xx = base_x[None, :, :] + offsets[..., 1]

    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    wx1 = xx - x0
    wy1 = yy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = xf.reshape(h * w, c)

    def tap(xi, yi, wgt):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        vals = flat[(yc * w + xc).reshape(-1)].reshape(h, w, KK, c)
        return vals * (wgt * inb.float())[..., None]

    out = (tap(x0, y0, wx0 * wy0)
           + tap(x0 + 1, y0, wx1 * wy0)
           + tap(x0, y0 + 1, wx0 * wy1)
           + tap(x0 + 1, y0 + 1, wx1 * wy1))
    out = out * mask[..., None]
    return out.reshape(h * w, KK * c).to(x.dtype)


def deform_sample_tap_reference(x: torch.Tensor, offsets: torch.Tensor,
                                mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of T2 (``deform_sample_pallas``, pallas_dcn.py:387):
    the clamped gather on x rounded to bfloat16 (:405), float32 arithmetic,
    patches ``[H*W, 9*C]`` in x's dtype."""
    _check_inputs(x, offsets, mask)
    _check_clamped(radius, "deform_sample_tap")
    return deform_sample_reference(_round_bf16(x), offsets, mask,
                                   radius).to(x.dtype)


def deform_sample_onehot_reference(x: torch.Tensor, offsets: torch.Tensor,
                                   mask: torch.Tensor,
                                   radius: int) -> torch.Tensor:
    """Plain version of T4 (``deform_conv_pallas_onehot``'s sampling,
    pallas_dcn.py:463-548), with its roundings where it has them: x rounded
    to bfloat16, the horizontal hat weights evaluated on the column grid
    padded by radius + 2 and rounded to bfloat16 (:492-494), the vertical hat
    weights per integer row shift in float32 (:498), each row's horizontal
    blend summed first (the one-hot matmul, :500-505), then the vertical
    weights, then the mask.  Returns bfloat16 patches ``[H*W, 9*C]``."""
    _check_inputs(x, offsets, mask)
    _check_clamped(radius, "deform_sample_onehot")
    h, w, c = x.shape
    dev = x.device
    pad = radius + 2
    flat = _round_bf16(x).reshape(h * w, c)
    dy = offsets[..., 0].clamp(-radius, radius)               # [H, W, KK]
    dx = offsets[..., 1].clamp(-radius, radius)
    ky, kx = _tap_grid(dev)
    fy = torch.floor(dy)
    wy = (torch.clamp(1.0 - (dy - fy).abs(), min=0.0),
          torch.clamp(1.0 - (dy - (fy + 1.0)).abs(), min=0.0))
    col = (torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
           + pad + kx)
    pos = col + dx
    px = torch.floor(pos)
    wx = (_round_bf16(1.0 - (pos - px)), _round_bf16(1.0 - ((px + 1.0) - pos)))
    row0 = (torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
            + ky + fy)
    col0 = px - pad

    def corner(r, cc):
        inb = (r >= 0) & (r <= h - 1) & (cc >= 0) & (cc <= w - 1)
        idx = (r.clamp(0, h - 1) * w + cc.clamp(0, w - 1)).long()
        return flat[idx.reshape(-1)].reshape(h, w, KK, c) * inb[..., None]

    acc = None
    for i in range(2):
        g = (wx[0][..., None] * corner(row0 + i, col0)
             + wx[1][..., None] * corner(row0 + i, col0 + 1))
        term = g * wy[i][..., None]
        acc = term if acc is None else acc + term
    out = acc * mask[..., None]
    return out.reshape(h * w, KK * c).to(torch.bfloat16)


def deform_conv_fused_reference(x: torch.Tensor, offsets: torch.Tensor,
                                mask: torch.Tensor, weight: torch.Tensor,
                                bias: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of T3 (``deform_conv_pallas``, pallas_dcn.py:270): the
    clamped gather on x rounded to bfloat16 (:297), float32 patches, their
    float32 product with the weight plus the bias (:263-267); ``[H, W,
    Cout]`` in x's dtype."""
    _check_inputs(x, offsets, mask)
    _check_weight(x, weight, bias)
    _check_clamped(radius, "deform_conv_fused")
    h, w, _ = x.shape
    patches = deform_sample_reference(_round_bf16(x), offsets, mask, radius)
    return torch.addmm(bias, patches, weight).reshape(h, w, -1).to(x.dtype)


# ---- wrappers ----------------------------------------------------------------

def deform_sample(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Deformable im2col ``[H*W, 9*C]`` in x's dtype, float32 arithmetic
    (``dcn_sample``, replaces ``_cm_kernel``)."""
    global LAUNCHES
    _check_inputs(x, offsets, mask)
    if not _on_card("deform_sample", x, offsets, mask):
        return deform_sample_reference(x, offsets, mask, radius)
    out = _sample_on_card("dcn_sample", x, offsets, mask, radius)
    LAUNCHES += 1
    return out


def deform_sample_tap(x: torch.Tensor, offsets: torch.Tensor,
                      mask: torch.Tensor, radius: int) -> torch.Tensor:
    """T2's sampling (``deform_sample_pallas``, pallas_dcn.py:387): patches
    ``[H*W, 9*C]`` of x rounded to bfloat16, in x's dtype
    (``dcn_sample_tap``)."""
    global LAUNCHES_TAP
    _check_inputs(x, offsets, mask)
    _check_clamped(radius, "deform_sample_tap")
    if not _on_card("deform_sample_tap", x, offsets, mask):
        return deform_sample_tap_reference(x, offsets, mask, radius)
    out = _sample_on_card("dcn_sample_tap", x, offsets, mask, radius)
    LAUNCHES_TAP += 1
    return out


def deform_sample_onehot(x: torch.Tensor, offsets: torch.Tensor,
                         mask: torch.Tensor, radius: int) -> torch.Tensor:
    """T4's sampling (``deform_conv_pallas_onehot``, pallas_dcn.py:511):
    bfloat16 patches ``[H*W, 9*C]`` (``dcn_sample_onehot``, on the tile
    and slice of ``plan_onehot``; raises ``ValueError`` where the radius
    leaves no window that fits)."""
    global LAUNCHES_ONEHOT
    _check_inputs(x, offsets, mask)
    _check_clamped(radius, "deform_sample_onehot")
    if not _on_card("deform_sample_onehot", x, offsets, mask):
        return deform_sample_onehot_reference(x, offsets, mask, radius)
    h, w, c = x.shape
    plan = plan_onehot(h, w, c, radius, _sm_count(x.device.index))
    out = torch.empty((h * w, KK * c), dtype=torch.bfloat16, device=x.device)
    _launch("dcn_sample_onehot", out, x.data_ptr(), offsets.data_ptr(),
            mask.data_ptr(), out.data_ptr(), h, w, c, int(radius),
            _DTYPES[x.dtype], plan.tile_h, plan.tile_w, plan.slice_c,
            plan.smem_bytes)
    LAUNCHES_ONEHOT += 1
    return out


def deform_conv_fused(x: torch.Tensor, offsets: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, radius: int) -> torch.Tensor:
    """T3 (``deform_conv_pallas``, pallas_dcn.py:270): sampling, the weight
    product on the tensor cores in 3xTF32 and the bias (``dcn_fused``, plus
    its split-K reduction where ``plan_fused`` splits); ``[H, W, Cout]`` in
    x's dtype.  Counts one launch per call."""
    global LAUNCHES_FUSED
    _check_inputs(x, offsets, mask)
    _check_weight(x, weight, bias)
    _check_clamped(radius, "deform_conv_fused")
    if not _on_card("deform_conv_fused", x, offsets, mask, weight, bias):
        return deform_conv_fused_reference(x, offsets, mask, weight, bias,
                                           radius)
    h, w, c = x.shape
    cout = weight.shape[1]
    plan = plan_fused(h, w, c, cout, _sm_count(x.device.index))
    if h * w * cout * plan.splits >= 2 ** 31:
        raise ValueError("deform_conv_fused: output too large for the "
                         "kernel's indexing")
    out = torch.empty((h, w, cout), dtype=x.dtype, device=x.device)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
          if plan.workspace else None)
    # the kernel samples a bf16 x, as deform_conv_pallas casts x before its
    # kernel (pallas_dcn.py:297)
    xb = x.to(torch.bfloat16)
    _launch("dcn_fused", out, xb.data_ptr(), offsets.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), h, w, c,
            cout, int(radius), _DTYPES[x.dtype], plan.bn, plan.splits,
            plan.chunks_per_split)
    LAUNCHES_FUSED += 1
    return out


# ---- T5: the sampling's backward --------------------------------------------

def _check_backward(g, x, offsets, mask):
    h, w, c = x.shape
    if tuple(g.shape) != (h * w, KK * c):
        raise ValueError(f"g must be [{h * w}, {KK * c}], got "
                         f"{tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError("g must be on x's device")


def deform_sample_backward_reference(g: torch.Tensor, x: torch.Tensor,
                                     offsets: torch.Tensor, mask: torch.Tensor,
                                     radius: int):
    """Plain version of T5, a gather formulation: the four corners of every
    (pixel, tap) as ``deform_sample_reference`` samples them, then

    * dx: ``g * mask * corner weight`` added into each in-image corner
      (``index_add_``), in x's dtype;
    * doffsets [H, W, 9, 2]: ``mask * sum_c g * d(bilinear)/d(dy, dx)``,
      zero where the offset lies past +-radius (the clamp's gradient);
    * dmask [H, W, 9]: ``sum_c g * bilinear``.

    The blend's derivative is DCNv2's (the reference's
    ``modulated_deformable_col2im_coord``): corners floor(pos) and
    floor(pos) + 1, so at an integer position it is the one-sided
    difference v(pos + 1) - v(pos) -- not JAX's subgradient there
    (ROADMAP.md, C.3).  Float32 arithmetic (float64 for float64 inputs,
    which ``torch.autograd.gradcheck`` uses); doffsets and dmask in the
    offsets' dtype."""
    _check_backward(g, x, offsets, mask)
    h, w, c = x.shape
    dev = x.device
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    gf = g.to(work).reshape(h, w, KK, c)
    off = offsets.to(work)
    m = mask.to(work)
    oy, ox = off[..., 0], off[..., 1]
    if radius >= 0:
        pass_y = ((oy >= -radius) & (oy <= radius)).to(work)
        pass_x = ((ox >= -radius) & (ox <= radius)).to(work)
        oy = oy.clamp(-radius, radius)
        ox = ox.clamp(-radius, radius)
    else:
        pass_y = pass_x = torch.ones_like(oy)
    ky, kx = _tap_grid(dev)
    yy = (torch.arange(h, dtype=work, device=dev)[:, None, None]
          + ky.to(work) + oy)                                 # [H, W, KK]
    xx = (torch.arange(w, dtype=work, device=dev)[None, :, None]
          + kx.to(work) + ox)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    ly = yy - y0
    lx = xx - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    flat = x.to(work).reshape(h * w, c)

    def corner(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = flat[idx.reshape(-1)].reshape(h, w, KK, c) * inb[..., None]
        return vals, idx, inb

    v00, i00, b00 = corner(y0, x0)
    v01, i01, b01 = corner(y0, x0 + 1)
    v10, i10, b10 = corner(y0 + 1, x0)
    v11, i11, b11 = corner(y0 + 1, x0 + 1)
    e = lambda t: t[..., None]                                # noqa: E731
    val = e(hy) * (e(hx) * v00 + e(lx) * v01) + e(ly) * (e(hx) * v10
                                                         + e(lx) * v11)
    d_dy = e(hx) * (v10 - v00) + e(lx) * (v11 - v01)
    d_dx = e(hy) * (v01 - v00) + e(ly) * (v11 - v10)
    dmask = (gf * val).sum(-1)
    doffsets = torch.stack([(gf * d_dy).sum(-1) * m * pass_y,
                            (gf * d_dx).sum(-1) * m * pass_x], dim=-1)
    gm = gf * e(m)
    dx = torch.zeros((h * w, c), dtype=work, device=dev)
    for idx, inb, wgt in ((i00, b00, hy * hx), (i01, b01, hy * lx),
                          (i10, b10, ly * hx), (i11, b11, ly * lx)):
        dx.index_add_(0, idx.reshape(-1),
                      (gm * e(wgt * inb)).reshape(-1, c))
    return (dx.reshape(h, w, c).to(x.dtype), doffsets.to(offsets.dtype),
            dmask.to(offsets.dtype))


def deform_sample_backward_tiled_reference(g: torch.Tensor, x: torch.Tensor,
                                           offsets: torch.Tensor,
                                           mask: torch.Tensor, radius: int,
                                           plan: BackwardPlan = None):
    """T5's tiled route as ``dcn_backward_tiled`` runs it, in plain
    PyTorch: per (tile, slice) of ``plan`` (``plan_backward``'s by
    default), the zero-padded window of x of ``onehot_window``'s size, each
    entry's window cell: its corner floor(pos) less the window's origin
    (h0 - r - 1, w0 - r - 1; raises if the corner pair leaves the window),
    the four corners read from the window, the entries' sums over the
    slice's channels; then the entries' corner terms added into a float32
    dx window at their cell and the cells one row and one column on (the
    kernel adds each cell's bin of entries at once, in four phases), and
    the window's in-image cells added into dx; the slices' partial sums
    added in slice order.  Float32 arithmetic (the kernel adds in another
    order); the outputs of ``deform_sample_backward_reference``."""
    _check_inputs(x, offsets, mask)
    _check_backward(g, x, offsets, mask)
    _check_clamped(radius, "deform_sample_backward_tiled")
    h, w, c = x.shape
    dev = x.device
    if plan is None:
        plan = plan_backward(h, w, c, radius, x_bytes=x.element_size(),
                             g_bytes=g.element_size())
    th, tw, cs = plan.tile_h, plan.tile_w, plan.slice_c
    rows, cols = onehot_window(th, tw, radius)
    xf = x.float()
    gf = g.float().reshape(h, w, KK, c)
    ky, kx = _tap_grid(dev)
    dx = torch.zeros((h, w, c), dtype=torch.float32, device=dev)
    partial = torch.zeros((plan.slices, h, w, KK, 3), dtype=torch.float32,
                          device=dev)
    for ty in range(plan.tiles_h):
        for tx in range(plan.tiles_w):
            h0, w0 = ty * th, tx * tw
            r0, c0 = h0 - radius - 1, w0 - radius - 1
            win = torch.zeros((rows, cols, c), dtype=torch.float32,
                              device=dev)
            gr = slice(max(r0, 0), min(r0 + rows, h))
            gc = slice(max(c0, 0), min(c0 + cols, w))
            inner = (slice(gr.start - r0, gr.stop - r0),
                     slice(gc.start - c0, gc.stop - c0))
            win[inner] = xf[gr, gc]
            hh, ww = torch.meshgrid(
                torch.arange(h0, min(h0 + th, h), device=dev),
                torch.arange(w0, min(w0 + tw, w), device=dev), indexing="ij")
            hh, ww = hh.reshape(-1), ww.reshape(-1)          # [n]
            oy, ox = offsets[hh, ww, :, 0], offsets[hh, ww, :, 1]  # [n, 9]
            pass_y = ((oy >= -radius) & (oy <= radius)).float()
            pass_x = ((ox >= -radius) & (ox <= radius)).float()
            yy = (hh[:, None] + ky).float() + oy.clamp(-radius, radius)
            xx = (ww[:, None] + kx).float() + ox.clamp(-radius, radius)
            y0, x0 = torch.floor(yy), torch.floor(xx)
            ly, lx = yy - y0, xx - x0
            hy, hx = 1.0 - ly, 1.0 - lx
            wr, wc = y0.long() - r0, x0.long() - c0
            if not (int(wr.min()) >= 0 and int(wr.max()) + 1 < rows
                    and int(wc.min()) >= 0 and int(wc.max()) + 1 < cols):
                raise RuntimeError("a corner pair leaves its tile's window")
            m = mask[hh, ww]
            e = lambda t: t[..., None]                        # noqa: E731
            for s in range(plan.slices):
                ch = slice(s * cs, min((s + 1) * cs, c))
                part = win[..., ch]
                a, b = part[wr, wc], part[wr, wc + 1]         # [n, 9, cs]
                cc, d = part[wr + 1, wc], part[wr + 1, wc + 1]
                gs = gf[hh, ww][..., ch]
                top = e(hx) * a + e(lx) * b
                bot = e(hx) * cc + e(lx) * d
                sums = partial[s, hh, ww]                     # [n, 9, 3]
                sums[..., 0] = (gs * (e(hy) * top + e(ly) * bot)).sum(-1)
                sums[..., 1] = (gs * (bot - top)).sum(-1) * m * pass_y
                sums[..., 2] = (gs * (e(hy) * (b - a) + e(ly) * (d - cc))
                                ).sum(-1) * m * pass_x
                partial[s, hh, ww] = sums
                # corner (cy, cx) of an entry lies cy rows and cx columns
                # after its cell
                cell = (wr * cols + wc).reshape(-1)
                dxw = torch.zeros((rows * cols, ch.stop - ch.start),
                                  dtype=torch.float32, device=dev)
                for cy, cx, wgt in ((0, 0, hy * hx), (0, 1, hy * lx),
                                    (1, 0, ly * hx), (1, 1, ly * lx)):
                    part_ = (gs * e(wgt * m)).reshape(-1, ch.stop - ch.start)
                    dxw.index_add_(0, cell + cy * cols + cx, part_)
                dx[gr, gc, ch] += dxw.reshape(rows, cols, -1)[inner]
    sums = partial[0]
    for s in range(1, plan.slices):
        sums = sums + partial[s]
    return (dx.to(x.dtype), sums[..., 1:].to(offsets.dtype).contiguous(),
            sums[..., 0].to(offsets.dtype).contiguous())


def deform_sample_backward(g: torch.Tensor, x: torch.Tensor,
                           offsets: torch.Tensor, mask: torch.Tensor,
                           radius: int):
    """T5: the gradients (dx in x's dtype, doffsets [H, W, 9, 2] float32,
    dmask [H, W, 9] float32) of the sampling of x at ``offsets`` and
    ``mask`` given g = dL/dpatches ``[H*W, 9*C]`` (float32 or bfloat16).
    On the card it launches ``dcn_backward_tiled`` where the radius is >= 0
    and ``plan_backward`` finds a plan (counted in ``LAUNCHES_BACKWARD``),
    else the unclamped route ``dcn_backward`` (``LAUNCHES_BACKWARD_ENTRY``).
    dx is summed in float32 with atomics on both routes, so its bits may
    change from call to call; the tiled route's doffsets and dmask do not.
    The plain version is ``deform_sample_backward_reference``."""
    global LAUNCHES_BACKWARD, LAUNCHES_BACKWARD_ENTRY
    _check_inputs(x, offsets, mask)
    _check_backward(g, x, offsets, mask)
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if not _on_card("deform_sample_backward", x, offsets, mask, g):
        return deform_sample_backward_reference(g, x, offsets, mask, radius)
    h, w, c = x.shape
    plan = plan_backward(h, w, c, radius, _sm_count(x.device.index),
                         x.element_size(), g.element_size())
    out = _backward_on_card(g, x, offsets, mask, radius, plan)
    if plan is None:
        LAUNCHES_BACKWARD_ENTRY += 1
    else:
        LAUNCHES_BACKWARD += 1
    return out


def _backward_on_card(g, x, offsets, mask, radius: int, plan):
    """T5 on CUDA tensors: ``dcn_backward_tiled`` on ``plan`` (a
    ``BackwardPlan``, radius >= 0), or ``dcn_backward`` for None."""
    h, w, c = x.shape
    dx = torch.zeros((h, w, c), dtype=torch.float32, device=x.device)
    doffsets = torch.empty((h, w, KK, 2), dtype=torch.float32,
                           device=x.device)
    dmask = torch.empty((h, w, KK), dtype=torch.float32, device=x.device)
    args = (g.data_ptr(), x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            dx.data_ptr(), doffsets.data_ptr(), dmask.data_ptr())
    if plan is None:
        _launch("dcn_backward", dx, *args, h, w, c, int(radius),
                _DTYPES[x.dtype], _DTYPES[g.dtype])
    else:
        ws = (torch.empty(plan.workspace, dtype=torch.float32,
                          device=x.device) if plan.workspace else None)
        _launch("dcn_backward_tiled", dx, *args,
                None if ws is None else ws.data_ptr(), h, w, c, int(radius),
                _DTYPES[x.dtype], _DTYPES[g.dtype], plan.tile_h, plan.tile_w,
                plan.slice_c, plan.slice_run, plan.smem_bytes)
    return dx.to(x.dtype), doffsets, dmask


class DeformSample(torch.autograd.Function):
    """A sampler with T5 as its backward: ``DeformSample.apply(sample, x,
    offsets, mask, radius)`` is ``sample(x, offsets, mask, radius)``, and
    its backward returns dx, doffsets and dmask from
    ``deform_sample_backward`` (x, offsets and mask are kept for it, not
    the patches)."""

    @staticmethod
    def forward(ctx, sample, x, offsets, mask, radius):
        ctx.save_for_backward(x, offsets, mask)
        ctx.radius = radius
        return sample(x, offsets, mask, radius)

    @staticmethod
    def backward(ctx, g):
        x, offsets, mask = ctx.saved_tensors
        dx, doffsets, dmask = deform_sample_backward(
            g.contiguous(), x, offsets, mask, ctx.radius)
        return None, dx, doffsets, dmask, None


def trainable(sample):
    """``sample`` (a sampler of this module) with T5 as its backward."""
    def sample_with_grad(x, offsets, mask, radius):
        return DeformSample.apply(sample, x, offsets, mask, radius)

    sample_with_grad.__name__ = f"trainable_{sample.__name__}"
    return sample_with_grad


# ---- convolutions: sampling, then the [9C, Cout] product as a library GEMM --

def _product(patches, weight, bias, h, w, out_dtype):
    """float32 ``patches @ weight + bias`` -> ``[H, W, Cout]``."""
    out = torch.addmm(bias.float(), patches.float(), weight.float())
    return out.reshape(h, w, -1).to(out_dtype)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, radius: int,
                sample=deform_sample) -> torch.Tensor:
    """Modulated deformable 3x3 conv with the JAX functions' contract
    (``deform_conv_onehot``): ``deform_sample`` patches (or ``sample``'s,
    e.g. ``trainable(deform_sample)``) times the weight, in x's dtype ->
    ``[H, W, Cout]``."""
    h, w, _ = x.shape
    patches = sample(x, offsets, mask, radius)
    out = torch.addmm(bias.to(patches.dtype), patches,
                      weight.to(patches.dtype))
    return out.reshape(h, w, -1)


def deform_conv_tap(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, radius: int,
                    sample=deform_sample_tap) -> torch.Tensor:
    """``deform_conv_pallas_tap`` (pallas_dcn.py:438): T2's patches (or
    ``sample``'s), then the float32 product with the weight plus the bias
    (:452), in x's dtype."""
    h, w, _ = x.shape
    return _product(sample(x, offsets, mask, radius), weight, bias, h, w,
                    x.dtype)


def deform_conv_onehot_sampled(x: torch.Tensor, offsets: torch.Tensor,
                               mask: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, radius: int) -> torch.Tensor:
    """``deform_conv_pallas_onehot`` (pallas_dcn.py:511): T4's bfloat16
    patches, then the float32 product with the weight plus the bias (:573),
    in x's dtype."""
    h, w, _ = x.shape
    return _product(deform_sample_onehot(x, offsets, mask, radius), weight,
                    bias, h, w, x.dtype)


def deform_conv_rounded(sample, x: torch.Tensor, offsets: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, radius: int) -> torch.Tensor:
    """A bfloat16 x's modulated deformable conv as ``deform_conv_onehot``,
    ``deform_conv_shift_xla`` and ``deform_conv_pallas_tap`` compute it
    under a bfloat16 trunk (``patches.astype(weight.dtype) @ weight + bias``
    with a bfloat16 weight, pallas_dcn.py:147, :218, :452): ``sample``'s
    bfloat16 patches times the weight rounded to bfloat16, accumulated in
    float32 and rounded to bfloat16, then the float32 bias, rounded again
    -> ``[H, W, Cout]`` bfloat16.  ``sample`` is ``deform_sample``,
    ``deform_sample_tap`` or ``deform_sample_onehot``."""
    h, w, _ = x.shape
    patches = sample(x, offsets, mask, radius)
    out = torch.mm(patches, weight.to(torch.bfloat16)).float() + bias
    return out.reshape(h, w, -1).to(torch.bfloat16)


def deform_conv_cm(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, radius: int,
                   sample=deform_sample) -> torch.Tensor:
    """``deform_conv_pallas_cm`` (pallas_dcn.py:669-729) as the TPU computes
    it: ``deform_sample`` (or ``sample``) on a bfloat16 copy of x (bfloat16
    patches), their float32 product with the weight rounded to bfloat16,
    plus the bias, in x's dtype (:726-728)."""
    h, w, _ = x.shape
    patches = sample(x.to(torch.bfloat16).contiguous(), offsets, mask,
                     radius)
    return _product(patches, _round_bf16(weight), bias, h, w, x.dtype)
