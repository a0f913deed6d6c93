"""Operations and bytes, from the configuration's shapes alone.

* ``frame_flops``: the multiply-adds (x2) of the reference network's
  convolutions and products, counted by ``FlopCounterMode`` on meta
  tensors (no data, no device), so that the count does not depend on what
  computes a layer in the program.  A DCNv2 layer counts its offset conv
  and its product 2*H*W*9*Cin*Cout; the bilinear sampling counts nothing.
  A frame is the tracking program's work: trunk, heads, the AFE selectors
  over the 13 maps, the embeddings at ``max_object`` centres and the
  similarity against ``sim_window`` ring slots; it also gives the (H, W,
  Cin, Cout) of every DCNv2 layer of the frame.
* ``sample_bound_s``: the least time of one call of the DCNv2 sampling
  kernels (T1 and T4) on an H100: every input read and every output
  written once at the memory rate, or the kernel's float32 operations at
  the rate outside the tensor cores, whichever is longer (the arithmetic
  of ``tools/bench_dcn.py::bound_times``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.reference.deft_ref import Reference

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, H100 SXM


def _meta_state(shapes) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in shapes.items()}


class _Recording(Reference):
    """The reference recording each DCNv2 layer's shape."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.layers: List[Tuple[int, int, int, int]] = []

    def dcn(self, x, key):
        cout = self.p[key + ".weight"].shape[0]
        self.layers.append((x.shape[2], x.shape[3], x.shape[1], cout))
        return super().dcn(x, key)


def frame_flops(shapes, spec: dict, in_h: int, in_w: int,
                sim_window: int) -> Tuple[float, List[tuple]]:
    """(FLOPs of one tracking frame, its DCNv2 layer shapes)."""
    ref = _Recording(_meta_state(shapes), spec)
    m = spec["max_object"]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        y, maps = ref.trunk(torch.empty(1, 3, in_h, in_w, device="meta"))
        ref.heads(y)
        emb = ref.embed(maps, torch.empty(1, m, 2, device="meta"))
        width = emb.shape[-1]
        ref.similarity(torch.empty(sim_window, m, width, device="meta"),
                       torch.empty(sim_window, device="meta"), emb[0], m)
    return float(counter.get_total_flops()), ref.layers


def sample_bound_s(h: int, w: int, c: int, x_bytes: int,
                   out_bytes: int) -> float:
    """Least time of one forward sampling call: x, offsets and mask read
    once, the [H*W, 9*C] patches written once; 8 operations per sampled
    patch element and ~40 per (pixel, tap)."""
    nbytes = (h * w * c * x_bytes + h * w * 9 * 2 * 4 + h * w * 9 * 4
              + h * w * 9 * c * out_bytes)
    ops = h * w * 9 * (8 * c + 40)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)

