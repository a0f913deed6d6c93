"""The operation and byte counters and the trace reduction, against hand
counts at tiny shapes."""

from __future__ import annotations

import pytest
import torch

from benchmarks import counts, trace
from benchmarks.reference.deft_ref import Reference

KK = 9


def _dcn_state(c, cout):
    return {"d.weight": ((cout, c, 3, 3), torch.float32),
            "d.bias": ((cout,), torch.float32),
            "d.conv_offset_mask.weight": ((3 * KK, c, 3, 3), torch.float32),
            "d.conv_offset_mask.bias": ((3 * KK,), torch.float32)}


@pytest.mark.parametrize("h,w,c,cout", [(4, 6, 8, 16), (3, 5, 2, 3)])
def test_dcn_layer_flops(h, w, c, cout):
    """A DCNv2 layer counts its product 2*H*W*9*Cin*Cout and its offset
    conv 2*H*W*27*9*Cin; the sampling counts nothing."""
    ref = Reference(counts._meta_state(_dcn_state(c, cout)), {"radius": 4})
    counter = counts.FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.dcn(torch.empty(1, c, h, w, device="meta"), "d")
    assert counter.get_total_flops() == (2 * h * w * KK * c * cout
                                         + 2 * h * w * 3 * KK * KK * c)


def test_sample_bound_by_hand():
    h, w, c = 2, 3, 4
    nbytes = (h * w * c * 2 + h * w * 9 * 2 * 4 + h * w * 9 * 4
              + h * w * 9 * c * 2)
    ops = h * w * 9 * (8 * c + 40)
    assert counts.sample_bound_s(h, w, c, 2, 2) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12))
    # the sampling's bytes bound it
    assert nbytes / 3.35e12 > ops / 67e12


def test_frame_flops_records_the_dla34_layers():
    """The 16 DCNv2 layers of DLA-34's neck at 544x960, and a frame's FLOPs
    near the count of ``deft_tpu_torch/bench.py`` (2.224e11, by
    ``FlopCounterMode`` on the program with the same DCN rule)."""
    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.models.factory import create_model

    from benchmarks.reference.deft_ref import dla34_spec
    from benchmarks.spec import Spec
    from benchmarks.tests.test_benchmarks_spec import ROOT
    from benchmarks.weights import state_shapes

    config = Spec(ROOT).config("mot17-dla34-bf16")
    model = create_model("dla_34", mot_config(), torch.device("meta"))
    flops, layers = counts.frame_flops(state_shapes(model),
                                       dla34_spec(config), 544, 960, 12)
    assert len(layers) == 16
    assert sorted(set(layers)) == sorted({
        (136, 240, 64, 64), (68, 120, 128, 64), (68, 120, 128, 128),
        (34, 60, 256, 64), (34, 60, 256, 128), (34, 60, 256, 256),
        (17, 30, 512, 256)})
    assert 1.9e11 < flops < 2.3e11


def test_union_and_reduce_events():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "submit", "ts": 0,
         "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 100,
         "dur": 300, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 400, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500, "dur": 200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 650,
         "dur": 100},
    ]
    out = trace.reduce_events(events, 0.001)
    assert out["busy_s"] == pytest.approx(350e-6)
    assert out["kernels"] == {"k1": pytest.approx(200e-6),
                              "k2": pytest.approx(200e-6)}
    # 0-400 idle under submit / conv2d, 750-1000 idle under submit alone
    assert out["idle"] == {"host: submit / aten::conv2d": pytest.approx(
        400e-6), "host: submit": pytest.approx(250e-6)}
