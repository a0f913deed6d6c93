"""The plain reference against hand-worked cases."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference.deft_ref import (Reference, fix_res_affine,
                                           input_image, peaks)
from benchmarks.reference.precision import fp8

KK = 9


def _dcn(c, cout, offsets_bias=None, mask_logit=20.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {"d.weight": torch.randn(cout, c, 3, 3, generator=g),
          "d.bias": torch.randn(cout, generator=g),
          "d.conv_offset_mask.weight": torch.zeros(3 * KK, c, 3, 3),
          "d.conv_offset_mask.bias": torch.zeros(3 * KK)}
    sd["d.conv_offset_mask.bias"][2 * KK:] = mask_logit
    if offsets_bias is not None:
        sd["d.conv_offset_mask.bias"][: 2 * KK] = offsets_bias
    return sd


def test_dcn_without_offsets_is_a_conv():
    sd = _dcn(3, 4)
    x = torch.randn(2, 3, 5, 7)
    got = Reference(sd, {"radius": 4}).dcn(x, "d")
    want = F.conv2d(x, sd["d.weight"], sd["d.bias"], padding=1)
    assert torch.allclose(got, want, atol=1e-5)


def test_dcn_whole_pixel_offset_and_clamp():
    """Every tap moved by (dy, dx) = (0, 1): the conv of x padded by none on
    the left and two on the right, zeros past the edge; an offset of 7
    clamps to a radius of 1."""
    x = torch.randn(1, 2, 4, 6)
    shifted = F.pad(x, (0, 2, 1, 1))
    bias = torch.zeros(2 * KK)
    bias[1::2] = 1.0
    sd = _dcn(2, 3, bias)
    got = Reference(sd, {"radius": 4}).dcn(x, "d")
    want = F.conv2d(shifted, sd["d.weight"], sd["d.bias"])
    assert torch.allclose(got, want, atol=1e-5)
    bias[1::2] = 7.0
    far = Reference(_dcn(2, 3, bias), {"radius": 1}).dcn(x, "d")
    assert torch.allclose(far, want, atol=1e-5)


def test_dcn_mask_halves():
    sd = _dcn(2, 3, mask_logit=0.0)
    x = torch.randn(1, 2, 4, 5)
    got = Reference(sd, {"radius": 4}).dcn(x, "d")
    want = F.conv2d(x, sd["d.weight"] * 0.5, sd["d.bias"], padding=1)
    assert torch.allclose(got, want, atol=1e-5)


def test_batch_norm_eval():
    x = torch.tensor([[[[1.0, 3.0]]], [[[5.0, 7.0]]]])      # [2, 1, 1, 2]
    sd = {"b.weight": torch.tensor([2.0]), "b.bias": torch.tensor([1.0]),
          "b.running_mean": torch.tensor([4.0]),
          "b.running_var": torch.tensor([5.0])}
    ev = Reference(sd, {}).bn(x, "b")
    assert torch.allclose(ev.flatten(), (x.flatten() - 4) / math.sqrt(
        5 + 1e-5) * 2 + 1)


def test_fix_res_geometry():
    """1080x1920 to 544x960 halves and centres: x/2, y/2 + 2."""
    a = fix_res_affine(1080, 1920, 544, 960)
    assert a.tolist() == [[0.5, 0.0, 0.0], [0.0, 0.5, 2.0]]
    frames = torch.randint(0, 256, (1, 1080, 1920, 3), dtype=torch.uint8)
    img = input_image(frames, 544, 960)
    mean = torch.tensor([0.40789654, 0.44719302, 0.47026115])
    std = torch.tensor([0.28863828, 0.27408164, 0.27809835])
    want = (frames[0, ::2, ::2].float() / 255 - mean) / std
    assert torch.allclose(img[0].permute(1, 2, 0)[2:542], want, atol=1e-5)
    assert torch.all(img[0, :, :2] == (-mean / std)[:, None, None])


def test_peaks_keeps_local_maxima():
    hm = torch.tensor([[[0.1, 0.9, 0.2], [0.3, 0.4, 0.8], [0.7, 0.1, 0.1]]])
    want = torch.tensor([[[0.0, 0.9, 0.0], [0.0, 0.0, 0.0],
                          [0.7, 0.0, 0.0]]])
    assert torch.equal(peaks(hm), want)


def test_similarity_by_hand():
    """Two ring rows, three current rows, affinities all 0 (a dead last
    layer): each softmax is uniform over the N+1 = 4 padded entries of its
    row or column, with the false row and column at 1.0."""
    e = 2
    sd = {"AFE.stacker2_bn.weight": torch.ones(e),
          "AFE.stacker2_bn.bias": torch.zeros(e),
          "AFE.stacker2_bn.running_mean": torch.zeros(e),
          "AFE.stacker2_bn.running_var": torch.ones(e)}
    widths = (2, 1)
    sd["AFE.final_net.0.weight"] = torch.zeros(2, 2 * e, 1, 1)
    sd["AFE.final_net.0.bias"] = torch.zeros(2)
    sd["AFE.final_net.2.weight"] = torch.zeros(1, 2, 1, 1)
    sd["AFE.final_net.2.bias"] = torch.zeros(1)
    ref = Reference(sd, {"max_object": 3, "affinity_widths": widths,
                         "affinity_bn": 0})
    ring = torch.randn(1, 3, e)
    ring[0, 2] = 0
    sims = ref.similarity(ring, torch.tensor([2]), torch.randn(3, e), 3)
    soft = math.exp(0) / (3 * math.exp(0) + math.exp(1))
    col = math.exp(0) / (2 * math.exp(0) + 2 * math.exp(1))
    assert sims.shape == (1, 3, 4)
    assert torch.allclose(sims[0, :2, :3], torch.full((2, 3), max(soft, col)))
    assert torch.allclose(sims[0, :2, 3],
                          torch.full((2,), math.e / (3 + math.e)))
    assert torch.all(sims[0, 2] == 0)


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0 + 1.0 / 16, -3.3])
    q = fp8(t)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] == -3.25

