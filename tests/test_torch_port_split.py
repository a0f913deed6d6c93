"""The CUDA kernels' plans and product precision, on the CPU.

``dcn_fused.cu`` (T3) multiplies on the tensor cores in 3xTF32 and splits
the reduction over blocks; ``dcn_sample.cu`` (T1, T2) slices channels
over blocks.  Neither kernel runs here, so this file holds what decides
their results and their grids in plain code:

* a plain emulation of the kernel's product precision (TF32 rounding with
  integer bit operations, as ``cvt.rna.tf32.f32`` rounds) shows that 3xTF32
  meets T3's 1e-4 * max|out| tolerance by design and one TF32 pass does not;
* the same emulation, split as ``plan_fused`` splits and summed in split
  order, computes T3's function: it matches the JAX package's float32
  ``deform_conv_onehot`` on x rounded to bf16;
* ``plan_fused`` and ``plan_sample`` cover every DLA-34 layer with enough
  blocks, and their splits cover the reduction and the channels exactly;
* ``csrc/build.py`` rebuilds a library when a shared header is newer;
* ``tools/ablate_fused.py`` finds every phase it empties in ``dcn_fused.cu``.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.ops.pallas_dcn import deform_conv_onehot
from deft_tpu_torch.csrc import build
from deft_tpu_torch.ops import cuda_dcn
from deft_tpu_torch.tools import ablate_fused

# DLA-34's DCNv2 layers at 544x960: (H, W, C, Cout)
DLA34_LAYERS = [(136, 240, 64, 64), (68, 120, 128, 64), (68, 120, 128, 128),
                (34, 60, 256, 128), (34, 60, 256, 256), (34, 60, 256, 64),
                (17, 30, 512, 256)]
RAGGED = [(9, 7, 3, 6), (9, 7, 3, 70), (9, 7, 3, 256), (5, 7, 512, 256),
          (13, 19, 16, 6), (11, 21, 40, 70), (1, 1, 1, 1), (3, 300, 700, 513)]


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the kernel's MMAs compute it: one pass multiplies the
    TF32-rounded operands; three add lo*hi + hi*lo + hi*hi, with
    hi = tf32(v) and lo = tf32(v - hi).  TF32 products are exact in float32;
    the sums are float32."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_tf32_round_is_rna():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32 spacing at 1
    v = torch.tensor([one + ulp / 2,    # tie: away from zero
                      -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23,   # below the tie: down
                      one + ulp * 0.75, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                         -0.0], dtype=torch.float32)
    got = tf32_round(v)
    assert torch.equal(got, want)
    # every result has its low 13 bits clear
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert not (tf32_round(r).view(torch.int32) & 0x1FFF).any()
    assert ((tf32_round(r) - r).abs() <= r.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_product_precision_at_the_widest_reduction(passes, within):
    """T3's widest DLA-34 product, M=510 pixels, K=4608, N=256, with
    patches as T3 samples them (bf16-rounded values times bilinear weights
    and a mask in [0, 1)): 3xTF32 stays within the 1e-4 * max|out| that
    ``chip_smoke.py`` and the card tests hold T3 to, measured against a
    float64 product; one TF32 pass does not."""
    rng = np.random.RandomState(0)
    m, k, n = 510, 4608, 256
    a = (torch.from_numpy(rng.randn(m, k).astype(np.float32))
         .to(torch.bfloat16).float()
         * torch.from_numpy(rng.rand(m, k).astype(np.float32)))
    b = torch.from_numpy((rng.randn(k, n) / math.sqrt(k)).astype(np.float32))
    exact = a.double() @ b.double()
    err = (product_tf32(a, b, passes).double() - exact).abs().max()
    tol = 1e-4 * exact.abs().max()
    assert (err <= tol) == within, (err.item(), tol.item())


def fused_emulated(x, offsets, mask, weight, bias, radius):
    """T3 as the kernel computes it, in plain PyTorch: patches of x rounded
    to bf16, the reduction in ``plan_fused``'s chunk runs, each run's
    partial in 3xTF32, the partials summed in split order, then the bias."""
    h, w, c = x.shape
    cout = weight.shape[1]
    plan = cuda_dcn.plan_fused(h, w, c, cout)
    patches = cuda_dcn.deform_sample_reference(
        x.to(torch.bfloat16).float(), offsets, mask, radius)
    step = plan.chunks_per_split * cuda_dcn.FUSED_BK
    total = None
    for z in range(plan.splits):
        part = product_tf32(patches[:, z * step:(z + 1) * step],
                            weight[z * step:(z + 1) * step], passes=3)
        total = part if total is None else total + part
    return (total + bias).reshape(h, w, cout)


@pytest.mark.parametrize("h,w,c,cout", [(9, 7, 3, 6), (5, 7, 512, 256),
                                        (11, 21, 40, 70), (6, 5, 64, 64)])
def test_split_product_matches_jax(h, w, c, cout):
    """The split 3xTF32 emulation of T3 (one split for C = 3, 144 for
    5x7x512) against the JAX package's float32 ``deform_conv_onehot`` on the
    same bf16-rounded x (T3's function, ``deform_conv_pallas``), within T3's
    1e-4 * max|out|."""
    rng = np.random.RandomState(h * w + c)
    x = rng.randn(h, w, c).astype(np.float32)
    offs = rng.uniform(-6, 6, (h, w, 9, 2)).astype(np.float32)
    mask = rng.rand(h, w, 9).astype(np.float32)
    wt = (rng.randn(9 * c, cout) / math.sqrt(9 * c)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    x_bf = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    ref = np.asarray(deform_conv_onehot(
        *(jnp.asarray(v) for v in (x_bf, offs, mask, wt, b)), radius=4))
    got = fused_emulated(*(torch.from_numpy(v) for v in (x, offs, mask, wt, b)),
                         radius=4)
    tol = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("h,w,c,cout", DLA34_LAYERS + RAGGED)
def test_plan_fused_covers_the_reduction(h, w, c, cout):
    plan = cuda_dcn.plan_fused(h, w, c, cout)
    k = 9 * c
    assert plan.chunks == math.ceil(k / cuda_dcn.FUSED_BK)
    # the runs cover the chunks exactly, each run non-empty
    assert (plan.splits - 1) * plan.chunks_per_split < plan.chunks
    assert plan.splits * plan.chunks_per_split >= plan.chunks
    # block tiles: one column tile holds all of Cout up to 256
    assert plan.bn in (64, 128, 256) and plan.bm == cuda_dcn.FUSED_BM[plan.bn]
    assert plan.bn >= min(cout, 256)
    assert plan.tiles == (math.ceil(h * w / plan.bm)
                          * math.ceil(cout / plan.bn))
    assert plan.workspace == (plan.splits * h * w * cout
                              if plan.splits > 1 else 0)


@pytest.mark.parametrize("h,w,c,cout", DLA34_LAYERS)
def test_plan_fused_fills_the_card(h, w, c, cout):
    """Every DLA-34 layer launches at least FUSED_PER_SM blocks per SM of an
    H100 (132)."""
    plan = cuda_dcn.plan_fused(h, w, c, cout, sms=132)
    assert plan.blocks >= cuda_dcn.FUSED_PER_SM * 132


@pytest.mark.parametrize("h,w,c", sorted({l[:3] for l in DLA34_LAYERS}))
def test_plan_sample_fills_the_card(h, w, c):
    """T2's grid gives every DLA-34 layer at least two blocks per SM, and
    the default target of SAMPLE_PER_SM where the channels allow it."""
    plan = cuda_dcn.plan_sample(h, w, c, sms=132)
    assert plan.blocks >= 264
    assert (plan.blocks >= cuda_dcn.SAMPLE_PER_SM * 132
            or plan.slice_c == 16)


@pytest.mark.parametrize("h,w,c", [l[:3] for l in RAGGED]
                         + [(17, 30, 512), (2, 2, 24), (1, 1, 7)])
def test_plan_sample_covers_the_channels(h, w, c):
    plan = cuda_dcn.plan_sample(h, w, c)
    assert plan.tiles == math.ceil(h * w * 9 / cuda_dcn.SAMPLE_TILE)
    assert 1 <= plan.slice_c <= c
    # slices narrower than C hold whole bf16 packs of 8 channels
    assert plan.slice_c == c or plan.slice_c % 8 == 0
    assert (plan.slices - 1) * plan.slice_c < c <= plan.slices * plan.slice_c


def test_build_staleness_follows_headers(tmp_path):
    """A library is stale when missing, or older than its source or any
    header; fresh otherwise."""
    src = tmp_path / "k.cu"
    hdr = tmp_path / "common.cuh"
    lib = tmp_path / "libk.so"
    for f in (src, hdr):
        f.write_text("//")
    assert build.is_stale(lib, [src, hdr])
    lib.write_bytes(b"")
    os.utime(src, (100, 100))
    os.utime(hdr, (100, 100))
    os.utime(lib, (200, 200))
    assert not build.is_stale(lib, [src, hdr])
    os.utime(hdr, (300, 300))
    assert build.is_stale(lib, [src, hdr])
    assert not build.is_stale(lib, [src])
    os.utime(src, (400, 400))
    assert build.is_stale(lib, [src])


def test_build_passes_the_header_directory():
    flags = build.NVCC_FLAGS
    assert flags[flags.index("-I") + 1] == str(build.CSRC)
    assert any(build.CSRC.glob("*.cuh"))
    assert "dcn_common" not in build.kernel_names()


def test_ablation_empties_each_phase_of_the_fused_kernel():
    """The phase-ablation tool puts one guarded return at the top of each
    phase lambda of dcn_fused.cu, and nothing else."""
    src = (build.CSRC / "dcn_fused.cu").read_text()
    patched = ablate_fused.ablatable(src)
    assert patched.count("#ifdef ABLATE_NO_SAMPLE\n") == 2
    assert patched.count("#ifdef ABLATE_NO_MMA\n") == 1
    assert re.sub(r"#ifdef ABLATE_\w+\n *return;\n#endif\n", "",
                  patched) == src
    with pytest.raises(ValueError):
        ablate_fused.ablatable(src.replace("auto mma_chunk", "auto mma"))
