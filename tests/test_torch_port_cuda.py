"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from deft_tpu_torch.ops import cuda_dcn

pytestmark = pytest.mark.cuda

# the inputs of the 7 DLA-34 DCNv2 layers of a 384x1280 KITTI frame (T1 and
# T2 do not see Cout, so 7 layers give 4 inputs)
KITTI_INPUTS = [(96, 320, 64), (48, 160, 128), (24, 80, 256), (12, 40, 512)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(h, w, c, seed, dev, dtype):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(h, w, c).astype(np.float32)).to(dev, dtype)
    offs = torch.from_numpy(
        rng.uniform(-6.0, 6.0, (h, w, 9, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.rand(h, w, 9).astype(np.float32)).to(dev)
    return x, offs, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256)] + KITTI_INPUTS)
@pytest.mark.parametrize("radius", [4, -1])
def test_dcn_sample_matches_plain(cuda_device, h, w, c, dtype, radius):
    """fp32 within 1e-5 * max|x|; bf16 within one bf16 step of max|x|
    (2**-7 * max|x|: both round an fp32 sum taken in another order)."""
    x, offs, mask = _inputs(h, w, c, 5, cuda_device, dtype)
    before = cuda_dcn.LAUNCHES
    got = cuda_dcn.deform_sample(x, offs, mask, radius)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_reference(x, offs, mask, radius)
    bound = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * x.abs().max()
    assert (got.float() - ref.float()).abs().max() <= bound


def test_dcn_sample_rejects_non_contiguous(cuda_device):
    x, offs, mask = _inputs(8, 10, 4, 6, cuda_device, torch.float32)
    with pytest.raises(ValueError):
        cuda_dcn.deform_sample(x.transpose(0, 1), offs.transpose(0, 1),
                               mask.transpose(0, 1), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256), (17, 30, 512),
                                   (136, 240, 64)] + KITTI_INPUTS)
def test_dcn_sample_tap_matches_plain(cuda_device, h, w, c, dtype):
    """T2's kernel: within 1e-5 * max|x| in float32, one bf16 step of
    max|x| (2**-7 * max|x|) in bf16."""
    x, offs, mask = _inputs(h, w, c, 7, cuda_device, dtype)
    before = cuda_dcn.LAUNCHES_TAP
    got = cuda_dcn.deform_sample_tap(x, offs, mask, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_TAP == before + 1
    assert got.dtype == dtype and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_tap_reference(x, offs, mask, 4)
    bound = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * x.abs().max()
    assert (got.float() - ref.float()).abs().max() <= bound


@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   (34, 60, 256), (17, 30, 512),
                                   (136, 240, 64)] + KITTI_INPUTS)
def test_dcn_sample_tap_is_plain_sampling_of_rounded_x(cuda_device, h, w, c):
    """T2 on x equals T1 on x rounded to bf16, bit for bit in float32: the
    two entries share one template and each element's arithmetic."""
    x, offs, mask = _inputs(h, w, c, 11, cuda_device, torch.float32)
    tap = cuda_dcn.deform_sample_tap(x, offs, mask, 4)
    plain = cuda_dcn.deform_sample(x.bfloat16().float(), offs, mask, 4)
    torch.cuda.synchronize()
    assert torch.equal(tap, plain)


def _onehot_matches_plain(x, offs, mask, radius):
    """T4 through its wrapper: one launch, bf16 patches within one bf16
    step of max|patch| of the plain version."""
    h, w, c = x.shape
    before = cuda_dcn.LAUNCHES_ONEHOT
    got = cuda_dcn.deform_sample_onehot(x, offs, mask, radius)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_ONEHOT == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (h * w, 9 * c)
    ref = cuda_dcn.deform_sample_onehot_reference(x, offs, mask,
                                                  radius).float()
    assert (got.float() - ref).abs().max() <= 2.0 ** -7 * ref.abs().max()


@pytest.mark.parametrize("regime", ["uniform6", "trained"])
@pytest.mark.parametrize("radius", [0, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(13, 19, 16), (11, 21, 40), (9, 7, 3),
                                   # the DLA-34 layers of a 544x960 frame
                                   (136, 240, 64), (68, 120, 128),
                                   (34, 60, 256), (17, 30, 512)])
def test_dcn_sample_onehot_matches_plain(cuda_device, h, w, c, dtype, radius,
                                         regime):
    """T4's kernel on ``plan_onehot``'s tile and slice, ragged tiles, C = 3
    and C = 40 (a ragged slice) included, with offsets past the clamp
    (uniform6) and within +-2 px (trained): bf16 patches within one bf16
    step of max|patch|."""
    x, offs, mask = _inputs(h, w, c, 8, cuda_device, dtype)
    if regime == "trained":
        offs = (offs / 3.0).clamp(-2.0, 2.0)
    _onehot_matches_plain(x, offs, mask, radius)


def test_dcn_sample_onehot_smallest_tile(cuda_device):
    """Radius 55 leaves only the smallest tile and slice a window that fits
    a block's shared memory; 56 leaves none, and the wrapper raises."""
    h, w, c = 34, 60, 256
    plan = cuda_dcn.plan_onehot(h, w, c, 55)
    assert ((plan.tile_h, plan.tile_w) == cuda_dcn.ONEHOT_TILES[-1]
            and plan.slice_c == cuda_dcn.ONEHOT_SLICES[-1])
    x, offs, mask = _inputs(h, w, c, 12, cuda_device, torch.float32)
    _onehot_matches_plain(x, offs * 10.0, mask, 55)
    with pytest.raises(ValueError):
        cuda_dcn.deform_sample_onehot(x, offs, mask, 56)


def test_dcn_sample_onehot_refuses_short_shared_memory(cuda_device):
    """The C entry takes the block's shared memory from the plan and refuses
    less than its window and entry slots take: the plan's own size
    launches, one byte less does not."""
    h, w, c = 34, 60, 256
    x, offs, mask = _inputs(h, w, c, 15, cuda_device, torch.float32)
    plan = cuda_dcn.plan_onehot(h, w, c, 4)
    out = torch.empty((h * w, 9 * c), dtype=torch.bfloat16, device=x.device)
    fn = cuda_dcn._entry("dcn_onehot", "dcn_sample_onehot")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for smem, ok in ((plan.smem_bytes, True), (plan.smem_bytes - 1, False)):
        err = fn(x.data_ptr(), offs.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), h, w, c, 4, 0, plan.tile_h, plan.tile_w,
                 plan.slice_c, smem, stream)
        assert (err == 0) == ok, (smem, err)
    torch.cuda.synchronize()


def _weights(c, cout, seed, dev):
    rng = np.random.RandomState(seed)
    wt = torch.from_numpy((rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev)
    return wt, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,cout", [
    (13, 19, 16, 6), (11, 21, 40, 70), (9, 7, 3, 64), (34, 60, 256, 128),
    # split-K: the smallest DLA-34 layer, a few pixels with a large K, and
    # C = 3 (K = 27, one ragged chunk) with ragged and wide Cout
    (17, 30, 512, 256), (5, 7, 512, 256), (9, 7, 3, 6), (9, 7, 3, 70),
    (9, 7, 3, 256)])
def test_dcn_fused_matches_plain(cuda_device, h, w, c, cout, dtype):
    """T3's kernel, ragged pixel and channel tiles and split reductions
    included: within 1e-4 * max|out| in float32 (3xTF32 products summed in
    another order), one bf16 step of max|out| in bf16."""
    x, offs, mask = _inputs(h, w, c, 9, cuda_device, dtype)
    wt, b = _weights(c, cout, 10, cuda_device)
    before = cuda_dcn.LAUNCHES_FUSED
    got = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES_FUSED == before + 1
    assert got.dtype == dtype and got.shape == (h, w, cout)
    ref = cuda_dcn.deform_conv_fused_reference(x, offs, mask, wt, b, 4).float()
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * ref.abs().max()
    assert (got.float() - ref).abs().max() <= tol


def test_dcn_fused_is_deterministic(cuda_device):
    """The split-K reduction sums in a fixed order: two calls on the same
    inputs give the same bits (17x30x512 -> 256 splits its reduction)."""
    x, offs, mask = _inputs(17, 30, 512, 13, cuda_device, torch.float32)
    wt, b = _weights(512, 256, 14, cuda_device)
    assert cuda_dcn.plan_fused(17, 30, 512, 256).splits > 1
    first = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    second = cuda_dcn.deform_conv_fused(x, offs, mask, wt, b, 4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_clamped_kernels_reject_negative_radius(cuda_device):
    x, offs, mask = _inputs(8, 10, 4, 6, cuda_device, torch.float32)
    for fn in (cuda_dcn.deform_sample_tap, cuda_dcn.deform_sample_onehot):
        with pytest.raises(ValueError):
            fn(x, offs, mask, -1)


# ---- the nuScenes slice on the card -----------------------------------------

# DCNv2 layers of one 448x800 nuScenes camera: (H, W, Cin, Cout)
NUSCENES_LAYERS = [(112, 200, 64, 64), (56, 100, 128, 64), (56, 100, 128, 128),
                   (28, 50, 256, 128), (28, 50, 256, 256), (28, 50, 256, 64),
                   (14, 25, 512, 256)]


@pytest.mark.parametrize("h,w,c,cout", NUSCENES_LAYERS)
@pytest.mark.parametrize("regime", ["trained", "uniform6"])
def test_dcn_sample_at_nuscenes_shapes(cuda_device, h, w, c, cout, regime):
    """T1 and the layer's product against the plain versions, as the
    nuScenes model runs them (a camera's slice of the batch, radius 4):
    patches within 1e-5 * max|x|, outputs within 1e-5 * max|out|."""
    x, offs, mask = _inputs(h, w, c, 7, cuda_device, torch.float32)
    if regime == "trained":
        offs = (offs / 3.0).clamp(-2.0, 2.0)
    rng = np.random.RandomState(8)
    weight = torch.from_numpy((rng.randn(9 * c, cout) / np.sqrt(9 * c)
                               ).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda_device)
    batch = torch.stack([x, x.flip(0)])       # an odd W stays aligned per camera
    before = cuda_dcn.LAUNCHES
    got = cuda_dcn.deform_conv(batch[1].contiguous(), offs, mask, weight,
                               bias, 4)
    patches = cuda_dcn.deform_sample(batch[1].contiguous(), offs, mask, 4)
    torch.cuda.synchronize()
    assert cuda_dcn.LAUNCHES == before + 2
    ref_p = cuda_dcn.deform_sample_reference(x.flip(0), offs, mask, 4)
    ref = (torch.addmm(bias, ref_p, weight)).reshape(h, w, cout)
    assert (patches - ref_p).abs().max() <= 1e-5 * x.abs().max()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_lstm_step_on_card_matches_cpu(cuda_device):
    from deft_tpu_torch.tracking.motion_lstm import LSTMMotion

    cpu = LSTMMotion("nuscenes", seed=3, device="cpu")
    card = LSTMMotion("nuscenes", cpu.model.state_dict(), device=cuda_device)
    rng = np.random.RandomState(9)
    h, c = rng.randn(2, 37, 128).astype(np.float32)
    f = (rng.randn(37, 18) * 5).astype(np.float32)
    for a, b in zip(card.predict_batch(h, c, f), cpu.predict_batch(h, c, f)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_run_multi_on_card_matches_cpu(cuda_device):
    """A tiny nuScenes config through ``Detector.run_multi`` on the card and
    on the CPU with the same weights: finite boxes, the same ids on at
    least half of the cameras (cuDNN and the CPU sum the convolutions in
    other orders, which random weights amplify) and there boxes within
    1e-2 px."""
    from deft_tpu_torch.config import nuscenes_config
    from deft_tpu_torch.data.synthetic_nuscenes import make_scene
    from deft_tpu_torch.inference.detector import Detector

    cfg = nuscenes_config(input_h=96, input_w=160, K=32, max_object=16)
    cpu = Detector(cfg, device="cpu")
    scene = make_scene(n_samples=2, cameras=6, height=180, width=320,
                       n_objects=12)
    with torch.no_grad():
        # ~2% of the first camera's pixels above 0.5 in every class
        images, _ = cpu.pre_process(scene[0][1], {"calib": scene[0][0]["calib"]})
        z = cpu.model(images)[0]["hm"]
        out = cpu.model.hm[-1]
        gain = 2.0 / z.std()
        out.weight.mul_(gain)
        out.bias.copy_((out.bias - torch.quantile(
            z.reshape(-1, z.shape[-1]), 0.98, dim=0)) * gain)
        cpu.model.dim[-1].bias.copy_(torch.tensor([1.6, 1.9, 4.5]))
        cpu.model.dep[-1].bias.fill_(-3.0)
    card = Detector(cfg, cpu.model.state_dict(), device=cuda_device,
                    motion_state_dict=cpu.motion.model.state_dict())

    def snap(online):
        return [(t.track_id, np.asarray(t.tlbr)) for t in online]

    agree = total = 0
    for i in range(0, len(scene), 6):
        sample = scene[i: i + 6]
        args = ([f for _, f in sample],
                [{"calib": inf["calib"]} for inf, _ in sample],
                [inf for inf, _ in sample])
        got = card.run_multi(*args, materialize=snap)
        want = cpu.run_multi(*args, materialize=snap)
        for g, w in zip(got, want):
            total += 1
            assert all(np.isfinite(t[1]).all() for t in g)
            if [t[0] for t in g] == [t[0] for t in w]:
                agree += 1
                for a, b in zip(g, w):
                    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-2)
    assert agree >= total // 2, f"{agree} of {total} cameras agree"


def test_tracker_defaults_to_the_card(cuda_device):
    """``Tracker`` and ``DeviceFeatureRecorder`` built with no device keep
    their ring (and the tracker its LSTM) on the card."""
    from deft_tpu_torch.tracking.tracker import DeviceFeatureRecorder, Tracker

    tracker = Tracker("nuscenes", 8, 16, similarity_fn=None, use_lstm=True)
    assert tracker.recorder.embeds.device.type == "cuda"
    assert next(tracker.motion.model.parameters()).device.type == "cuda"
    recorder = DeviceFeatureRecorder("mot", 8, 16, None)
    assert recorder.embeds.device.type == "cuda"


def test_lstm_step_on_card_is_the_cell_update(cuda_device):
    """``DecoderRNN.step`` on the card, on the one-layer LSTM's ``_l0``
    parameters, is ``nn.LSTMCell``'s update bit for bit."""
    from deft_tpu_torch.tracking.motion_lstm import DecoderRNN

    torch.manual_seed(0)
    rnn = DecoderRNN("nuscenes").to(cuda_device)
    cell = torch.nn.LSTMCell(18, 128).to(cuda_device)
    with torch.no_grad():
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, name).copy_(getattr(rnn.lstm, name + "_l0"))
        h, c, x = (torch.randn(33, n, device=cuda_device)
                   for n in (128, 128, 18))
        h2, c2, _ = rnn.step(h, c, x)
        want = cell(x, (h, c))
    assert torch.equal(h2, want[0]) and torch.equal(c2, want[1])
