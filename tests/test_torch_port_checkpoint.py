"""Reference PyTorch checkpoints in the port and in the JAX package, on the
CPU.

* The detector: the port's seeded DLA-34 (offset convs randomized, the
  heatmap head raised so that detections clear the threshold) saved as a
  reference checkpoint, ``{"epoch", "state_dict"}`` under ``module.``
  keys, then loaded through ``cfg.load_model`` by both packages' detectors
  (the JAX one routes a ``.pth`` through ``load_checkpoint`` ->
  ``convert_torch_checkpoint``).  On the same prefetched input their
  detections agree: scores within 1e-4, boxes within 1e-3 px.  Every key
  of the file has its place in the JAX converter.
* Tolerance: a missing, a mis-shaped and an unexpected key behave as the
  JAX package's ``_merge_tolerant``.
* The motion model: a reference ``DecoderRNN`` ``.pth`` (one-layer
  ``nn.LSTM``, ``_l0`` keys) for the 2-D and the nuScenes feature widths,
  loaded strictly by the port (through ``cfg.load_model_traj`` on nuScenes)
  and through ``convert_torch_lstm`` by the JAX package; three chained LSTM
  steps agree within 1e-5.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from deft_tpu.config import mot_config
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.tracking.motion_lstm import LSTMMotion as JaxMotion
from deft_tpu.train.torch_convert import TorchConverter, convert_torch_lstm
from deft_tpu_torch.checkpoint import load_tolerant, load_torch_state_dict
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.config import nuscenes_config as port_nuscenes_config
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.models.dcn import DCNv2
from deft_tpu_torch.tracking.motion_lstm import DecoderRNN, LSTMMotion

SIZE = dict(input_h=64, input_w=128, max_object=8, K=16, dcn_offset_range=1)
SCORE_TOL = 1e-4       # fp32 scores of the two packages, absolute
BOX_TOL = 1e-3         # pixels
LSTM_TOL = 1e-5
MOTION_KEYS = {f"lstm.{k}_l0" for k in ("weight_ih", "weight_hh", "bias_ih",
                                        "bias_hh")}
MOTION_KEYS |= {f"out{i}.{k}" for i in (1, 2) for k in ("weight", "bias")}


def frame(seed=0, h=120, w=240):
    """Coloured rectangles on a noisy background (uint8 BGR)."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
    for y, x, bh, bw in ((10, 20, 30, 50), (60, 150, 25, 45),
                         (30, 90, 35, 35), (70, 30, 20, 60)):
        img[y: y + bh, x: x + bw] = rng.randint(60, 256, 3)
    return img


def save_reference(sd, path, **extra):
    """A state_dict as the reference trainer saves a data-parallel model."""
    torch.save({"epoch": 1, "state_dict": {"module." + k: v
                                           for k, v in sd.items()}, **extra},
               path)
    return str(path)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The port's seeded network with random offsets and a raised heatmap,
    saved under the reference's keys; the prefetched input of one frame."""
    jcfg = mot_config(**SIZE)
    jdet = JaxDetector(jcfg)
    inp = dict(zip(("images", "meta"), jdet.pre_process(frame())))
    model = Detector(port_mot_config(**SIZE), device="cpu").model
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCNv2):
                conv = m.conv_offset_mask
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=gen) * 0.01)
                conv.bias.copy_(torch.rand(conv.bias.shape, generator=gen)
                                * 2 - 1)
        # ~4% of the frame's pixels above 0.5
        z = model(torch.from_numpy(inp["images"]))[0]["hm"]
        gain = 2.0 / z.std().item()
        out = model.hm[-1]
        out.weight.mul_(gain)
        out.bias.copy_((out.bias - torch.quantile(z.flatten(), 0.96)) * gain)
    sd = model.state_dict()
    path = save_reference(sd, tmp_path_factory.mktemp("ckpt") / "model.pth",
                          optimizer={"state": {}, "param_groups": [
                              {"lr": 1.25e-4, "betas": (0.9, 0.999)}]})
    return jcfg, sd, path, inp


def _dets(det, inp):
    dets, _ = det.process(inp["images"], inp["meta"]) if isinstance(
        det, JaxDetector) else det.process(inp["images"])
    return det.post_process(dets, inp["meta"])


def test_load_model_matches_jax(checkpoint):
    jcfg, _, path, inp = checkpoint
    jdet = JaxDetector(jcfg.replace(load_model=path))
    pdet = Detector(port_mot_config(load_model=path, **SIZE), device="cpu")
    assert pdet.load_report.kept == [] and pdet.load_report.dropped == []
    j_res, p_res = _dets(jdet, inp), _dets(pdet, inp)
    assert len(p_res) == len(j_res) >= 4
    scores = np.array([d["score"] for d in j_res])
    # the order and the cut are stable only with margins far above the
    # score tolerance
    assert np.diff(-scores).min(initial=1.0) > 10 * SCORE_TOL
    for a, b in zip(p_res, j_res):
        assert a["class"] == b["class"]
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                   atol=BOX_TOL)


def test_loaded_weights_equal_the_saved_ones(checkpoint):
    """The file's tensors load bit for bit, the ``module.`` prefix
    stripped; an explicit ``state_dict`` wins over ``cfg.load_model``."""
    _, sd, path, _ = checkpoint
    loaded = load_torch_state_dict(path)
    assert list(loaded) == list(sd)
    pdet = Detector(port_mot_config(load_model=path, **SIZE), device="cpu")
    for key, value in pdet.model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    seeded = Detector(port_mot_config(**SIZE), device="cpu").model
    explicit = Detector(port_mot_config(load_model=path, **SIZE),
                        seeded.state_dict(), device="cpu")
    assert explicit.load_report is None
    key = "hm.2.bias"
    assert torch.equal(explicit.model.state_dict()[key],
                       seeded.state_dict()[key])
    assert not torch.equal(explicit.model.state_dict()[key], sd[key])


def test_converter_uses_every_key(checkpoint):
    jcfg, _, path, _ = checkpoint
    conv = TorchConverter(jcfg.dataset)
    conv.convert_dla34({k: v.numpy() for k, v in
                        load_torch_state_dict(path).items()},
                       jcfg.heads, jcfg.dla_node, DLA_PLANS["34"][0])
    assert conv.unused == []


def test_tolerant_load(checkpoint, tmp_path, capsys):
    """Missing and mis-shaped keys keep the seeded value, an unexpected one
    is dropped; each is reported with the JAX package's message and in its
    list, and every other key loads."""
    _, sd, _, _ = checkpoint
    bad = dict(sd)
    missing, misshaped = "hm.2.bias", "wh.2.weight"
    del bad[missing]
    bad[misshaped] = torch.zeros(3, 3)
    bad["extra.weight"] = torch.ones(2)
    path = save_reference(bad, tmp_path / "bad.pth")
    capsys.readouterr()
    pdet = Detector(port_mot_config(load_model=path, **SIZE), device="cpu")
    report = pdet.load_report
    assert report.kept == [missing, misshaped]
    assert report.dropped == ["extra.weight"]
    assert sorted(report.loaded) == sorted(set(sd) - {missing, misshaped})
    seeded = Detector(port_mot_config(**SIZE), device="cpu").model
    got = pdet.model.state_dict()
    for key in (missing, misshaped):
        assert torch.equal(got[key], seeded.state_dict()[key]), key
    for key in report.loaded:
        assert torch.equal(got[key], sd[key]), key
    out = capsys.readouterr().out
    assert f"checkpoint: {missing} missing; keeping init" in out
    assert (f"checkpoint: shape mismatch at {misshaped} ((3, 3) vs "
            f"{tuple(sd[misshaped].shape)}); keeping init") in out
    assert "checkpoint: dropping unexpected key extra.weight" in out
    # load_tolerant alone on a module, and what the port refuses
    head = torch.nn.Linear(2, 3)
    assert load_tolerant(head, {"weight": torch.ones(3, 2)}) == (
        ["weight"], ["bias"], [])
    with pytest.raises(NotImplementedError, match="orbax"):
        load_torch_state_dict(str(tmp_path / "model_last"))
    with pytest.raises(RuntimeError):
        Detector(port_mot_config(**SIZE), bad, device="cpu")


def test_unsafe_checkpoint_is_refused(tmp_path):
    path = tmp_path / "unsafe.pth"
    torch.save({"state_dict": {}, "note": Fraction(1, 3)}, path)
    with pytest.raises(ValueError, match="unsafe.pth"):
        load_torch_state_dict(str(path))


@pytest.mark.parametrize("dataset,features,futures",
                         [("mot", 11, 5), ("nuscenes", 18, 4)])
def test_load_model_traj_matches_jax(tmp_path, dataset, features, futures):
    rng = np.random.RandomState(features)

    def t(*shape):
        return torch.from_numpy(rng.uniform(-0.3, 0.3, shape).astype(
            np.float32))

    sd = {"lstm.weight_ih_l0": t(512, features),
          "lstm.weight_hh_l0": t(512, 128), "lstm.bias_ih_l0": t(512),
          "lstm.bias_hh_l0": t(512), "out1.weight": t(64, 128),
          "out1.bias": t(64), "out2.weight": t(4 * futures, 64),
          "out2.bias": t(4 * futures)}
    assert set(sd) == MOTION_KEYS == set(DecoderRNN(dataset).state_dict())
    path = save_reference(sd, tmp_path / "motion.pth")
    jm = JaxMotion(dataset, convert_torch_lstm(path, dataset))
    pm = LSTMMotion(dataset, load_torch_state_dict(path), device="cpu")
    if dataset == "nuscenes":
        # the Detector's motion model comes from cfg.load_model_traj (the
        # configs force the LSTM off on the 2-D datasets, opts.py:478-479)
        pm = Detector(port_nuscenes_config(
            load_model_traj=path, input_h=64, input_w=64, max_object=8,
            K=16), device="cpu").motion
    for key, value in pm.model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    n = 7
    h = c = np.zeros((n, 128), np.float32)
    jh = jc = h
    for step in range(3):
        x = (rng.randn(n, features) * 5).astype(np.float32)
        h, c, deltas = pm.predict_batch(h, c, x)
        jh, jc, j_deltas = jm.predict_batch(jh, jc, x)
        assert deltas.shape == (n, futures, 4)
        for a, b in ((h, jh), (c, jc), (deltas, j_deltas)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=LSTM_TOL, err_msg=str(step))


def test_lstm_step_is_the_cell_update():
    """``DecoderRNN.step`` on the one-layer LSTM's ``_l0`` parameters is
    ``nn.LSTMCell``'s update bit for bit."""
    torch.manual_seed(0)
    rnn = DecoderRNN("nuscenes")
    cell = torch.nn.LSTMCell(18, 128)
    with torch.no_grad():
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, name).copy_(getattr(rnn.lstm, name + "_l0"))
    h, c, x = torch.randn(5, 128), torch.randn(5, 128), torch.randn(5, 18)
    h2, c2, _ = rnn.step(h, c, x)
    want = cell(x, (h, c))
    assert torch.equal(h2, want[0]) and torch.equal(c2, want[1])
