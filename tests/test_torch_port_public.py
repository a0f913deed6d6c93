"""Public detections (``public_det``, ``embed_parity``): the port against the
JAX package on the CPU.

MOTChallenge's public-detection protocol hands the tracker boxes from a
det file; the network only embeds the frame at their centres.  ``mot_config``
at 64x128 (max_object 8, K 16, ``dcn_offset_range`` 1) with the port's
seeded init (carried into the JAX package by its checkpoint converter),
every offset conv randomized (fractional samples past the radius) and the
heatmap head rescaled so that a frame without public boxes still finds
objects on the model path.  ``dcn_impl="pallas"`` runs the JAX T2 kernel in
interpret mode, as ``tests/test_torch_port_kitti.py`` does; its bf16
rounding of each DCN input is held with PALLAS_RTOL (``tests/
test_torch_port_dcn_impl.py``'s tolerance for that path).  Each JAX
program compiles once for the file: compiles are most of its time.

Per module: ``public_det_centers`` in both modes on ``tests/
test_public_det.py``'s 270x480 -> 128x160 geometry; ``embed_image``;
``detect`` under ``parity_tf``; ``frame_step_embed`` with its ring; the
``data/public_dets.py`` against ``tools/convert_mot_det_to_results.py``;
the refusals that stay.  ``embed_image`` and the public runner, which run
the JAX T2 kernel in interpret mode, are in
``test_torch_port_public_pallas.py``, and the public ``Detector.run`` as a
whole in ``test_torch_port_public_detector.py`` (this file's fixture and
helpers, each on a worker of its own).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import mot_config
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.detector import (
    public_det_centers as jax_public_det_centers,
)
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.data.public_dets import public_dets
from deft_tpu_torch.inference.detector import (
    Detector,
    parity_tf,
    public_det_centers,
)
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.models.deft import new_ring
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.tracking.tracker import freshness_window

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools import convert_mot_det_to_results  # noqa: E402

SIZE = dict(input_h=64, input_w=128, max_object=8, K=16, dcn_offset_range=1)
FRAMES = 6
EMB_TOL = 1e-4            # float32 embeddings of the two packages, absolute
PALLAS_RTOL = 2e-4        # T2: |a - b| <= rtol * (|b| + max|b|)
BOX_TOL = 1e-3            # pixels
SIM_WINDOW = freshness_window("mot") + 2
# (y, x, h, w, colour, (vy, vx)) at 120x240; a frame at 64x128 scales them
OBJECTS = [(10, 20, 30, 50, (250, 40, 40), (2, 3)),
           (60, 150, 25, 45, (30, 220, 60), (-1, -4)),
           (30, 90, 35, 35, (40, 60, 240), (3, 1)),
           (70, 30, 20, 60, (230, 230, 30), (-2, 2))]


def scene(h, w, n=FRAMES):
    """Moving rectangles on noise: (uint8 BGR frames, per frame the
    rectangles' tlbr boxes in that frame's pixels)."""
    rng = np.random.RandomState(0)
    sy, sx = h / 120.0, w / 240.0
    frames, boxes = [], []
    for f in range(n):
        img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
        fb = []
        for y, x, bh, bw, col, (vy, vx) in OBJECTS:
            y0, x0 = int((y + vy * f) * sy), int((x + vx * f) * sx)
            y1, x1 = y0 + int(bh * sy), x0 + int(bw * sx)
            img[max(y0, 0): y1, max(x0, 0): x1] = col
            fb.append([float(x0), float(y0), float(x1), float(y1)])
        frames.append(img)
        boxes.append(fb)
    return frames, boxes


def public(boxes, h, w, seed=1):
    """Per frame its public detections, as det files give them: every
    rectangle jittered by up to 3% of its size, plus false positives.
    Frame 1 has 10 (> max_object), frame 2 none, frame 3 no ``cur_dets``
    at all (the model path)."""
    rng = np.random.RandomState(seed)
    out = []
    for f, fb in enumerate(boxes):
        dets = []
        for b in fb:
            b = np.asarray(b)
            size = np.tile(b[2:] - b[:2], 2)
            b = b + rng.uniform(-0.03, 0.03, 4) * size
            dets.append(b)
        n_extra = {1: 6}.get(f, 1)
        for _ in range(n_extra):
            x, y = rng.uniform(0, 0.9, 2) * [w, h]
            dets.append(np.array([x, y, x + 0.05 * w, y + 0.1 * h]))
        items = [{"bbox": [float(v) for v in d],
                  "score": float(rng.uniform(0.6, 1.0)), "class": 1,
                  "ct": [float(d[0] + d[2]) / 2, float(d[1] + d[3]) / 2]}
                 for d in dets]
        out.append({2: [], 3: None}.get(f, items))
    return out


def _meta(dets):
    return {} if dets is None else {"cur_dets": dets}


@pytest.fixture(scope="module")
def setup():
    """The port's seeded init carried into the JAX package by its own
    checkpoint converter (the JAX init would take ~15 s here), every offset
    conv randomized, the heatmap head rescaled on the first frame."""
    cfg = mot_config(public_det=True, **SIZE)
    pcfg = port_mot_config(public_det=True, **SIZE)
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in create_model(
        pcfg.arch, pcfg, "cpu").state_dict().items()}
    params, stats = TorchConverter(cfg.dataset).convert_dla34(
        init, cfg.heads, cfg.dla_node, DLA_PLANS["34"][0])
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.RandomState(11)

    def randomize(tree):
        for key, v in tree.items():
            if key == "conv_offset_mask":
                v["kernel"] = rng.normal(0, 0.01, v["kernel"].shape
                                         ).astype(np.float32)
                v["bias"] = rng.uniform(-1.0, 1.0, v["bias"].shape
                                        ).astype(np.float32)
            elif isinstance(v, dict):
                randomize(v)

    randomize(variables["params"])
    model = jax_create_model(cfg.arch, cfg)
    # 100x240 frames into the 64x128 input: the fix_res warp pads them above
    # and below, so the parity centres differ from the input-frame ones
    frames, boxes = scene(100, 240)
    dets = public(boxes, 100, 240)
    jdet = JaxDetector(cfg, model=model, variables=variables)
    inputs = [dict(zip(("images", "meta"), jdet.pre_process(f, 1.0, _meta(d))))
              for f, d in zip(frames, dets)]
    # random weights give a flat heatmap far below the threshold: rescale
    # the head so ~4% of the first frame's pixels score above 0.5 (its
    # spread read with the bias at 0: about the -4.6 prior it is below
    # float32's resolution)
    hm = variables["params"]["head_hm"]["out"]
    hm["bias"] = np.zeros_like(hm["bias"])
    port = Detector(pcfg, from_jax_variables(variables, cfg), device="cpu")
    with torch.no_grad():
        out, _ = port.model(torch.from_numpy(inputs[0]["images"]))
    z = out["hm"].numpy()
    gain = 2.0 / z.std()
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = ((hm["bias"] - np.percentile(z, 96)) * gain).astype(np.float32)
    sd = from_jax_variables(variables, cfg)
    return {"cfg": cfg, "model": model, "variables": variables, "sd": sd,
            "pcfg": pcfg, "pdet": Detector(pcfg, sd, device="cpu"),
            "jdet": JaxDetector(cfg, model=model, variables=variables),
            "inputs": inputs, "dets": dets}


# ---- public_det_centers -------------------------------------------------------

@pytest.mark.parametrize("embed_parity", [False, True])
def test_public_det_centers_match_jax(embed_parity):
    """``tests/test_public_det.py``'s geometry: a 270x480 frame into a
    128x160 input (the fix_res warp crops its sides), boxes in original
    pixels, one past max_object."""
    from deft_tpu.ops.affine import get_affine_transform

    h, w, inp_h, inp_w = 270, 480, 128, 160
    c = np.array([w / 2.0, h / 2.0], np.float32)
    s = max(h, w) * 1.0
    meta = {"trans_input": get_affine_transform(c, s, 0, [inp_w, inp_h]),
            "height": h, "width": w, "inp_height": inp_h, "inp_width": inp_w}
    rng = np.random.RandomState(3)
    dets = [{"bbox": [x, y, x + bw, y + bh]}
            for x, y, bw, bh in rng.uniform([0, 0, 4, 4], [440, 230, 40, 40],
                                            (5, 4))]
    dets.insert(0, {"bbox": [w / 2 - 10, h / 2 - 10, w / 2 + 10, h / 2 + 10]})
    got, n = public_det_centers(dets, meta, 4, embed_parity)
    want, n_want = jax_public_det_centers(dets, meta, 4, embed_parity)
    assert got.dtype == np.float32 and got.shape == (4, 2) and n == n_want == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not embed_parity:       # the image centre is the input's centre
        np.testing.assert_allclose(got[0], [0.0, 0.0], atol=1e-2)
    got, n = public_det_centers(dets[:2], meta, 4, embed_parity)
    assert n == 2 and np.all(got[2:] == 0)


# ---- the model's entry points ------------------------------------------------

def test_detect_parity_tf_matches_jax(setup):
    """``detect`` under ``parity_tf`` (the reference's original-dims
    normalization): decoded boxes within BOX_TOL, embeddings within
    EMB_TOL.  They equal ``embed_image`` at the parity centres computed on
    the host, and differ from the default sampling (the frames are not the
    input's aspect)."""
    inp = setup["inputs"][0]
    meta = inp["meta"]
    ptf = parity_tf(meta)
    want_dets, want_emb = setup["model"].apply(
        setup["variables"], jnp.asarray(inp["images"]), k=SIZE["K"],
        parity_tf=jnp.asarray(ptf), method="detect")
    model = setup["pdet"].model
    image = torch.from_numpy(inp["images"])
    with torch.no_grad():
        dets, emb = model.detect(image, k=SIZE["K"], parity_tf=ptf)
        _, emb_default = model.detect(image, k=SIZE["K"])
    np.testing.assert_allclose(dets["bboxes"].numpy(),
                               np.asarray(want_dets["bboxes"]), rtol=0,
                               atol=BOX_TOL / 4)   # output cells: 4 px each
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=0,
                               atol=EMB_TOL)

    # the parity centres on the host: input pixels -> original pixels ->
    # normalized by the original dims
    bb = dets["bboxes"][0].numpy().astype(np.float64)
    cts = np.stack([(bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2],
                   -1) * 4.0
    orig = np.concatenate([cts, np.ones((len(cts), 1))], 1) @ ptf[:6].reshape(
        2, 3).astype(np.float64).T
    centers = np.stack([2 * orig[:, 0] / meta["width"] - 1,
                        2 * orig[:, 1] / meta["height"] - 1], -1)
    with torch.no_grad():
        ref = model.embed_image(image, torch.from_numpy(
            centers[None].astype(np.float32)))
    np.testing.assert_allclose(emb.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    assert not np.allclose(emb.numpy(), emb_default.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def jax_step_embed(setup):
    """Four frames of the JAX ``frame_step_embed`` (hybrid) from an empty
    ring: per frame (its sims, the ring after it).  Frame 1 has ten boxes
    (cut to max_object), frames 2 and 3 none."""
    m = SIZE["max_object"]
    e = setup["pdet"].model.embed_dim
    state = {"embeds": jnp.zeros((50, m, e), jnp.float32),
             "counts": jnp.zeros((50,), jnp.int32), "ptr": jnp.int32(0)}
    step = jax.jit(lambda v, img, c, n, s: setup["model"].apply(
        v, img, c, n, s, sim_window=SIM_WINDOW, method="frame_step_embed"))
    out = []
    for f in range(4):
        inp, dets = setup["inputs"][f], setup["dets"][f] or []
        centers, _ = public_det_centers(dets, inp["meta"], m)
        sims, state = step(setup["variables"], jnp.asarray(inp["images"]),
                           jnp.asarray(centers), jnp.int32(len(dets)), state)
        out.append((np.asarray(sims), jax.tree.map(np.asarray, state)))
    return out


@pytest.mark.parametrize("sims_quant", [False, True])
def test_frame_step_embed_matches_jax(setup, jax_step_embed, sims_quant):
    """``frame_step_embed`` against the JAX program over four frames: the
    similarity (float16 within 1e-3; under ``sims_quant`` uint8 within one
    step of the JAX float16 quantized) and the whole ring after each.  A
    frame of 0 boxes leaves the ring unwritten."""
    m, model = SIZE["max_object"], setup["pdet"].model
    state = new_ring(50, m, model.embed_dim, "cpu")
    for f, (want, jstate) in enumerate(jax_step_embed):
        inp, dets = setup["inputs"][f], setup["dets"][f] or []
        centers, _ = public_det_centers(dets, inp["meta"], m)
        got = model.frame_step_embed(
            torch.from_numpy(inp["images"]), torch.from_numpy(centers),
            len(dets), state, sims_quant=sims_quant, sim_window=SIM_WINDOW)
        want = want.astype(np.float32)
        if sims_quant:
            assert got.dtype == torch.uint8
            want = np.round(np.clip(want, 0, 1) * 255.0)
        else:
            assert got.dtype == torch.float16
        diff = np.abs(got.numpy().astype(np.float32) - want)
        assert diff.max() <= (1.0 if sims_quant else 1e-3), f
        np.testing.assert_array_equal(state["counts"].numpy(),
                                      jstate["counts"])
        assert int(state["ptr"]) == int(jstate["ptr"]) == min(f + 1, 2)
        np.testing.assert_allclose(state["embeds"].numpy(), jstate["embeds"],
                                   rtol=0, atol=EMB_TOL)
    assert state["counts"].numpy()[:3].tolist() == [5, m, 0]


# ---- the det-file mapping -----------------------------------------------------

def test_public_dets_match_convert_tool(tmp_path, monkeypatch):
    """``data/public_dets.py`` gives what ``tools/
    convert_mot_det_to_results.py`` writes: two sequences, one without a
    det file, one row without a score, half-split frame numbering."""
    data = tmp_path / "mot17"
    det_dir = data / "train" / "MOT17-02-FRCNN" / "det"
    det_dir.mkdir(parents=True)
    (data / "annotations").mkdir()
    (det_dir / "det.txt").write_text(
        "1,-1,10.5,20,30,60,0.93\n"
        "1,-1,100,120,25.25,50,0.41\n"
        "3,-1,12,22,30,61,0.88\n"
        "4,-1,14,24,31,62,0.3\n")
    dataset = {
        "videos": [{"id": 1, "file_name": "MOT17-02-FRCNN"},
                   {"id": 2, "file_name": "MOT17-04-FRCNN"}],
        "images": [
            {"id": 11, "video_id": 1, "frame_id": 1,
             "file_name": "MOT17-02-FRCNN/img1/000003.jpg"},
            {"id": 12, "video_id": 1, "frame_id": 2,
             "file_name": "MOT17-02-FRCNN/img1/000004.jpg"},
            {"id": 13, "video_id": 1, "frame_id": 3,
             "file_name": "MOT17-02-FRCNN/img1/000005.jpg"},
            {"id": 10, "video_id": 1, "frame_id": 0,
             "file_name": "MOT17-02-FRCNN/img1/000001.jpg"},
            {"id": 21, "video_id": 2, "frame_id": 1,
             "file_name": "MOT17-04-FRCNN/img1/000001.jpg"}]}
    (data / "annotations" / "val_half.json").write_text(json.dumps(dataset))
    monkeypatch.setattr(sys, "argv", ["convert_mot_det_to_results.py",
                                      "--data_dir", str(data)])
    convert_mot_det_to_results.main()
    with open(data / "annotations" / "public_dets.json") as f:
        want = {int(k): v for k, v in json.load(f).items()}
    got = public_dets(str(data / "annotations" / "val_half.json"), str(data))
    assert got == want
    assert [len(got[i]) for i in (10, 11, 12, 13, 21)] == [2, 1, 1, 0, 0]
    (det_dir / "det.txt").write_text("2,-1,1,2,3,4\n")
    got = public_dets(dataset, str(data))
    assert got[10] == [] and got[11] == [] and len(got[12]) == 0
    assert public_dets({"videos": dataset["videos"], "images": [
        dict(dataset["images"][0], file_name="x/img1/000002.jpg")]},
        str(data))[11][0]["score"] == 1.0


# ---- what is ported and what still raises -------------------------------------

def test_public_configs_build(setup):
    """``public_det`` and ``embed_parity`` no longer raise in either entry
    point; the runner under ``embed_parity`` feeds its frame programs the
    frame's ``parity_tf``."""
    for flags in ({"public_det": True}, {"embed_parity": True},
                  {"public_det": True, "embed_parity": True}):
        det = Detector(port_mot_config(**SIZE, **flags), setup["sd"],
                       device="cpu")
        runner = PipelinedRunner(det, chunk=4)
        assert runner.chunk == (1 if flags.get("public_det") else 4)
        meta = runner.warp(np.zeros((120, 240, 3), np.uint8))[1]
        ptf = runner._parity_tf(meta)
        assert (ptf is None) == (not flags.get("embed_parity"))
    np.testing.assert_allclose(ptf[6:], [240, 120])


@pytest.mark.parametrize("flag", ["debug", "delta_upload", "yuv_upload"])
def test_refusals_that_stay(setup, flag):
    """``debug`` needs the visualizer, which is not ported; the wire
    encodings are off under public detections, as in the JAX runner
    (runner.py:140-142, :351-352), so the runner builds and ships plain
    frames."""
    cfg = port_mot_config(public_det=True, **SIZE).replace(
        **{flag: 1 if flag == "debug" else True})
    if flag == "debug":
        with pytest.raises(NotImplementedError, match=flag):
            PipelinedRunner(Detector(cfg, setup["sd"], device="cpu"))
        return
    runner = PipelinedRunner(Detector(cfg, setup["sd"], device="cpu"))
    assert not (runner._yuv_mode or runner._delta_mode or runner.host_warp)
    assert "prev_frame" not in runner.state
