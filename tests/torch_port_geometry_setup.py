"""Shared by the test-time geometry files of the port
(``test_torch_port_geometry*.py``): the weights, the scenes and the checks
of ``flip_test``, ``keep_res`` and ``fix_short`` against the JAX package,
on the CPU.

The models are ``mot_config`` at 64x96 and ``kitti_config`` at 64x192
(max_object 8, K 16 and 32, ``dcn_offset_range`` 1, ``dcn_impl="hybrid"``, the
JAX package's default: XLA's onehot on the CPU, ``deform_conv`` in the
port), with the port's seeded init carried into the JAX package by its
checkpoint converter, every offset conv randomized (fractional samples
past the radius), the heatmap head rescaled on the first frame so that a
per cent of its pixels score above 0.5 in every class, and the box
heads biased so that boxes have an extent.  The scenes are 120x180 frames
of moving rectangles (MOT) and 96x312 frames of the port's numpy KITTI
generator, so that each geometry gives its own input size:

* fix_res (``flip_test``): 64x96 and 64x192;
* ``keep_res``: 128x192 and 128x320 (pure integer shifts, so cv2's warp
  and the port's agree bit for bit);
* ``fix_short`` 64: 64x128 and 64x256 (scaled; the packages' warps differ
  by up to one uint8 step, so ``Detector.run`` compares on the JAX
  package's prefetched warped inputs, as ``test_torch_port_slice.py``
  does, and the runner on the JAX runner's host-warped frames through
  ``submit_warped``).

Per frame the online tracks must agree: ids exactly, boxes within BOX_TOL
pixels and scores within SCORE_TOL (float32 convolutions sum in another
order in the two packages).  The decoded scores of every frame keep
margins of 10 x SCORE_TOL from the cut and between the tracked class's
neighbours, so the order and the cut cannot flip by rounding
(``check_margins``); the seeds are ones whose frames keep them.
"""

import numpy as np
import pytest
import torch

from deft_tpu.config import kitti_config, mot_config
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu_torch.config import kitti_config as port_kitti_config
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.data import synthetic_kitti
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.models.factory import create_model

MOT_SIZE = dict(input_h=64, input_w=96, max_object=8, K=16,
                dcn_offset_range=1)
KITTI_SIZE = dict(input_h=64, input_w=192, max_object=8, K=32,
                  dcn_offset_range=1)
CONFIGS = {"mot": (mot_config, port_mot_config, MOT_SIZE),
           "kitti": (kitti_config, port_kitti_config, KITTI_SIZE)}
GEOMETRIES = {"flip_test": {"flip_test": True}, "keep_res": {"keep_res": True},
              "fix_short": {"fix_short": 64}}
# the heatmap head's logit spread and its 0.5 cut on the first frame: 1% of
# MOT's pixels; KITTI's three classes are all drawn at the 0.4 cut, so each
# class's spread is wider and its cut higher
HM_GAIN = {"mot": 2.0, "kitti": 4.0}
HM_PERCENTILE = {"mot": 99.0, "kitti": 99.8}
FRAMES = 8
BOX_TOL = 1e-3            # pixels
SCORE_TOL = 1e-4
# the class each dataset tracks (0-based; -1: every class)
TRACKED = {"mot": -1, "kitti": 1}
OBJECTS = [  # y, x, h, w, colour, (vy, vx) per frame, in 120x180 pixels
    (10, 15, 30, 18, (250, 40, 40), (2, 3)),
    (60, 120, 26, 16, (30, 220, 60), (-1, -3)),
    (35, 70, 34, 22, (40, 60, 240), (2, 1)),
    (75, 25, 22, 30, (230, 230, 30), (-2, 2)),
]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's models: the suite runs several
    test processes on one machine, and each one's default of a thread per
    core oversubscribes it (as ``test_torch_port_nuscenes.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def mot_frames(n=FRAMES):
    """Moving rectangles on noise, 120x180 uint8 BGR."""
    rng = np.random.RandomState(0)
    out = []
    for f in range(n):
        img = rng.randint(0, 40, (120, 180, 3)).astype(np.uint8)
        for y, x, h, w, col, (vy, vx) in OBJECTS:
            y0, x0 = max(y + vy * f, 0), max(x + vx * f, 0)
            img[y0: y + vy * f + h, x0: x + vx * f + w] = col
        out.append(img)
    return out


def kitti_frames(n=FRAMES):
    """The port's numpy KITTI generator at 96x312, with noise on its
    background (no plateaus of tied heatmap peaks)."""
    frames, _ = synthetic_kitti.make_sequence(n_frames=n, height=96,
                                              width=312, n_objects=6, seed=2)
    rng = np.random.RandomState(5)
    return [np.clip(f.astype(np.int16) + rng.randint(-12, 12, f.shape),
                    0, 255).astype(np.uint8) for f in frames]


SCENES = {"mot": mot_frames, "kitti": kitti_frames}
# offset seed per (dataset, geometry): one whose frames keep the margins of
# ``check_margins`` (seeds 11-20 and 1-11 scanned with the port)
SEEDS = {("mot", "flip_test"): 12, ("mot", "keep_res"): 16,
         ("mot", "fix_short"): 15, ("kitti", "flip_test"): 8,
         ("kitti", "keep_res"): 7, ("kitti", "fix_short"): 5}


def seeded_variables(dataset: str, offset_seed: int):
    """(JAX config, JAX variables): the port's seeded init through the JAX
    package's converter, every offset conv randomized."""
    jax_config, port_config, size = CONFIGS[dataset]
    cfg, pcfg = jax_config(**size), port_config(**size)
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in create_model(
        pcfg.arch, pcfg, "cpu").state_dict().items()}
    params, stats = TorchConverter(cfg.dataset).convert_dla34(
        init, cfg.heads, cfg.dla_node, DLA_PLANS["34"][0])
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.RandomState(offset_seed)

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
    return cfg, variables


def build_weights(dataset: str, frame: np.ndarray, offset_seed: int,
                  flags: dict):
    """(JAX config, JAX model, JAX variables, port state dict) of the
    module docstring, the heatmap rescaled on ``frame`` in the geometry of
    ``flags``."""
    _, port_config, size = CONFIGS[dataset]
    cfg, variables = seeded_variables(dataset, offset_seed)
    pcfg = port_config(**size, **flags)
    heads = variables["params"]
    # the heatmap's spread is read with its bias at 0: about the -4.6
    # prior it is below float32's resolution
    hm = heads["head_hm"]["out"]
    hm["bias"] = np.zeros_like(hm["bias"])
    port = Detector(pcfg, from_jax_variables(variables, cfg), device="cpu")
    images, _ = port.pre_process(frame)
    with torch.no_grad():
        out, _ = port.model(images)         # no flip: the head's own spread
    z = out["hm"].numpy().reshape(-1, out["hm"].shape[-1])
    gain = HM_GAIN[dataset] / z.std(axis=0)            # per class
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = (-np.percentile(z, HM_PERCENTILE[dataset], axis=0)
                  * gain).astype(np.float32)
    for head, bias in (("ltrb_amodal", [-4, -4, 4, 4]), ("wh", [8, 8])):
        if f"head_{head}" in heads:
            out = heads[f"head_{head}"]["out"]
            out["bias"] = (out["bias"] + np.float32(bias)).astype(np.float32)
    model = jax_create_model(cfg.arch, cfg)
    return cfg, model, variables, from_jax_variables(variables, cfg)


def detectors(weights, dataset: str, flags: dict):
    """The JAX and the port's ``Detector`` of ``weights`` under ``flags``."""
    cfg, model, variables, sd = weights
    _, port_config, size = CONFIGS[dataset]
    jdet = JaxDetector(cfg.replace(**flags), model=model, variables=variables)
    pdet = Detector(port_config(**size, **flags), sd, device="cpu")
    return jdet, pdet


def check_margins(dets: dict, cut: float, tracked: int, where):
    """The detections that reach the tracker cannot change by SCORE_TOL:
    every score keeps 10 x SCORE_TOL from the cut, the top K ends below it
    (none is left out), and the scores of the tracked class (0-based,
    -1 every class) keep that margin from each other, so their order
    holds."""
    scores, clses = dets["scores"][0], dets["clses"][0]
    assert np.abs(scores - cut).min() > 10 * SCORE_TOL, where
    assert scores[-1] < cut, where
    mine = scores[(scores >= cut) & ((clses == tracked) | (tracked < 0))]
    assert np.diff(-np.sort(mine)[::-1]).min(initial=1.0) > 10 * SCORE_TOL, \
        where


def check_tracks(got, want, where):
    """One frame's online tracks of both packages (module docstring)."""
    assert [t.track_id for t in got] == [t.track_id for t in want], where
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=BOX_TOL,
                                   err_msg=where)
        assert abs(a.score - b.score) <= SCORE_TOL, where



def geometry_weights(dataset: str, geometry: str, frames):
    """``build_weights`` of ``dataset`` for ``geometry`` (a key of
    ``GEOMETRIES``) on ``frames[0]``, with its seed."""
    return build_weights(dataset, frames[0], SEEDS[(dataset, geometry)],
                         GEOMETRIES[geometry])


def runners(weights, dataset: str, geometry: str, chunk: int):
    """The JAX and the port's ``PipelinedRunner`` (depth 3) of ``weights``
    under ``geometry``, both with ``device_warp`` (which the JAX runner
    takes under fix_res only, as the port does)."""
    flags = dict(GEOMETRIES[geometry], device_warp=True)
    jdet, pdet = detectors(weights, dataset, flags)
    return (JaxRunner(jdet, depth=3, chunk=chunk),
            PipelinedRunner(pdet, depth=3, chunk=chunk))


def feed_warped(runner, pairs):
    """``track_sequence`` over frames already through ``warp``."""
    out = []
    for warped, meta in pairs:
        done = runner.submit_warped(warped, meta)
        if done is not None:
            out.extend(done if runner.chunk > 1 else [done])
    out.extend(runner.flush())
    return out


def check_runner(weights, dataset: str, geometry: str, chunk: int, frames):
    """Both runners over ``frames``: the same tracks per frame.  Under
    ``fix_short`` the JAX runner's host-warped frames go into both through
    ``submit_warped`` (module docstring); the margins are checked on the
    port's decode of each frame as the runners warp it."""
    jrun, prun = runners(weights, dataset, geometry, chunk)
    warp = (jrun.det if geometry == "fix_short" else prun.det).pre_process
    for f, frame in enumerate(frames):
        images, meta = warp(frame)
        dets, _ = prun.det.process(images, meta)
        check_margins(dets, prun.cfg.out_thresh, TRACKED[dataset], f)
    if geometry == "fix_short":
        pairs = [jrun.warp(frame) for frame in frames]
        want, got = feed_warped(jrun, pairs), feed_warped(prun, pairs)
    else:
        want = jrun.track_sequence(frames)
        got = prun.track_sequence(frames)
    assert prun.host_warp == (geometry != "flip_test")
    assert len(got) == len(want) == len(frames)
    for f, (a, b) in enumerate(zip(got, want)):
        check_tracks(a, b, f"{dataset} {geometry} chunk {chunk} frame {f}")
    assert np.isfinite(prun.state["embeds"].numpy()).all()
    return want
