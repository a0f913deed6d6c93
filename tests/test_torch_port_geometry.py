"""Test-time geometry (``flip_test``, ``keep_res``, ``fix_short``): the
port against the JAX package on the CPU (``tests/torch_port_geometry_setup.py``
says what the scenes, the weights and the checks are).

* the model: ``detect(flip_test=True)`` against the JAX ``detect`` on the
  same weights, and its mirror consistency (``tests/test_runner.py::
  test_flip_test_mirror_consistency`` on the JAX side);
* the geometry: ``_transform_scale`` and ``pre_process`` of each geometry
  (and of a test scale other than 1) against the JAX detector's, the
  runner's host warp against the JAX runner's cv2 warp, ``resize_linear``
  against ``cv2.resize``;
* MOT through ``Detector.run`` under each geometry against the JAX
  ``Detector.run``;
* ``embed_parity`` with a chunk above 1 under ``keep_res`` or
  ``fix_short`` raises in both runners.

KITTI, the runner and nuScenes' ``run_multi`` are in the other
``test_torch_port_geometry_*.py`` files, each on a worker of its own.
"""

import cv2
import numpy as np
import pytest
import torch

import torch_port_geometry_setup as G
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.ops.warp import resize_linear
from torch_port_geometry_setup import few_threads  # noqa: F401

# one uint8 step of the input warp, normalized (ops/warp.py: cv2 rounds its
# bilinear weights to 5 bits)
WARP_STEP = 1.0 / 255.0 / 0.27408164


@pytest.fixture(scope="module")
def mot():
    """The MOT frames and the weights of each geometry."""
    frames = G.mot_frames()
    return {geometry: G.geometry_weights("mot", geometry, frames)
            for geometry in G.GEOMETRIES}, frames


# ---- the model ---------------------------------------------------------------

def test_detect_flip_matches_jax(mot):
    """``DEFTNet.detect(flip_test=True)`` against the JAX ``detect`` with
    ``flip_test``: every decoded output and the embeddings."""
    weights, frames = mot
    jdet, pdet = G.detectors(weights["flip_test"], "mot",
                             G.GEOMETRIES["flip_test"])
    for frame in frames[:2]:
        images, meta = jdet.pre_process(frame)
        want, want_emb = jdet.process(images, meta)
        with torch.no_grad():
            got, emb = pdet.model.detect(torch.from_numpy(images), k=16,
                                         flip_test=True)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(emb.numpy(), want_emb, rtol=0, atol=1e-4)


def test_detect_flip_averages_the_mirror(mot):
    """The flip table on the port alone: ``hm`` and ``wh`` are the mean of
    the image's pass and the mirror's pass flipped back, every other head
    (``reg``, ``tracking``, ``ltrb_amodal``) the image's, and the feature
    maps the image's.  Checked through ``_flip_forward`` against two
    batch-1 forwards."""
    weights, frames = mot
    _, pdet = G.detectors(weights["flip_test"], "mot",
                          G.GEOMETRIES["flip_test"])
    images, _ = pdet.pre_process(frames[0])
    with torch.no_grad():
        got, maps = pdet.model._flip_forward(images)
        plain, plain_maps = pdet.model(images)
        mirror, _ = pdet.model(images.flip(2))
    for head, o in plain.items():
        want = ((o + mirror[head].flip(2)) / 2.0 if head in ("hm", "wh")
                else o)
        np.testing.assert_allclose(got[head].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=head)
    assert len(maps) == len(plain_maps) == 13
    for a, b in zip(maps, plain_maps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_flip_test_mirror_consistency(mot):
    """The port's ``detect(flip_test=True)`` is equivariant under mirroring
    its input, with the JAX test's tolerances: the same scores, x-mirrored
    boxes."""
    weights, frames = mot
    _, pdet = G.detectors(weights["flip_test"], "mot",
                          G.GEOMETRIES["flip_test"])
    images, _ = pdet.pre_process(frames[0])
    with torch.no_grad():
        d1, _ = pdet.model.detect(images, k=8, flip_test=True)
        d2, _ = pdet.model.detect(images.flip(2), k=8, flip_test=True)
    s1, s2 = d1["scores"][0].numpy(), d2["scores"][0].numpy()
    np.testing.assert_allclose(np.sort(s1), np.sort(s2), rtol=1e-3, atol=1e-4)
    out_w = images.shape[2] // 4
    b1 = d1["bboxes"][0][0].numpy()
    b2 = d2["bboxes"][0][0].numpy()
    np.testing.assert_allclose(b2[0], out_w - 1 - b1[2], atol=0.1)
    np.testing.assert_allclose(b2[2], out_w - 1 - b1[0], atol=0.1)
    np.testing.assert_allclose(b2[1], b1[1], atol=1e-2)


# ---- the geometry ------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["mot", "kitti"])
@pytest.mark.parametrize("geometry", ["fix_res", "keep_res", "fix_short"])
@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_transform_and_pre_process_match_jax(mot, dataset, geometry, scale):
    """Centre, scale, input size and input warp of every geometry as the
    JAX detector's; the warped input equal under ``keep_res`` (integer
    shifts) and within one uint8 step otherwise (the JAX package warps
    with cv2); at a scale other than 1 the resized frame within one uint8
    step of ``cv2.resize``'s."""
    _, model, variables, _ = mot[0]["flip_test"]
    jax_config, port_config, size = G.CONFIGS[dataset]
    flags = dict(size, **G.GEOMETRIES.get(geometry, {}))
    frame = G.SCENES[dataset](1)[0]
    # the preprocessing reads no weight: KITTI's detectors keep MOT's JAX
    # ones and the port's seeded ones
    jdet = JaxDetector(jax_config(**flags), model=model, variables=variables)
    pdet = Detector(port_config(**flags), device="cpu")
    want = jdet._transform_scale(frame, scale)
    got = pdet._transform_scale(frame, scale)
    assert got[0].shape == want[0].shape
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    images, meta = pdet.pre_process(frame, scale=scale)
    j_images, j_meta = jdet.pre_process(frame, scale)
    assert set(meta) == set(j_meta)
    for key, value in j_meta.items():
        np.testing.assert_allclose(meta[key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
    # steps: the warp's rounding, and at another scale the resize's too
    steps = 1.01 if scale == 1.0 else 2.01
    exact = geometry == "keep_res" and scale == 1.0
    np.testing.assert_allclose(images.numpy(), j_images, rtol=0,
                               atol=1e-5 if exact else WARP_STEP * steps)


@pytest.mark.parametrize("geometry", ["keep_res", "fix_short"])
def test_runner_host_warp_matches_jax(mot, geometry):
    """Under ``keep_res`` and ``fix_short`` the runner warps on the host
    (``warp_affine_uint8``), as the JAX runner does with cv2: the same
    frame meta, the warped frame equal under ``keep_res`` and within one
    uint8 step under ``fix_short``; no device transform."""
    weights, frames = mot
    flags = dict(G.GEOMETRIES[geometry], device_warp=True)
    jdet, pdet = G.detectors(weights[geometry], "mot", flags)
    jrun = JaxRunner(jdet, depth=1)
    prun = PipelinedRunner(pdet, depth=1)
    assert prun.host_warp
    warped, meta = prun.warp(frames[3])
    j_warped, j_meta = jrun.warp(frames[3])
    assert meta["warp_tf"] is None and j_meta["warp_tf"] is None
    assert warped.shape == j_warped.shape == (
        meta["inp_height"], meta["inp_width"], 3)
    diff = np.abs(warped.astype(int) - j_warped.astype(int))
    assert diff.max() <= (0 if geometry == "keep_res" else 1)
    for key, value in j_meta.items():
        if key != "warp_tf":
            np.testing.assert_allclose(meta[key], value, rtol=0, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.5, 2.0])
@pytest.mark.parametrize("shape", [(120, 180, 3), (37, 53, 3), (96, 312)])
def test_resize_linear_matches_cv2(scale, shape):
    """``resize_linear`` against ``cv2.resize`` (INTER_LINEAR): within one
    uint8 step everywhere, equal on almost every pixel (cv2's upscaling
    rounds a few pixels the other way)."""
    rng = np.random.RandomState(int(scale * 10) + len(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    out_w, out_h = int(shape[1] * scale), int(shape[0] * scale)
    got = resize_linear(img, out_w, out_h)
    want = cv2.resize(img, (out_w, out_h))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("geometry", ["keep_res", "fix_short"])
def test_embed_parity_chunked_raises(mot, geometry):
    """``embed_parity`` at chunk 4 under ``keep_res`` or ``fix_short``
    raises a ``ValueError`` in both runners; chunk 1 and fix_res run."""
    weights = mot[0][geometry]
    flags = dict(G.GEOMETRIES[geometry], embed_parity=True)
    jdet, pdet = G.detectors(weights, "mot", flags)
    with pytest.raises(ValueError, match="embed_parity"):
        JaxRunner(jdet, chunk=4)
    with pytest.raises(ValueError, match="embed_parity"):
        PipelinedRunner(pdet, chunk=4)
    assert PipelinedRunner(pdet, chunk=1).chunk == 1
    _, fix_res = G.detectors(weights, "mot", {"embed_parity": True})
    assert PipelinedRunner(fix_res, chunk=4).chunk == 4


# ---- Detector.run --------------------------------------------------------------

def run_and_compare(weights, dataset, flags, frames):
    """Every frame through the JAX ``Detector.run`` and the port's on the
    JAX package's prefetched inputs; per frame the tracks must agree
    (module docstring of the setup).  Returns the tracks per frame."""
    jdet, pdet = G.detectors(weights, dataset, flags)
    n_tracks = []
    for f, frame in enumerate(frames):
        images, meta = jdet.pre_process(frame)
        inp = {"images": images, "meta": meta}
        dets, _ = jdet.process(images, meta)
        G.check_margins(dets, jdet.cfg.out_thresh, G.TRACKED[dataset], f)
        want = jdet.run(inp)
        got = pdet.run(inp)
        G.check_tracks(got, want, f"{dataset} {flags} frame {f}")
        n_tracks.append(len(want))
    return n_tracks


@pytest.mark.parametrize("geometry", sorted(G.GEOMETRIES))
def test_detector_run_matches_jax(mot, geometry):
    weights, frames = mot
    n_tracks = run_and_compare(weights[geometry], "mot",
                               G.GEOMETRIES[geometry], frames)
    assert sum(n_tracks) >= len(frames), n_tracks
