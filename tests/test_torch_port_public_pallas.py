"""Public detections under ``dcn_impl="pallas"`` (the JAX T2 kernel in
interpret mode): ``embed_image`` in both ``dcn_impl`` values against the
JAX package, and the public runner as a whole against the JAX runner, on
the CPU.  The scene, the weights (the ``setup`` fixture) and the
tolerances are ``test_torch_port_public.py``'s; these tests live in a file
of their own so that the interpret-mode runner runs on a worker of its
own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.pallas_dcn as pallas_dcn
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu.models import create_model as jax_create_model
from deft_tpu_torch.inference.detector import Detector, public_det_centers
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.track import track_videos
from test_torch_port_public import (BOX_TOL, EMB_TOL, FRAMES,  # noqa: F401
                                    PALLAS_RTOL, SIZE, _meta, public, scene,
                                    setup)


@pytest.fixture(scope="module")
def pallas_runs(setup):
    """``dcn_impl="pallas"`` on both sides, the JAX T2 kernel in interpret
    mode: the JAX public runner over 6 frames at the input size (its
    jitted ``frame_step_embed`` compiled once), and through that program
    the JAX embeddings of frame 1's boxes (its ring row 0 after one step
    on an empty ring)."""
    frames, boxes = scene(SIZE["input_h"], SIZE["input_w"])
    dets = public(boxes, SIZE["input_h"], SIZE["input_w"], seed=2)
    dets[3] = dets[4]                  # every frame public here
    cfg = setup["cfg"].replace(dcn_impl="pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_dcn, "deform_conv_pallas_tap", functools.partial(
            pallas_dcn.deform_conv_pallas_tap, interpret=True))
        jrun = JaxRunner(JaxDetector(cfg, model=jax_create_model(cfg.arch,
                                                                 cfg),
                                     variables=setup["variables"]),
                         depth=2, chunk=4)
        empty = jax.tree.map(jnp.zeros_like, jrun.state)
        want = [[(t.track_id, np.asarray(t.tlbr)) for t in online]
                for online in jrun.track_sequence(
                    frames, [_meta(d) for d in dets])]
        warped, meta = jrun.warp(frames[1], _meta(dets[1]))
        centers, n = public_det_centers(dets[1], meta, SIZE["max_object"])
        _, state = jrun._step_embed(setup["variables"], jnp.asarray(warped),
                                    jnp.asarray(centers), jnp.int32(n),
                                    empty)
    prun = PipelinedRunner(Detector(setup["pcfg"].replace(dcn_impl="pallas"),
                                    setup["sd"], device="cpu"),
                           depth=2, chunk=4)
    return {"frames": frames, "dets": dets, "jrun": jrun, "prun": prun,
            "want": want, "emb": (warped, centers, n,
                                  np.asarray(state["embeds"][0][:n]))}


@pytest.mark.parametrize("impl", ["hybrid", "pallas"])
def test_embed_image_matches_jax(setup, pallas_runs, impl):
    """The trunk and the AFE at public centres (ten boxes, eight of which
    fit): hybrid float32 within EMB_TOL against the JAX ``embed_image``,
    pallas within PALLAS_RTOL against the embeddings the JAX public
    runner's program writes into its ring."""
    if impl == "hybrid":
        inp = setup["inputs"][1]
        image = inp["images"]
        centers, n = public_det_centers(setup["dets"][1], inp["meta"],
                                        SIZE["max_object"])
        want = np.asarray(setup["jdet"]._embed(
            setup["variables"], jnp.asarray(image),
            jnp.asarray(centers[None])))[0]
        port = setup["pdet"].model
    else:
        warped, centers, n, want = pallas_runs["emb"]
        image = warped[None]
        port = pallas_runs["prun"].det.model
    assert n == SIZE["max_object"]
    with torch.no_grad():
        got = port.embed_image(torch.from_numpy(image),
                               torch.from_numpy(centers[None]))[0].numpy()
    assert got.shape == (n, port.embed_dim) and want.shape[0] == n
    want = want[:n]
    if impl == "hybrid":
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    else:
        assert (np.abs(got - want)
                <= PALLAS_RTOL * (np.abs(want) + np.abs(want).max())).all()



def test_runner_public_matches_jax(pallas_runs):
    """The public runner (``dcn_impl="pallas"``) against the JAX one, both
    asked for chunk 4 and both running chunk 1.  The frames are at the
    input's size, so the JAX host warp and the port's device warp are both
    the identity (asserted).  Ids exact, boxes within BOX_TOL."""
    frames, dets = pallas_runs["frames"], pallas_runs["dets"]
    jrun, prun = pallas_runs["jrun"], pallas_runs["prun"]
    assert jrun.chunk == prun.chunk == 1
    warped, meta = jrun.warp(frames[0], _meta(dets[0]))
    np.testing.assert_array_equal(warped, frames[0])
    assert meta["cur_dets"] is dets[0]
    raw, pmeta = prun.warp(frames[0], _meta(dets[0]))
    assert pmeta["cur_dets"] is dets[0]
    model = prun.det.model
    with torch.no_grad():
        np.testing.assert_array_equal(
            model._warp_normalize(torch.from_numpy(raw)[None],
                                  pmeta["warp_tf"],
                                  (SIZE["input_h"], SIZE["input_w"])).numpy(),
            model._maybe_normalize(torch.from_numpy(frames[0])[None]).numpy())

    ids = list(range(FRAMES))
    results = track_videos(prun, [(1, list(zip(ids, frames)))],
                           public_dets=dict(zip(ids, dets)))
    assert len(pallas_runs["want"]) == FRAMES
    for f, (want, i) in enumerate(zip(pallas_runs["want"], ids)):
        got = results[i]
        assert [it["tracking_id"] for it in got] == [t for t, _ in want], f
        for it, (_, box) in zip(got, want):
            np.testing.assert_allclose(it["bbox"], box, rtol=0, atol=BOX_TOL)
        assert len(got) <= min(len(dets[f]), SIZE["max_object"])
    assert min(len(results[i]) for i in ids[3:]) >= 4
    keys = prun.timings()
    assert {"dispatch", "casc_track", "cascade"} <= set(keys)
