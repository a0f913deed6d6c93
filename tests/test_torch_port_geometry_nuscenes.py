"""``flip_test`` on the batched and the Pallas paths, against the JAX
package on the CPU.

* nuScenes ``Detector.run_multi`` under ``flip_test``: each sample's six
  cameras go through the trunk as one batch of 12 (the images and their
  mirrors), as the JAX ``process`` runs its stacked batch; ``dep``,
  ``dim`` and ``amodel_offset`` (x negated) are averaged with the mirror,
  the other 3-D heads taken from the images.  The scene, the weights and
  the tolerances are ``test_torch_port_nuscenes.py``'s (its ``detectors``
  fixture), on the port's six-camera rig; per sample the same tracks per
  camera, boxes within BOX_TOL.
* ``dcn_impl="pallas"`` under ``flip_test``: the trunk at batch 2 runs
  T2's plain version on each sample, against the JAX forward with its T2
  kernel in interpret mode (``tests/torch_port_geometry_setup.py``'s MOT
  weights), within PALLAS_RTOL: T2 rounds each DCN input to bf16, which
  turns the packages' float32 differences into bf16 steps here and there
  (``tests/test_torch_port_dcn_impl.py``'s tolerance for that path).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.pallas_dcn as pallas_dcn
import torch_port_geometry_setup as G
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.models import create_model as jax_create_model
from test_torch_port_nuscenes import (BOX_TOL, SCORE_TOL,  # noqa: F401
                                      JaxIds, check_cameras, detectors,
                                      few_threads, make_scene, nus_scene,
                                      samples, snapshot)

PALLAS_RTOL = 2e-4        # |a - b| <= rtol * (|b| + max|b|)


def test_run_multi_flip_matches_jax(detectors):
    jplain, port = detectors
    jdet = JaxDetector(jplain.cfg.replace(flip_test=True),
                       model=jplain.model, variables=jplain.variables,
                       motion=jplain.motion)
    jdet.ids = JaxIds()                 # ids from 1, as the fresh port's
    jdet.reset_tracking()
    pdet = port()
    # the flag is read per call (Detector.process), so it may change here
    pdet.cfg = pdet.cfg.replace(flip_test=True)
    frames = make_scene(n_samples=3, cameras=6, height=180, width=320,
                        n_objects=16, seed=4)
    n_tracks = []
    for sample in samples(frames):
        infos = [info for info, _ in sample]
        metas = [{"calib": info["calib"]} for info in infos]
        prepared = [dict(zip(("images", "meta"),
                             jdet.pre_process(frame, 1.0, meta)))
                    for (_, frame), meta in zip(sample, metas)]
        dets, _ = jdet.process(np.concatenate([p["images"] for p in prepared]))
        for cut in (jdet.cfg.out_thresh, 0.3, 0.35):
            assert np.abs(dets["scores"] - cut).min() > 10 * SCORE_TOL
        want = jdet.run_multi([f for _, f in sample], metas, infos,
                              materialize=snapshot)
        got = pdet.run_multi(prepared, None, infos, materialize=snapshot)
        check_cameras(got, want, BOX_TOL)
        n_tracks.append(sum(len(c) for c in want))
    assert min(n_tracks) >= 2 and sum(n_tracks) >= 4 * len(n_tracks), n_tracks


def test_flip_forward_pallas_matches_jax():
    """The heads under ``flip_test`` with ``dcn_impl="pallas"``: the port's
    ``_flip_forward`` (the trunk at batch 2, T2's plain version per sample)
    against the JAX forward of the same batch of the image and its mirror
    (T2 in interpret mode), averaged by ``deft_tpu/models/deft.py:210-226``'s
    table.  Every head within rtol 2e-4, atol 2e-4 x max|head|
    (``tests/test_torch_port_dcn_impl.py``'s tolerance and weights: the
    seeded ones with every bias shifted, so that no head is ~0 and its
    relative error is not float32 noise; measured at 0.16 of the
    tolerance, where the port's float32 ``hybrid`` path misses it by
    1.4x)."""
    frames = G.mot_frames(2)
    flags = dict(G.GEOMETRIES["flip_test"], dcn_impl="pallas")
    cfg, variables = G.seeded_variables("mot", G.SEEDS[("mot", "flip_test")])
    cfg = cfg.replace(**flags)
    rng = np.random.RandomState(0)

    def shift(tree):
        for key, v in tree.items():
            if isinstance(v, dict):
                shift(v)
            elif key == "bias":
                tree[key] = (v + rng.normal(0, 0.05, v.shape)).astype(
                    np.float32)

    shift(variables["params"])
    pdet = G.Detector(G.port_mot_config(**G.MOT_SIZE, **flags),
                      G.from_jax_variables(variables, cfg), device="cpu")
    images, _ = pdet.pre_process(frames[1])
    both = torch.cat([images, images.flip(2)]).numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_dcn, "deform_conv_pallas_tap", functools.partial(
            pallas_dcn.deform_conv_pallas_tap, interpret=True))
        out, _ = jax_create_model(cfg.arch, cfg).apply(variables,
                                                       jnp.asarray(both))
    with torch.no_grad():
        got, _ = pdet.model._flip_forward(images)
    assert sorted(got) == sorted(out)
    for head, o in out.items():
        o = np.asarray(o)
        want = ((o[:1] + o[1:, :, ::-1]) / 2.0 if head in ("hm", "wh")
                else o[:1])
        err = np.abs(got[head].numpy() - want)
        assert (err <= PALLAS_RTOL * (np.abs(want) + np.abs(want).max())
                ).all(), head
