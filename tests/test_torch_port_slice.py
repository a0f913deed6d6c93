"""The slice as a whole: ``Detector.run`` of the port vs the JAX package's.

A 6-frame synthetic sequence of moving coloured rectangles goes through the
JAX ``Detector(cfg, model, variables).run({"images", "meta"})`` and the
port's ``Detector(cfg, state_dict, device="cpu").run(...)`` with the same
prefetched (already warped and normalized) inputs: the two packages warp
differently by design (cv2 on the host vs the separable two-matmul warp),
so the comparison starts after the warp.  Per frame the online tracks must
agree: count, ids, and boxes within 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deft_tpu.config import mot_config
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.inference.detector import Detector

SIZE = dict(input_h=64, input_w=128, max_object=8, K=16, dcn_offset_range=1)
FRAMES = 6
SCORE_TOL = 1e-4       # fp32 scores of the two packages, absolute
BOX_TOL = 1e-3         # pixels


def frames(seed=0, h=120, w=240):
    """Moving, coloured rectangles on a noisy background (uint8 BGR)."""
    rng = np.random.RandomState(seed)
    boxes = [(10, 20, 30, 50, (250, 40, 40)), (60, 150, 25, 45, (30, 220, 60)),
             (30, 90, 35, 35, (40, 60, 240)), (70, 30, 20, 60, (230, 230, 30))]
    vel = [(2, 3), (-1, -4), (3, 1), (-2, 2)]
    out = []
    for f in range(FRAMES):
        img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
        for (y, x, bh, bw, col), (vy, vx) in zip(boxes, vel):
            y0, x0 = y + vy * f, x + vx * f
            img[max(y0, 0): y0 + bh, max(x0, 0): x0 + bw] = col
        out.append(img)
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def detectors():
    cfg = mot_config(**SIZE)
    model = jax_create_model(cfg.arch, cfg)
    params, stats = jax_init_model(model, cfg)
    variables = jax.tree.map(np.array, {"params": params,
                                        "batch_stats": stats})
    # fractional DCN offsets reaching past the radius
    rng = np.random.RandomState(11)
    for path, v in list(_leaves(variables["params"])):
        if "conv_offset_mask" in path:
            node = variables["params"]
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = (rng.normal(0, 0.01, v.shape) if path[-1] == "kernel"
                              else rng.uniform(-1.0, 1.0, v.shape)
                              ).astype(np.float32)

    jdet = JaxDetector(cfg, model=model, variables=variables)
    inputs = [dict(zip(("images", "meta"), jdet.pre_process(f)))
              for f in frames()]
    # random weights give a flat heatmap far below the 0.4 threshold:
    # rescale the head so ~4% of the first frame's pixels score above 0.5
    out, _ = model.apply(variables, jnp.asarray(inputs[0]["images"]))
    z = np.asarray(out["hm"])
    gain = 2.0 / z.std()
    hm = variables["params"]["head_hm"]["out"]
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = ((hm["bias"] - np.percentile(z, 96)) * gain).astype(np.float32)

    jdet = JaxDetector(cfg, model=model, variables=variables)
    pdet = Detector(port_mot_config(**SIZE),
                    from_jax_variables(variables, cfg), device="cpu")
    return cfg, jdet, pdet, inputs


def test_detector_run_matches_jax(detectors):
    cfg, jdet, pdet, inputs = detectors
    n_tracks = []
    for f, inp in enumerate(inputs):
        dets, _ = jdet.process(inp["images"], inp["meta"])
        scores = dets["scores"][0]
        n = int((scores >= cfg.out_thresh).sum())
        # the order and the cut are stable only with margins far above the
        # score tolerance
        assert np.abs(scores - cfg.out_thresh).min() > 10 * SCORE_TOL, f
        assert n == 0 or np.diff(-scores[: n]).min(initial=1.0) > 10 * SCORE_TOL, f

        j_online = jdet.run(inp)
        p_online = pdet.run(inp)
        assert len(p_online) == len(j_online), f
        assert [t.track_id for t in p_online] == [t.track_id for t in j_online]
        for a, b in zip(p_online, j_online):
            np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=BOX_TOL,
                                       err_msg=f"frame {f}")
        n_tracks.append(len(p_online))
    assert min(n_tracks) >= 2 and sum(n_tracks) >= 3 * FRAMES, n_tracks
