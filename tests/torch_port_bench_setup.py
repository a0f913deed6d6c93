"""Shared by the bench slice's runner tests (``test_torch_port_bench_*.py``):
the weights, the scene and the checks of the upload modes, the staging
modes, ``cap`` and ``lookahead`` against the JAX package and against the
port's own plain run, on the CPU.

The model is ``mot_config`` at 96x160 with ``dla_node="conv"`` (no DCN:
these tests hold the runner's wire and staging, not the kernels),
max_object 8, K 16, with the port's seeded init carried into the JAX
package by its checkpoint converter, the heatmap head rescaled on the first
frame so that ~2% of its pixels score above 0.5, and the box heads biased
so that boxes have an extent.  The scene is 8 frames of moving rectangles
on noise at 96x160, the input size: the fix_res warp is the identity, so
the JAX runner's cv2 warp and the port's ``warp_affine_uint8`` give the
same bytes, and the frames the wire encodings see are equal.

Per frame the online tracks must agree with the JAX runner's: ids exactly,
boxes within BOX_TOL pixels (float32 convolutions sum in another order in
the two packages).  Against the port's own plain run (the same programs on
the same frames) they must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from deft_tpu.config import mot_config
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.models.factory import create_model

SIZE = dict(input_h=96, input_w=160, max_object=8, K=16, dla_node="conv")
FRAMES = 8
BOX_TOL = 1e-3            # pixels
OBJECTS = [  # y, x, h, w, colour, (vy, vx) per frame, in 96x160 pixels
    (8, 12, 28, 16, (250, 40, 40), (2, 3)),
    (52, 110, 24, 14, (30, 220, 60), (-1, -3)),
    (30, 64, 30, 20, (40, 60, 240), (2, 1)),
    (60, 22, 20, 28, (230, 230, 30), (-2, 2)),
]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's models: the suite runs several
    test processes on one machine (as ``test_torch_port_nuscenes.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def frames(n=FRAMES):
    """Moving rectangles on noise, 96x160 uint8 BGR."""
    rng = np.random.RandomState(0)
    out = []
    for f in range(n):
        img = rng.randint(0, 40, (96, 160, 3)).astype(np.uint8)
        for y, x, h, w, col, (vy, vx) in OBJECTS:
            y0, x0 = max(y + vy * f, 0), max(x + vx * f, 0)
            img[y0: y + vy * f + h, x0: x + vx * f + w] = col
        out.append(img)
    return out


def build_weights(frame: np.ndarray):
    """(JAX config, JAX model, JAX variables, port state dict) of the module
    docstring."""
    cfg, pcfg = mot_config(**SIZE), port_mot_config(**SIZE)
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in create_model(
        pcfg.arch, pcfg, "cpu").state_dict().items()}
    params, stats = TorchConverter(cfg.dataset).convert_dla34(
        init, cfg.heads, cfg.dla_node, DLA_PLANS["34"][0])
    variables = {"params": params, "batch_stats": stats}
    heads = variables["params"]
    hm = heads["head_hm"]["out"]
    hm["bias"] = np.zeros_like(hm["bias"])
    port = Detector(pcfg, from_jax_variables(variables, cfg), device="cpu")
    images, _ = port.pre_process(frame)
    with torch.no_grad():
        out, _ = port.model(images)
    z = out["hm"].numpy().reshape(-1, out["hm"].shape[-1])
    gain = 2.0 / z.std(axis=0)
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = (-np.percentile(z, 98.0, axis=0) * gain).astype(np.float32)
    for head, bias in (("ltrb_amodal", [-4, -4, 4, 4]), ("wh", [8, 8])):
        out = heads[f"head_{head}"]["out"]
        out["bias"] = (out["bias"] + np.float32(bias)).astype(np.float32)
    model = jax_create_model(cfg.arch, cfg)
    return cfg, model, variables, from_jax_variables(variables, cfg)


def jax_runner(weights, chunk: int, **flags):
    cfg, model, variables, _ = weights
    return JaxRunner(JaxDetector(cfg.replace(**flags), model=model,
                                 variables=variables), depth=3, chunk=chunk)


def port_runner(weights, chunk: int, **flags):
    sd = weights[3]
    return PipelinedRunner(Detector(port_mot_config(**SIZE, **flags), sd,
                                    device="cpu"), depth=3, chunk=chunk)


def first_seen(seq):
    """Each frame's track ids as their order of first appearance: a runner
    reset between sequences keeps counting ids (a fresh tracker takes the
    next ones, as in the JAX package)."""
    order = {}
    return [[order.setdefault(t.track_id, len(order)) for t in fr]
            for fr in seq]


def check_tracks(got, want, where, exact=False, relabel=False):
    """Per frame the same ids (as ``first_seen`` with ``relabel``) and
    boxes: within BOX_TOL, or bit for bit."""
    assert len(got) == len(want), where
    ids = first_seen if relabel else (
        lambda seq: [[t.track_id for t in fr] for fr in seq])
    for f, (a, b) in enumerate(zip(ids(got), ids(want))):
        assert a == b, f"{where} frame {f}"
    for f, (a_fr, b_fr) in enumerate(zip(got, want)):
        for a, b in zip(a_fr, b_fr):
            if exact:
                np.testing.assert_array_equal(a.tlbr, b.tlbr,
                                              err_msg=f"{where} frame {f}")
            else:
                np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0,
                                           atol=BOX_TOL,
                                           err_msg=f"{where} frame {f}")


def n_tracks(seq) -> int:
    return sum(len(fr) for fr in seq)
