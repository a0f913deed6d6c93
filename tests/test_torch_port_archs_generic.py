"""The port's other detection-only families against the JAX package on the
CPU: ``mobilenet`` (MobileNetV2 + the DCN deconv neck at 64 channels),
``dlav0_34`` (DLA-34 + the legacy concat-node DLAUp) and ``generic``
(ResNet-18 + the generic DLAUp with DCN nodes; MobileNetV2 + the DCN
deconv neck).  The conv-node generic DLAUp and the stems are in
``test_torch_port_archs.py``.

Tolerances as ``torch_port_archs_setup``: every head and feature map within
1e-4 of its largest value; ``detect``'s scores within 1e-5 and boxes within
1e-4 px.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_archs_setup import check_forward, image, nets

from deft_tpu_torch.models.generic import GenericNet

CASES = {
    "mobilenet": ("mobilenet", dict(msra_outchannel=64)),
    "dlav0_34": ("dlav0_34", {}),
    "generic_dlaup_dcn": ("generic", dict(backbone="resnet", num_layers=18,
                                          neck="dlaup")),
    "generic_mobilenet_msraup": ("generic", dict(backbone="mobilenet",
                                                 neck="msraup",
                                                 msra_outchannel=64)),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes on one
    machine (as ``test_torch_port_bf16.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(CASES))
def case_nets(request):
    arch, kw = CASES[request.param]
    return (request.param,) + nets(arch, **kw)


def test_forward_matches_jax(case_nets):
    name, cfg, model, variables, _, port = case_nets
    assert isinstance(port, GenericNet)
    _, j_maps = check_forward(model, variables, port, image(2))
    # backbone scales + neck taps: DLA's 6 + 3 concat stages, ResNet's
    # 5 + 7 DLAUp / IDAUp outputs, MobileNetV2's 5 + 3 deconv stages
    want = {"dlav0_34": 9, "generic_dlaup_dcn": 12}.get(name, 8)
    assert len(j_maps) == want


def test_detect_matches_jax(case_nets):
    _, cfg, model, variables, _, port = case_nets
    x = image(3)
    want = model.apply(variables, jnp.asarray(x), k=cfg.K, method="detect")
    with torch.no_grad():
        got = port.detect(torch.from_numpy(x), k=cfg.K)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["inds"].numpy(), want["inds"])
    for key in ("bboxes", "tracking"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-4, err_msg=key)
