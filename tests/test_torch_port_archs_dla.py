"""DLA-60 and DLA-102 (``--arch dla_60``, ``dla_102``): the port's DEFTNet
at the bottleneck plans against the JAX package's on the CPU.

DLA-60 with the default DCN nodes (the JAX hybrid, ``deform_conv_onehot``
on the CPU, against the port's float32 clamped DCN), DLA-102 (residual
roots) with conv nodes.  Forward: the 13 feature maps (selector widths 16,
32, 128, 256, 512, 1024, 128, 256, 512, 1024, 128, 128, 128) and every head
within 1e-4 of the largest value; the AFE's embeddings at random centres
likewise; the port's keys map back onto every JAX leaf through the JAX
package's converters, bit for bit.
"""

from __future__ import annotations

import pytest
import torch

from torch_port_archs_setup import (check_embeddings, check_forward, image,
                                    nets, round_trip_dla)

from deft_tpu_torch.models.dla import selector_widths

CASES = {"dla_60": "dcn", "dla_102": "conv"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes on one
    machine (as ``test_torch_port_bf16.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(CASES))
def dla_nets(request):
    arch = request.param
    return (arch,) + nets(arch, dla_node=CASES[arch])


def test_forward_and_embeddings_match_jax(dla_nets):
    arch, cfg, model, variables, _, port = dla_nets
    assert [s.in_channels for s in port.AFE.selector] == list(
        selector_widths((16, 32, 128, 256, 512, 1024)))
    assert port.base.level5.root.residual == (arch == "dla_102")
    _, j_maps = check_forward(model, variables, port, image(2))
    check_embeddings(model, variables, port, j_maps)


def test_reference_keys_round_trip(dla_nets):
    arch, cfg, _, variables, sd, _ = dla_nets
    assert "base.level2.tree1.conv3.weight" in sd
    round_trip_dla(cfg, variables, sd, arch.split("_")[1],
                   exact_checkpoint=True)
