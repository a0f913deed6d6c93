"""The DLA plans ``--arch`` does not reach and the gcn node, against the
JAX package on the CPU: ``DEFTNet(dla_depth="60x")`` (grouped BottleneckX
blocks, cardinality 32; conv nodes) and DLA-34 with ``--dla_node gcn`` (a
1x1 conv projection and a separable 7x7 global-conv merge per IDAUp step).

Tolerances as ``test_torch_port_archs_dla.py``; the X plan's keys map back
through the JAX package's ``TorchConverter`` (which has no gcn node).  The
arch strings parse as the JAX factory's: ``dla_46_c`` fails in ``int()``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_archs_setup import (SIZE, check_embeddings, check_forward,
                                    image, nets, perturb, round_trip_dla)

from deft_tpu.config import mot_config
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.models.deft import DEFTNet
from deft_tpu_torch.models.dla import DLA_PLANS, GlobalConvNode, NodeSpec
from deft_tpu_torch.models.factory import create_model, init_model


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes on one
    machine (as ``test_torch_port_bf16.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_dla_60x_matches_jax():
    cfg = mot_config(arch="dla_60", dla_node="conv", **SIZE)
    model = jax_create_model(cfg.arch, cfg).clone(dla_depth="60x")
    variables = perturb(*jax_init_model(model, cfg), seed=2)
    pcfg = port_mot_config(arch="dla_60", dla_node="conv", **SIZE)
    port = DEFTNet(pcfg.heads, pcfg.head_convs, NodeSpec("conv"),
                   max_object=pcfg.max_object, dla_depth="60x")
    init_model(port, pcfg.seed).eval()
    sd = from_jax_variables(variables, cfg)
    port.load_state_dict(sd)
    conv2 = port.base.level3.tree1.tree1.conv2
    assert conv2.groups == 32 and conv2.in_channels == 256
    _, j_maps = check_forward(model, variables, port, image(3))
    check_embeddings(model, variables, port, j_maps)
    round_trip_dla(cfg, variables, sd, "60x", exact_checkpoint=False)


def test_gcn_node_matches_jax():
    cfg, model, variables, sd, port = nets("dla_34", dla_node="gcn")
    assert isinstance(port.dla_up.ida_0.node_1, GlobalConvNode)
    assert not isinstance(port.dla_up.ida_0.proj_1, GlobalConvNode)
    assert "dla_up.ida_2.node_3.gcr.1.weight" in sd
    _, j_maps = check_forward(model, variables, port, image(4))
    check_embeddings(model, variables, port, j_maps)


@pytest.mark.parametrize("arch", ["dla_46_c", "dla_50", "hourglass_104"])
def test_arch_refusals_as_jax(arch):
    """The JAX factory raises ``ValueError`` for each (``int("46_c")``, no
    plan, no family); so does the port."""
    with pytest.raises(ValueError):
        jax_create_model(arch, mot_config(**SIZE))
    with pytest.raises(ValueError):
        create_model(arch, port_mot_config(**SIZE), "cpu")


def test_every_plan_builds():
    """Every ``DLA_PLANS`` entry builds through ``DEFTNet(dla_depth=...)``
    with AFE selectors at its widths, and runs a 64x64 forward."""
    cfg = port_mot_config(**SIZE)
    x = torch.from_numpy(image(1))
    for depth, (_, channels, _, _) in DLA_PLANS.items():
        net = DEFTNet(cfg.heads, cfg.head_convs, NodeSpec("conv"),
                      max_object=8, dla_depth=depth).eval()
        with torch.no_grad():
            out, maps = net(x)
        assert [m.shape[1] for m in maps] == [
            s.in_channels for s in net.AFE.selector], depth
        assert maps[0].shape[1] == channels[0]
        assert np.isfinite(out["hm"].numpy()).all()


def test_imagenet_dla_trunk_and_reference_pth(tmp_path):
    """A bare imagenet ``dla60`` file (``base_layer.*``, ``level*``,
    ``fc``) loads into DLA-60's trunk under ``base.``, the rest seeded; a
    reference ``.pth`` of the whole network loads with every key used."""
    from deft_tpu_torch.checkpoint import load_model

    cfg = port_mot_config(arch="dla_60", **SIZE)
    donor = create_model("dla_60", cfg.replace(seed=9), "cpu").state_dict()
    trunk = {k[len("base."):]: v for k, v in donor.items()
             if k.startswith("base.")}
    trunk["fc.weight"] = torch.ones(1000, 1024, 1, 1)
    torch.save(trunk, tmp_path / "dla60.pth")
    model = create_model("dla_60", cfg, "cpu")
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_model(model, str(tmp_path / "dla60.pth"))
    assert report.dropped == [] and len(report.loaded) == len(trunk) - 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, donor[k] if k.startswith("base.")
                           else seeded[k]), k

    torch.save({"epoch": 3, "state_dict": donor}, tmp_path / "model.pth")
    fresh = create_model("dla_60", cfg, "cpu")
    report = load_model(fresh, str(tmp_path / "model.pth"))
    assert report.kept == [] and report.dropped == []
