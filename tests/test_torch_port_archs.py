"""The port's PoseResNet and PoseResDCN (``res_<d>``, ``resdcn_<d>``)
against the JAX package's ``GenericNet`` on the CPU, and their reference
checkpoint layout.

Weights: the JAX ``init_model`` of each arch, every leaf perturbed and the
DCN offsets fractional (``torch_port_archs_setup``), through
``from_jax_variables``.  Forward: every head and the 5 backbone scales plus
the 3 neck taps within 1e-4 of the largest value; ``detect`` (the clamped
sigmoid and ``generic_decode``): scores within 1e-5, boxes within 1e-4 px.
The port's ``state_dict`` keys are the reference's (``conv1``, ``layer*``,
``deconv_layers.*``, ``hm.0`` ...): the JAX package's
``convert_torch_checkpoint`` maps them back to every JAX leaf bit for bit,
and a reference ``.pth`` of them loads through ``load_model`` with every
key used.

Also here: ``generic`` with ``--dla_node conv`` and the backbones'
``pre_img`` / ``pre_hm`` stems.  The JAX package builds the generic DLAUp
with ``"dcn"`` nodes whatever ``cfg.dla_node`` says (ROADMAP.md, C.3); the
port takes ``cfg.dla_node``, as the reference does, so its conv-node neck
is held against the JAX modules assembled with conv nodes
(``GenericDLAUpNet``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import _leaves
from torch_port_archs_setup import (SIZE, GenericDLAUpNet, check_forward,
                                    image, nets, perturb)

from deft_tpu.config import mot_config
from deft_tpu.models.backbones import MobileNetV2 as JaxMobileNetV2
from deft_tpu.models.backbones import ResNet as JaxResNet
from deft_tpu.train.torch_convert import convert_torch_checkpoint
from deft_tpu_torch.checkpoint import load_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import _Inverse, from_jax_variables
from deft_tpu_torch.models.backbones import MobileNetV2, ResNet
from deft_tpu_torch.models.factory import create_model

ARCHS = ["res_18", "res_50", "resdcn_18"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes on one
    machine (as ``test_torch_port_bf16.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def arch_nets(request):
    return (request.param,) + nets(request.param)


def test_forward_matches_jax(arch_nets):
    arch, cfg, model, variables, _, port = arch_nets
    j_out, j_maps = check_forward(model, variables, port, image(2))
    assert len(j_maps) == 8
    assert j_maps[4].shape[-1] == (2048 if arch == "res_50" else 512)
    # resdcn's neck width comes from the heatmap tower's (64)
    ups = [m.out_channels for m in port.deconv_layers
           if isinstance(m, torch.nn.ConvTranspose2d)]
    assert ups == ([256, 128, 64] if arch == "resdcn_18" else [256] * 3)


def test_detect_matches_jax(arch_nets):
    _, cfg, model, variables, _, port = arch_nets
    x = image(3)
    want = model.apply(variables, jnp.asarray(x), k=cfg.K, method="detect")
    with torch.no_grad():
        got = port.detect(torch.from_numpy(x), k=cfg.K)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    for key in ("inds", "clses"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("bboxes", "bboxes_amodal", "tracking"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-4, err_msg=key)


def test_reference_keys_round_trip(arch_nets):
    """``convert_torch_checkpoint`` of the port's ``state_dict`` gives back
    every JAX leaf exactly."""
    _, cfg, _, variables, sd, _ = arch_nets
    assert any(k.startswith("deconv_layers.") for k in sd)
    assert "conv1.weight" in sd and "layer1.0.conv1.weight" in sd
    back = convert_torch_checkpoint({k: v.numpy() for k, v in sd.items()},
                                    cfg)
    for kind in ("params", "batch_stats"):
        got = dict(_leaves(back[kind]))
        for path, v in _leaves(variables[kind]):
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_reference_pth_loads_whole(arch_nets, tmp_path):
    arch, _, _, _, sd, port = arch_nets
    path = tmp_path / "model.pth"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v
                                           for k, v in sd.items()}}, path)
    fresh = create_model(arch, port_mot_config(arch=arch, **SIZE), "cpu")
    report = load_model(fresh, str(path))
    assert report.kept == [] and report.dropped == []
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_leftover_jax_leaf_raises(arch_nets):
    _, cfg, _, variables, _, _ = arch_nets
    extra = {"params": {**variables["params"], "stray": {"kernel": np.ones(2)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="stray"):
        from_jax_variables(extra, cfg)


def test_imagenet_resnet_trunk_loads_trunk_only(tmp_path):
    """A torchvision ``resnet18`` file (trunk + ``fc``) loads into
    resdcn_18's trunk; its classifier is left out and the deconv neck and
    heads keep their seeded values."""
    cfg = port_mot_config(arch="resdcn_18", **SIZE)
    donor = create_model("res_18", port_mot_config(arch="res_18", seed=5,
                                                   **SIZE), "cpu")
    trunk = {k: v for k, v in donor.state_dict().items()
             if k.startswith(("conv1.", "bn1.", "layer"))}
    trunk["fc.weight"] = torch.ones(1000, 512)
    trunk["fc.bias"] = torch.zeros(1000)
    torch.save(trunk, tmp_path / "resnet18.pth")
    model = create_model("resdcn_18", cfg, "cpu")
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_model(model, str(tmp_path / "resnet18.pth"))
    assert report.dropped == []
    assert sorted(report.loaded) == sorted(k for k in trunk
                                           if not k.startswith("fc."))
    for k, v in model.state_dict().items():
        want = trunk[k] if k in trunk else seeded[k]
        assert torch.equal(v, want), k


def test_generic_dlaup_conv_nodes():
    """``generic`` with ``--dla_node conv``: the neck's nodes are 1x1
    conv-BN-ReLU, held against the JAX modules with conv nodes."""
    kw = dict(backbone="resnet", num_layers=18, neck="dlaup",
              dla_node="conv")
    cfg = mot_config(arch="generic", **SIZE, **kw)
    model = GenericDLAUpNet(dict(cfg.heads),
                            {h: tuple(c) for h, c in cfg.head_convs.items()})
    v = jax.jit(lambda r: model.init(r, jnp.zeros((1, 64, 64, 3))))(
        jax.random.PRNGKey(0))
    variables = perturb(v["params"], v["batch_stats"], seed=4)
    port = create_model("generic", port_mot_config(arch="generic", **SIZE,
                                                   **kw), "cpu")
    assert not any("conv_offset_mask" in k for k in port.state_dict())
    port.load_state_dict(from_jax_variables(variables, cfg))
    check_forward(model, variables, port, image(5))


@pytest.mark.parametrize("name", ["resnet18", "mobilenet"])
def test_pre_img_and_pre_hm_stems(name):
    """The stems add the previous frame's and heatmap's 7x7 (MobileNetV2:
    3x3) conv-BN-ReLU to the stem's output, where asked for and given."""
    if name == "resnet18":
        jnet, port = JaxResNet(18, True, True), ResNet(18, True, True)
    else:
        jnet, port = JaxMobileNetV2(True, True), MobileNetV2(True, True)
    rng = np.random.RandomState(6)
    x, pre = rng.randn(2, 1, 64, 64, 3).astype(np.float32)
    hm = rng.rand(1, 64, 64, 1).astype(np.float32)
    v = jax.jit(lambda r: jnet.init(r, x, pre, hm))(jax.random.PRNGKey(1))
    variables = perturb(v["params"], v["batch_stats"], seed=7)
    inv = _Inverse(variables["params"], variables["batch_stats"])
    if name == "resnet18":
        inv.resnet((), "", 18)
    else:
        inv.mobilenet((), "")
    assert any(k.startswith("pre_hm_layer.") for k in inv.sd)
    port.load_state_dict(inv.sd)
    port.eval()
    want = jnet.apply(variables, x, pre, hm)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                     for a in (x, pre, hm)))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=str(i))
