"""``compute_dtype="bfloat16"`` in the PyTorch port vs the JAX package, on
the CPU.

Weights: the port's seeded DLA-34 DEFTNet, through the JAX package's
``TorchConverter`` into JAX variables (offset convs randomized so the DCN
samples are fractional and reach past the clamp), and back into the port
with ``from_jax_variables``.  Each module gets the same bfloat16 input in
both packages, made from a seed with numpy.

Metric: the relative RMS error ``rms(got - ref) / rms(ref)`` against the
JAX bfloat16 output.  Tolerance: 2% of the *gap*, the same metric between
the JAX package's bfloat16 and float32 outputs on the same input
(``GAP_SHARE``; measured: at most 0.3% of it, AFE ``extract``).  A port
that computed in float32, or rounded in other places than JAX, would sit
at about the gap; a port that rounds where JAX
rounds differs only where float32 sums in another order land on the other
side of a bfloat16 rounding boundary.  Each test also asserts that the
output is bfloat16 where JAX's is.

Modules: ConvBNReLU (the base layer), a DLA level (``level2``), the
DeformNode under each ``dcn_impl`` the CPU runs (the JAX Pallas ones in
interpret mode), a head tower, AFE ``extract``, and the whole forward.

The whole forward needs one more rule.  bfloat16 rounding is chaotic
through a deep random network: JAX against itself, with one input value
moved by 0.02, already differs by about the bf16-fp32 gap at level 5 and in
the neck (``test_whole_forward``'s docstring).  So the forward holds the
first three feature maps (levels 0-2, before that noise grows) to a
quarter of the gap (``FORWARD_GAP_SHARE``), and every feature map and head
to 1.5 times JAX's own noise floor measured that way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.pallas_dcn as pallas_dcn
from deft_tpu.config import mot_config
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.deft import HeadTower as JaxHeadTower
from deft_tpu.models.dla import DLA_PLANS
from deft_tpu.models.dla import DeformNode as JaxDeformNode
from deft_tpu.models.dla import Tree as JaxTree
from deft_tpu.models.layers import ConvBNReLU as JaxConvBNReLU
from deft_tpu.train.torch_convert import TorchConverter
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.models.dcn import DCN_IMPLS
from deft_tpu_torch.models.dla import DeformNode
from deft_tpu_torch.models.factory import create_model
from deft_tpu_torch.ops.cuda_dcn import deform_conv_cm

SIZE = dict(input_h=64, input_w=64, max_object=8, K=16, dcn_offset_range=1)
GAP_SHARE = 0.02          # port-vs-JAX bf16 error / JAX bf16-vs-fp32 gap
FORWARD_GAP_SHARE = 0.25  # the same, feature maps 0-2 of the whole forward
NOISE_SHARE = 1.5         # whole forward: error / JAX's own bf16 noise
BF16 = jnp.bfloat16


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's port models: the suite runs
    several test processes on one machine, and each one's default of a
    thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rms_rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-12))


def to_np(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (NHWC for torch NCHW maps is
    the caller's business)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def check(got, ref_bf16, ref_f32, what):
    """``got`` within GAP_SHARE of the bf16-fp32 gap of the JAX module."""
    err = rms_rel(got, ref_bf16)
    gap = rms_rel(ref_bf16, ref_f32)
    assert gap > 1e-3, (what, gap)       # the module does round in bf16
    assert err <= GAP_SHARE * gap, (what, err, gap)
    return err, gap


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, port state_dict) of one network (module docstring)."""
    pcfg = port_mot_config(**SIZE)
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in create_model(
        pcfg.arch, pcfg, "cpu").state_dict().items()}
    cfg = mot_config(**SIZE)
    params, stats = TorchConverter(cfg.dataset).convert_dla34(
        init, cfg.heads, cfg.dla_node, DLA_PLANS["34"][0])
    rng = np.random.RandomState(11)

    def randomize(tree):
        for key, v in tree.items():
            if key == "conv_offset_mask":
                v["kernel"] = rng.normal(0, 0.01, v["kernel"].shape).astype(
                    np.float32)
                v["bias"] = rng.uniform(-1.0, 1.0, v["bias"].shape).astype(
                    np.float32)
            elif isinstance(v, dict):
                randomize(v)

    randomize(params)
    variables = {"params": params, "batch_stats": stats}
    return variables, from_jax_variables(variables, cfg)


def sub(variables, *path):
    """The variables of one submodule of the JAX DEFTNet."""
    out = {}
    for kind in ("params", "batch_stats"):
        node = variables[kind]
        for p in path:
            node = node.get(p, {})
        if node:
            out[kind] = node
    return out


def port_part(sd, prefix, module):
    """``module`` loaded strictly with the keys of ``sd`` under ``prefix``."""
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)})
    return module.eval()


def nhwc(seed, shape, relu=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x = np.maximum(x, 0.0) if relu else x
    return np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))


def run_port(module, x_nhwc, *args):
    with torch.no_grad():
        out = module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
                     .contiguous().bfloat16(), *args)
    return out


def test_conv_bn_relu(weights):
    variables, sd = weights
    model = create_model("dla_34", port_mot_config(
        compute_dtype="bfloat16", **SIZE), "cpu")
    model.load_state_dict(sd)
    x = nhwc(1, (1, 64, 64, 3))
    v = sub(variables, "trunk", "base", "base_layer")
    ref = {dt: JaxConvBNReLU(16, 7, dtype=dt).apply(v, jnp.asarray(x).astype(
        dt or jnp.float32)) for dt in (BF16, None)}
    got = run_port(model.base.base_layer, x)
    assert got.dtype == torch.bfloat16 and ref[BF16].dtype == BF16
    check(to_np(got).transpose(0, 2, 3, 1), to_np(ref[BF16]), to_np(ref[None]),
          "base_layer")


def test_dla_level(weights):
    variables, sd = weights
    model = create_model("dla_34", port_mot_config(
        compute_dtype="bfloat16", **SIZE), "cpu")
    model.load_state_dict(sd)
    x = nhwc(2, (1, 32, 32, 32), relu=True)
    v = sub(variables, "trunk", "base", "level2")
    ref = {dt: JaxTree(1, 64, 32, 2, dtype=dt).apply(
        v, jnp.asarray(x).astype(dt or jnp.float32)) for dt in (BF16, None)}
    got = run_port(model.base.level2, x)
    assert got.dtype == torch.bfloat16 and ref[BF16].dtype == BF16
    check(to_np(got).transpose(0, 2, 3, 1), to_np(ref[BF16]), to_np(ref[None]),
          "level2")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX DCNv2 imports its Pallas functions at call time; run them in
    interpret mode, as the JAX package's own tests do on the CPU."""
    for name in ("deform_conv_pallas_tap", "deform_conv_pallas_cm"):
        monkeypatch.setattr(pallas_dcn, name, functools.partial(
            getattr(pallas_dcn, name), interpret=True))


@pytest.mark.parametrize("impl", DCN_IMPLS)
def test_deform_node(weights, impl, interpret_pallas):
    """``ida_up.node_1`` (64 -> 64 channels at 16x16, radius 1) under each
    ``dcn_impl``: the offset conv in bf16, the sampling and the product
    rounded where the JAX function rounds (``models/dcn.py``)."""
    variables, sd = weights
    x = nhwc(3, (1, 16, 16, 64), relu=True)
    v = sub(variables, "trunk", "ida_up", "node_1")
    ref = {dt: JaxDeformNode(64, dtype=dt, dcn_impl=impl,
                             dcn_offset_range=1).apply(
        v, jnp.asarray(x).astype(dt or jnp.float32)) for dt in (BF16, None)}
    node = port_part(sd, "ida_up.node_1.", DeformNode(64, 64, 1, impl))
    got = run_port(node, x)
    assert got.dtype == torch.bfloat16 and ref[BF16].dtype == BF16
    check(to_np(got).transpose(0, 2, 3, 1), to_np(ref[BF16]), to_np(ref[None]),
          impl)


@pytest.mark.parametrize("path,chans,jax_impl", [
    (("ida_up", "node_1"), 64, "pallas_cm"),
    (("dla_up", "ida_0", "node_1"), 256, "hybrid")])
def test_deform_node_hybrid_on_card(weights, path, chans, jax_impl,
                                    interpret_pallas, monkeypatch):
    """The function ``dcn_impl="hybrid"`` takes on the card, forced on CPU
    tensors: as ``deform_conv_hybrid`` on a TPU, C <= 128 runs the
    channel-major function (``ida_up.node_1``, 64 channels, against the JAX
    ``pallas_cm`` in interpret mode) and C > 128 the onehot function
    (``dla_up.ida_0.node_1``, 256 channels, against the JAX hybrid, which
    takes ``deform_conv_onehot`` there on every backend).  At 64 channels
    the CPU's route (onehot) is also held away from the card's reference,
    so the test tells the two routes apart."""
    variables, sd = weights
    x = nhwc(6, (1, 8, 8, chans), relu=True)
    v = sub(variables, "trunk", *path)
    ref = {dt: JaxDeformNode(chans, dtype=dt, dcn_impl=jax_impl,
                             dcn_offset_range=1).apply(
        v, jnp.asarray(x).astype(dt or jnp.float32)) for dt in (BF16, None)}
    node = port_part(sd, ".".join(path) + ".",
                     DeformNode(chans, chans, 1, "hybrid"))
    off_card = run_port(node, x)
    card = node.conv._function
    monkeypatch.setattr(node.conv, "_function",
                        lambda dtype, c, b, on_card: card(dtype, c, b, True))
    got = run_port(node, x)
    assert got.dtype == torch.bfloat16 and ref[BF16].dtype == BF16
    err, gap = check(to_np(got).transpose(0, 2, 3, 1), to_np(ref[BF16]),
                     to_np(ref[None]), f"hybrid on the card, C={chans}")
    if chans <= 128:
        assert card(torch.bfloat16, chans, 1, True) is deform_conv_cm
        assert rms_rel(to_np(off_card).transpose(0, 2, 3, 1),
                       to_np(ref[BF16])) > GAP_SHARE * gap
    else:
        assert torch.equal(got, off_card)


def test_head(weights):
    """The ``wh`` tower: bf16 convs, its output cast to float32."""
    variables, sd = weights
    model = create_model("dla_34", port_mot_config(
        compute_dtype="bfloat16", **SIZE), "cpu")
    model.load_state_dict(sd)
    x = nhwc(4, (1, 16, 16, 64), relu=True)
    v = sub(variables, "head_wh")
    ref = {dt: JaxHeadTower(2, (256,), dtype=dt).apply(
        v, jnp.asarray(x).astype(dt or jnp.float32)) for dt in (BF16, None)}
    got = run_port(model.wh, x).float()
    check(to_np(got).transpose(0, 2, 3, 1), to_np(ref[BF16]), to_np(ref[None]),
          "head wh")


def test_afe_extract(weights):
    """The 13 selectors in bf16, sampled in float32 at 8 centres, the
    embeddings float32 (``deft_tpu/models/afe.py:74, :113``)."""
    variables, sd = weights
    chans = (16, 32, 64, 128, 256, 512, 64, 128, 256, 512, 64, 64, 64)
    sizes = (64, 32, 16, 8, 4, 2, 16, 8, 4, 2, 16, 16, 16)
    maps = [nhwc(20 + i, (1, s, s, c), relu=True)
            for i, (c, s) in enumerate(zip(chans, sizes))]
    centers = np.random.RandomState(5).uniform(-1, 1, (1, 8, 2)).astype(
        np.float32)
    ref = {}
    for dt in (BF16, None):
        cfg = mot_config(compute_dtype="bfloat16" if dt else "float32", **SIZE)
        inputs = [jnp.asarray(m).astype(dt or jnp.float32) for m in maps]
        ref[dt] = jax_create_model(cfg.arch, cfg).apply(
            variables, inputs, jnp.asarray(centers), method="extract")
    model = create_model("dla_34", port_mot_config(
        compute_dtype="bfloat16", **SIZE), "cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.extract([torch.from_numpy(m).permute(0, 3, 1, 2)
                             .contiguous().bfloat16() for m in maps],
                            torch.from_numpy(centers))
    assert got.dtype == torch.float32 and ref[BF16].dtype == jnp.float32
    check(got.numpy(), to_np(ref[BF16]), to_np(ref[None]), "extract")


def test_whole_forward(weights):
    """DEFTNet's forward at 64x64 (hybrid DCN: ``deform_conv_onehot`` in
    JAX, the onehot function on a CPU tensor in the port).  Feature maps 0-2
    within FORWARD_GAP_SHARE of the gap (measured: 0.02-0.15 of it); every
    feature map and head within NOISE_SHARE of the JAX package's own bf16
    noise: its forward against its forward on the image with one value moved by
    0.02 (measured: the port sits at 0.2-1.05 of that noise, levels 3-5 and
    the neck near 1, where the noise itself is ~0.8-1.0 of the gap).  The
    port in float32 sits at the gap at levels 0-2, twice the first rule's
    bound or more."""
    variables, sd = weights
    image = np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32)
    nudged = image.copy()
    nudged[0, 10, 10, 0] += 0.02
    jax_out = {}
    for dt in ("bfloat16", "float32"):
        cfg = mot_config(compute_dtype=dt, **SIZE)
        model = jax_create_model(cfg.arch, cfg)
        jax_out[dt] = model.apply(variables, jnp.asarray(image))
        if dt == "bfloat16":
            jax_out["nudged"] = model.apply(variables, jnp.asarray(nudged))
    port = {}
    for dt in ("bfloat16", "float32"):
        model = create_model("dla_34", port_mot_config(compute_dtype=dt,
                                                       **SIZE), "cpu")
        model.load_state_dict(sd)
        with torch.no_grad():
            port[dt] = model(torch.from_numpy(image))

    heads_b, maps_b = jax_out["bfloat16"]
    heads_n, maps_n = jax_out["nudged"]
    heads_f, maps_f = jax_out["float32"]
    got_heads, got_maps = port["bfloat16"]
    for i in range(13):
        got = to_np(got_maps[i]).transpose(0, 2, 3, 1)
        assert got_maps[i].dtype == torch.bfloat16
        ref = to_np(maps_b[i])
        err = rms_rel(got, ref)
        noise = rms_rel(to_np(maps_n[i]), ref)
        assert err <= NOISE_SHARE * noise, (i, err, noise)
        if i <= 2:
            gap = rms_rel(ref, to_np(maps_f[i]))
            assert err <= FORWARD_GAP_SHARE * gap, (i, err, gap)
            f32 = to_np(port["float32"][1][i]).transpose(0, 2, 3, 1)
            assert rms_rel(f32, ref) > 2 * FORWARD_GAP_SHARE * gap, i
    for h, ref in heads_b.items():
        assert got_heads[h].dtype == torch.float32
        err = rms_rel(got_heads[h].numpy(), to_np(ref))
        noise = rms_rel(to_np(heads_n[h]), to_np(ref))
        assert err <= NOISE_SHARE * max(noise, 1e-3), (h, err, noise)
