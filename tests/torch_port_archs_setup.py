"""Shared setup of the ``test_torch_port_archs*.py`` files: JAX variables of
any arch (every leaf perturbed, DCN offsets fractional), the port's network
with them, and the comparison of the two forwards.

Sizes: 64x64 inputs (64x96 for the tracking paths), ``max_object`` 8, K 16,
``dcn_offset_range`` 1, no ``pre_img`` stems (``no_pre_img``: the JAX
``init_model`` creates none).  Tolerance of a float32 forward: 1e-4
relative to the largest value of the map (convolutions and reductions sum
in another order in the two frameworks), as ``test_torch_port_model.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_model import _close, jax_variables

from deft_tpu.config import mot_config
from deft_tpu.models.backbones import ResNet as JaxResNet
from deft_tpu.models.deft import HeadTower as JaxHeadTower
from deft_tpu.models.necks import GenericDLAUp as JaxGenericDLAUp
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.models.factory import create_model

SIZE = dict(input_h=64, input_w=64, max_object=8, K=16, dcn_offset_range=1,
            no_pre_img=True)


def image(seed: int, h: int = 64, w: int = 64) -> np.ndarray:
    return np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32)


class GenericDLAUpNet(fnn.Module):
    """The JAX ``GenericNet`` of a ResNet backbone and a generic DLAUp neck
    with its nodes of ``node_type``: the JAX package builds that neck with
    ``"dcn"`` nodes whatever ``cfg.dla_node`` says, the port with
    ``cfg.dla_node``'s (the reference's ``opt.dla_node``), so a conv-node
    neck is held against this assembly of the JAX modules under the JAX
    net's names."""

    heads: Dict[str, int]
    head_convs: Dict[str, Tuple[int, ...]]
    num_layers: int = 18
    node_type: str = "conv"

    def setup(self):
        self.bb = JaxResNet(self.num_layers, name="backbone")
        self.nk = JaxGenericDLAUp(tuple(JaxResNet(self.num_layers).channels),
                                  node_type=self.node_type, name="neck")
        self.head_towers = {
            h: JaxHeadTower(c, tuple(self.head_convs.get(h, ())),
                            prior_bias=-4.6 if "hm" in h else None,
                            name=f"head_{h}")
            for h, c in self.heads.items()}

    def __call__(self, x, train: bool = False):
        feats = self.bb(x, None, None, train)
        y, taps = self.nk(feats, train)
        return ({h: t(y) for h, t in self.head_towers.items()},
                list(feats) + list(taps))


def nets(arch: str, seed: int = 1, size=SIZE, **kw):
    """(JAX cfg, JAX model, perturbed variables, port state_dict, port
    network) of ``arch``."""
    cfg = mot_config(arch=arch, **size, **kw)
    model, variables = jax_variables(cfg, seed)
    sd = from_jax_variables(variables, cfg)
    port = create_model(arch, port_mot_config(arch=arch, **size, **kw), "cpu")
    port.load_state_dict(sd)
    return cfg, model, variables, sd, port


def check_forward(model, variables, port, x: np.ndarray):
    """Every head and every feature map (backbone scales, neck taps) of the
    two forwards within the module docstring's tolerance."""
    j_out, j_maps = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_out, t_maps = port(torch.from_numpy(x))
    assert len(t_maps) == len(j_maps)
    for i, (t, j) in enumerate(zip(t_maps, j_maps)):
        _close(t.permute(0, 2, 3, 1).numpy(), j, f"feature map {i}")
    assert set(t_out) == set(j_out)
    for h in j_out:
        _close(t_out[h].numpy(), j_out[h], f"head {h}")
    return j_out, j_maps


def perturb(params, stats, seed: int) -> dict:
    """JAX trees with every leaf perturbed and DCN offsets fractional, as
    ``test_torch_port_model.jax_variables`` does for a model it builds."""
    import jax

    from test_torch_port_model import _leaves, _set

    rng = np.random.RandomState(seed)
    out = {"params": {}, "batch_stats": {}}
    for kind, tree in (("params", params), ("batch_stats", stats)):
        for path, v in _leaves(jax.tree.map(np.asarray, tree)):
            name = path[-1]
            if "conv_offset_mask" in path:
                v = (rng.normal(0, 0.01, v.shape) if name == "kernel"
                     else rng.uniform(-1.0, 1.0, v.shape))
            elif name in ("scale", "var"):
                v = rng.uniform(0.8, 1.2, v.shape)
            elif name in ("bias", "mean"):
                v = v + rng.normal(0, 0.05, v.shape)
            else:
                v = v * rng.uniform(0.9, 1.1, v.shape)
            _set(out[kind], path, np.asarray(v, np.float32))
    return out


def check_embeddings(model, variables, port, j_maps, seed: int = 9):
    """The AFE's embeddings of both networks at the same random centres,
    from their own feature maps, within 1e-4 of the largest value."""
    centers = np.random.RandomState(seed).uniform(
        -1, 1, (1, 8, 2)).astype(np.float32)
    want = model.apply(variables, j_maps, jnp.asarray(centers),
                       method="extract")
    with torch.no_grad():
        t_maps = [torch.from_numpy(np.asarray(m)).permute(0, 3, 1, 2)
                  for m in j_maps]
        got = port.extract(t_maps, torch.from_numpy(centers))
    _close(got.numpy(), want, "AFE embeddings")


def round_trip_dla(cfg, variables, sd, depth: str, exact_checkpoint: bool):
    """The JAX ``TorchConverter`` maps the port's ``state_dict`` back onto
    every JAX leaf bit for bit (the reference key names), and so does
    ``convert_torch_checkpoint`` where ``--arch`` reaches the plan."""
    from test_torch_port_model import _leaves

    from deft_tpu.models.dla import DLA_PLANS
    from deft_tpu.train.torch_convert import (TorchConverter,
                                              convert_torch_checkpoint)

    sd_np = {k: v.numpy() for k, v in sd.items()}
    conv = TorchConverter(cfg.dataset)
    trees = conv.convert_dla34(sd_np, cfg.heads, cfg.dla_node,
                               DLA_PLANS[depth][0])
    backs = [dict(zip(("params", "batch_stats"), trees))]
    if exact_checkpoint:
        backs.append(convert_torch_checkpoint(sd_np, cfg))
    for back in backs:
        for kind in ("params", "batch_stats"):
            got = dict(_leaves(back[kind]))
            ref = dict(_leaves(variables[kind]))
            assert set(got) == set(ref), kind
            for path, v in ref.items():
                np.testing.assert_array_equal(got[path], v, err_msg=str(path))
