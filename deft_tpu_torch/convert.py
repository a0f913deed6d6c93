"""JAX variables -> the port's ``state_dict``.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
trees (numpy arrays) of any arch of ``create_model`` into the port's
``state_dict``: a ``DEFTNet`` at every DLA plan (bottleneck blocks and
residual roots included) with dcn, conv or gcn nodes and its AFE at the
trunk's widths, and a ``GenericNet`` with each backbone (DLA-34, ResNet,
MobileNetV2) and neck (generic DLAUp, DLAUpV0, MSRAUp plain or DCN).  Its
keys are the reference network's where the JAX converter documents them
(DEFT's DLA, PoseResNet, PoseResDCN); it is the inverse of
``deft_tpu/train/torch_convert.py::convert_torch_checkpoint`` there:

* flax HWIO conv kernels become OIHW;
* flax Dense ``[in, out]`` kernels become 1x1 convs ``[out, in, 1, 1]``;
* BatchNorm scale/bias + mean/var become weight/bias + running stats;
* DCNv2: the tap-major ``[9*Cin, Cout]`` weight becomes ``[Cout, Cin, 3, 3]``
  and the offset conv's tap-major [9 dy, 9 dx, 9 mask] channels go back to
  the reference's interleaved (dy, dx) order;
* depthwise upsampler kernels ``[k, k, 1, C]`` become ``[C, 1, k, k]``;
* dense deconv kernels ``[k, k, Cin, Cout]`` (flax's orientation) become
  torch's ``[Cin, Cout, k, k]`` spatially flipped (``up_full``);
* the AFE's split ``final_0_kernel [2E, 512]`` becomes the reference's
  ``final_net.0`` 1x1 conv.

Every JAX leaf must be used; a leaf left over raises, so a layout the port
does not know cannot pass silently.

``from_jax_motion_variables`` does the same for the LSTM motion model: flax's
``OptimizedLSTMCell`` keeps one Dense per gate (``ii, if, ig, io`` on the
input without a bias, ``hi, hf, hg, ho`` on the hidden state with one), which
the reference's one-layer ``torch.nn.LSTM`` stacks in the same i, f, g, o
order into ``weight_ih_l0`` ``[4H, F]`` and ``weight_hh_l0`` ``[4H, H]``, its
hidden-side bias ``bias_hh_l0`` the flax biases and its input-side bias
``bias_ih_l0`` zero.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from deft_tpu_torch.config import Config
from deft_tpu_torch.models.dla import DLA34_LEVELS, DLA_PLANS, dla_depth
from deft_tpu_torch.models.factory import generic_parts, parse_arch
from deft_tpu_torch.models.backbones import RESNET_SPECS, MobileNetV2

# reference channel 2k -> dy_k, 2k+1 -> dx_k, 18+k -> mask_k; JAX channel
# order is [dy_0..8, dx_0..8, mask_0..8], so torch channel t = JAX _OM_SRC[t]
_OM_SRC = [k // 2 + 9 * (k % 2) for k in range(18)] + list(range(18, 27))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


class _Inverse:
    def __init__(self, params: dict, stats: dict):
        self.trees = {"params": params, "batch_stats": stats}
        self.used = set()
        self.sd: Dict[str, torch.Tensor] = OrderedDict()

    def get(self, path: Tuple[str, ...], kind: str = "params") -> np.ndarray:
        node = self.trees[kind]
        for p in path:
            node = node[p]
        self.used.add((kind,) + path)
        return np.asarray(node)

    def has(self, path: Tuple[str, ...]) -> bool:
        node = self.trees["params"]
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def put(self, key: str, value: np.ndarray):
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    # -- primitive writers ---------------------------------------------------

    def conv(self, src, dst: str):
        self.put(f"{dst}.weight",
                 np.transpose(self.get(src + ("kernel",)), (3, 2, 0, 1)))
        if self.has(src + ("bias",)):
            self.put(f"{dst}.bias", self.get(src + ("bias",)))

    def bn(self, src, dst: str):
        self.put(f"{dst}.weight", self.get(src + ("scale",)))
        self.put(f"{dst}.bias", self.get(src + ("bias",)))
        self.put(f"{dst}.running_mean", self.get(src + ("mean",), "batch_stats"))
        self.put(f"{dst}.running_var", self.get(src + ("var",), "batch_stats"))
        self.sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def conv_bn(self, src, conv_dst: str, bn_dst: str):
        self.conv(src + ("conv",), conv_dst)
        self.bn(src + ("bn",), bn_dst)

    def dense_as_conv(self, kernel: np.ndarray, bias: np.ndarray, dst: str):
        self.put(f"{dst}.weight", kernel.T[:, :, None, None])
        self.put(f"{dst}.bias", bias)

    def dcn(self, src, dst: str):
        wk = self.get(src + ("weight",))                     # [9*Cin, Cout]
        cout = wk.shape[1]
        cin = wk.shape[0] // 9
        self.put(f"{dst}.weight",
                 np.transpose(wk.reshape(3, 3, cin, cout), (3, 2, 0, 1)))
        self.put(f"{dst}.bias", self.get(src + ("bias",)))
        om_w = self.get(src + ("conv_offset_mask", "kernel"))  # [3,3,Cin,27]
        om_b = self.get(src + ("conv_offset_mask", "bias"))
        self.put(f"{dst}.conv_offset_mask.weight",
                 np.transpose(om_w, (3, 2, 0, 1))[_OM_SRC])
        self.put(f"{dst}.conv_offset_mask.bias", om_b[_OM_SRC])

    def up(self, src, dst: str):
        self.put(f"{dst}.weight",
                 np.transpose(self.get(src + ("kernel",)), (3, 2, 0, 1)))

    # -- composite translators ----------------------------------------------

    def up_full(self, src, dst: str):
        k = self.get(src + ("deconv", "kernel"))             # [k, k, Cin, Cout]
        self.put(f"{dst}.weight",
                 np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))

    # -- composite translators ----------------------------------------------

    def basic_block(self, src, dst: str):
        """DLA's basic or bottleneck block (conv3 where the JAX block has
        one)."""
        for i in (1, 2, 3):
            if i < 3 or self.has(src + ("conv3",)):
                self.conv_bn(src + (f"conv{i}",), f"{dst}.conv{i}",
                             f"{dst}.bn{i}")

    def tree(self, src, dst: str, levels: int):
        if levels == 1:
            self.basic_block(src + ("tree1",), f"{dst}.tree1")
            self.basic_block(src + ("tree2",), f"{dst}.tree2")
            self.conv_bn(src + ("root", "conv"), f"{dst}.root.conv",
                         f"{dst}.root.bn")
        else:
            self.tree(src + ("tree1",), f"{dst}.tree1", levels - 1)
            self.tree(src + ("tree2",), f"{dst}.tree2", levels - 1)
        if self.has(src + ("project",)):
            self.conv_bn(src + ("project",), f"{dst}.project.0",
                         f"{dst}.project.1")

    def stems(self, src, dst: str):
        """The ``pre_img`` / ``pre_hm`` stems where the JAX tree has them."""
        for stem in ("pre_img_layer", "pre_hm_layer"):
            if self.has(src + (stem,)):
                self.conv_bn(src + (stem,), f"{dst}{stem}.0", f"{dst}{stem}.1")

    def dla(self, src, dst: str, levels):
        """The DLA backbone at ``levels``."""
        self.conv_bn(src + ("base_layer",), f"{dst}base_layer.0",
                     f"{dst}base_layer.1")
        for li in (0, 1):
            for i in range(levels[li]):
                self.conv_bn(src + (f"level{li}_conv{i}",),
                             f"{dst}level{li}.{3 * i}",
                             f"{dst}level{li}.{3 * i + 1}")
        for li in (2, 3, 4, 5):
            self.tree(src + (f"level{li}",), f"{dst}level{li}", levels[li])

    def node(self, src, dst: str, node_type: str):
        if node_type == "dcn":
            self.dcn(src + ("conv",), f"{dst}.conv")
            self.bn(src + ("actf_bn",), f"{dst}.actf.0")
        elif node_type == "gcn" and not src[-1].startswith("proj"):
            for jax_name, key in (("gcl_0", "gcl.0"), ("gcl_1", "gcl.1"),
                                  ("gcr_0", "gcr.0"), ("gcr_1", "gcr.1")):
                self.conv(src + (jax_name,), f"{dst}.{key}")
            self.bn(src + ("act_bn",), f"{dst}.act.0")
        else:
            self.conv_bn(src + ("conv",), f"{dst}.conv.0", f"{dst}.conv.1")

    def ida(self, src, dst: str, n: int, node_type: str):
        for j in range(1, n):
            self.node(src + (f"proj_{j}",), f"{dst}.proj_{j}", node_type)
            self.node(src + (f"node_{j}",), f"{dst}.node_{j}", node_type)
            if self.has(src + (f"up_{j}",)):
                self.up(src + (f"up_{j}",), f"{dst}.up_{j}")

    def dla_up(self, src, dst: str, node_type: str, levels: int = 4):
        """DLAUp's ``levels - 1`` IDAUps (2, 3, ... levels inputs)."""
        for i in range(levels - 1):
            self.ida(src + (f"ida_{i}",), f"{dst}.ida_{i}", i + 2, node_type)

    def resnet(self, src, dst: str, depth: int):
        kind, blocks = RESNET_SPECS[depth]
        self.conv_bn(src + ("conv1",), f"{dst}conv1", f"{dst}bn1")
        self.stems(src, dst)
        for s, n in enumerate(blocks):
            for b in range(n):
                bs = src + (f"layer{s + 1}_{b}",)
                bd = f"{dst}layer{s + 1}.{b}"
                for i in (1, 2, 3) if kind == "bottleneck" else (1, 2):
                    self.conv_bn(bs + (f"conv{i}",), f"{bd}.conv{i}",
                                 f"{bd}.bn{i}")
                if self.has(bs + ("downsample",)):
                    self.conv_bn(bs + ("downsample",), f"{bd}.downsample.0",
                                 f"{bd}.downsample.1")

    def mobilenet(self, src, dst: str):
        self.conv_bn(src + ("stem",), f"{dst}stem.0", f"{dst}stem.1")
        self.stems(src, dst)
        blocks = sum(r for _, _, r, _ in MobileNetV2.CFG)
        for i in range(blocks):
            bs, bd = src + (f"block{i}",), f"{dst}block{i}"
            if self.has(bs + ("expand",)):
                self.conv_bn(bs + ("expand",), f"{bd}.expand.0",
                             f"{bd}.expand.1")
            self.conv(bs + ("dw",), f"{bd}.dw")
            self.bn(bs + ("dw_bn",), f"{bd}.dw_bn")
            self.conv_bn(bs + ("project",), f"{bd}.project.0",
                         f"{bd}.project.1")

    def dla_up_v0(self, src, dst: str, levels: int = 4):
        for i in range(levels - 1):
            s_i, d_i = src + (f"ida_{i}",), f"{dst}ida_{i}"
            for k in range(i + 2):
                if self.has(s_i + (f"proj_{k}",)):
                    self.conv_bn(s_i + (f"proj_{k}",), f"{d_i}.proj_{k}.0",
                                 f"{d_i}.proj_{k}.1")
                if self.has(s_i + (f"up_{k}",)):
                    self.up(s_i + (f"up_{k}",), f"{d_i}.up_{k}")
                if k > 0:
                    self.conv_bn(s_i + (f"node_{k}",), f"{d_i}.node_{k}.0",
                                 f"{d_i}.node_{k}.1")

    def msra_up(self, src, dst: str, plain: bool):
        """MSRAUp -> ``deconv_layers``: per stage [DCN, BN, ReLU, deconv,
        BN, ReLU], or [deconv, BN, ReLU] where ``plain``."""
        stride = 3 if plain else 6
        for i in range(3):
            at = i * stride
            if not plain:
                self.dcn(src + (f"dcn_{i}",), f"{dst}deconv_layers.{at}")
                self.bn(src + (f"bn_a_{i}",), f"{dst}deconv_layers.{at + 1}")
                at += 3
            self.up_full(src + (f"up_{i}",), f"{dst}deconv_layers.{at}")
            self.bn(src + (f"bn_b_{i}",), f"{dst}deconv_layers.{at + 1}")

    def heads(self, heads: Sequence[str], head_convs: Dict[str, Sequence[int]]):
        for h in heads:
            n = len(head_convs.get(h, ()))
            for i in range(n):
                self.conv((f"head_{h}", f"conv{i}"), f"{h}.{2 * i}")
            self.conv((f"head_{h}", "out"), f"{h}.{2 * n}")

    def afe(self):
        src = ("afe",)
        i = 0
        while self.has(src + (f"selector_{i}",)):
            self.conv(src + (f"selector_{i}",), f"AFE.selector.{i}")
            i += 1
        self.bn(src + ("stacker2_bn",), "AFE.stacker2_bn")
        self.dense_as_conv(self.get(src + ("final_0_kernel",)),
                           self.get(src + ("final_0_bias",)),
                           "AFE.final_net.0")
        self.bn(src + ("final_0_bn",), "AFE.final_net.1")
        for name, idx, bn_idx in (("final_1", 3, 4), ("final_2", 6, 7),
                                  ("final_3", 9, None), ("final_4", 11, None)):
            self.dense_as_conv(self.get(src + (name, "kernel")),
                               self.get(src + (name, "bias")),
                               f"AFE.final_net.{idx}")
            if bn_idx is not None:
                self.bn(src + (f"{name}_bn",), f"AFE.final_net.{bn_idx}")


def _deft(inv: _Inverse, cfg: Config):
    levels = DLA_PLANS[dla_depth(cfg.arch)][0]
    inv.dla(("trunk", "base"), "base.", levels)
    inv.dla_up(("trunk", "dla_up"), "dla_up", cfg.dla_node)
    inv.ida(("trunk", "ida_up"), "ida_up", 3, cfg.dla_node)
    inv.heads(list(cfg.heads), cfg.head_convs)
    inv.afe()


def _generic(inv: _Inverse, cfg: Config):
    backbone, neck, num_layers, _, flat = generic_parts(cfg.arch, cfg)
    bb = "" if flat else "backbone."
    nk = "" if flat else "neck."
    if backbone == "dla34":
        inv.dla(("backbone",), bb, DLA34_LEVELS)
    elif backbone == "resnet":
        inv.resnet(("backbone",), bb, num_layers)
    else:
        inv.mobilenet(("backbone",), bb)
    if neck == "dlaup":
        inv.dla_up(("neck", "dla_up"), f"{nk}dla_up", cfg.dla_node)
        inv.ida(("neck", "ida_up"), f"{nk}ida_up", 3, cfg.dla_node)
    elif neck == "dlaupv0":
        inv.dla_up_v0(("neck",), nk)
    else:
        inv.msra_up(("neck",), nk, plain=neck == "msraup_plain")
    inv.heads(list(cfg.heads), cfg.head_convs)


def from_jax_variables(variables: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` (numpy leaves) of the network of
    ``cfg.arch`` -> the port's ``state_dict`` (CPU float32 tensors).  A
    generic DLAUp neck's nodes are ``cfg.dla_node``'s, as the port builds
    them."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    inv = _Inverse(params, stats)
    name, _ = parse_arch(cfg.arch)
    if name == "dla":
        _deft(inv, cfg)
    else:
        _generic(inv, cfg)

    every = ({("params",) + p for p in _leaves(params)}
             | {("batch_stats",) + p for p in _leaves(stats)})
    left = sorted(every - inv.used)
    if left:
        raise ValueError(f"JAX leaves with no place in the port: {left[:10]}"
                         f"{' ...' if len(left) > 10 else ''}")
    return inv.sd


def from_jax_motion_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX ``DecoderRNN`` variables (``{"params": ...}``, numpy leaves) ->
    the port's ``DecoderRNN`` ``state_dict``."""
    params = variables["params"]
    cell = params["cell"]
    gates = ("i", "f", "g", "o")
    used = {("cell", f"i{g}", "kernel") for g in gates}
    used |= {("cell", f"h{g}", k) for g in gates for k in ("kernel", "bias")}
    used |= {(d, k) for d in ("out1", "out2") for k in ("kernel", "bias")}
    left = sorted(set(_leaves(params)) - used)
    if left:
        raise ValueError(f"JAX motion leaves with no place in the port: {left}")

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    bias_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
    return OrderedDict([
        ("lstm.weight_ih_l0", t(np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates]))),
        ("lstm.weight_hh_l0", t(np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates]))),
        ("lstm.bias_ih_l0", t(np.zeros_like(bias_hh))),
        ("lstm.bias_hh_l0", t(bias_hh)),
        ("out1.weight", t(np.asarray(params["out1"]["kernel"]).T)),
        ("out1.bias", t(params["out1"]["bias"])),
        ("out2.weight", t(np.asarray(params["out2"]["kernel"]).T)),
        ("out2.bias", t(params["out2"]["bias"])),
    ])
