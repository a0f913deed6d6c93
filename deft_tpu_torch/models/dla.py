"""DLA backbones + DLAUp/IDAUp neck (NCHW), the counterpart of
``deft_tpu/models/dla.py``.

The hierarchical-deep-aggregation backbone (``Tree``/``Root`` recursion) at
any plan of ``DLA_PLANS``: DLA-34's channels [16, 32, 64, 128, 256, 512]
and levels [1, 1, 1, 2, 2, 1] with basic blocks, the deeper DLA-60/102/169
with bottleneck blocks (expansion 2; the ``x`` plans grouped, cardinality
32) and, from DLA-102 on, residual roots.  The iterative-deep-aggregation
neck's projection and merge nodes are DCNv2 (``dla_node="dcn"``), 1x1
conv-BN-ReLU (``"conv"``) or, for ``"gcn"``, a 1x1 conv projection and a
separable 7x7 global-conv merge; the upsampling is depthwise bilinear
transposed convs.  Module names are the reference DEFT network's
(``model/networks/dla.py``), so its ``state_dict`` keys load directly.

Each DCNv2 layer carries its JAX module path (``trunk/dla_up/ida_0/node_1/
conv``) to resolve its clamp radius from ``dcn_layer_radii`` exactly as the
JAX package does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from deft_tpu_torch.models.dcn import DCNv2, resolve_radius
from deft_tpu_torch.models.layers import (Conv2d, ConvBNReLU, batch_norm,
                                          bilinear_upsampler)

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)

# depth -> (levels, channels, block, residual_root): the reference's
# dla34..dla169 constructors (dla.py:414-496), as
# ``deft_tpu/models/dla.py:35-45`` keys them.  ``--arch dla_<d>`` reaches
# the integer depths; every key is reachable through DEFTNet(dla_depth=...)
DLA_PLANS = {
    "34": (DLA34_LEVELS, DLA34_CHANNELS, "basic", False),
    "46_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneck",
             False),
    "46x_c": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneckx",
              False),
    "60x_c": ((1, 1, 1, 2, 3, 1), (16, 32, 64, 64, 128, 256), "bottleneckx",
              False),
    "60": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneck",
           False),
    "60x": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx",
            False),
    "102": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneck",
            True),
    "102x": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
             "bottleneckx", True),
    "169": ((1, 1, 2, 3, 5, 1), (16, 32, 128, 256, 512, 1024), "bottleneck",
            True),
}
NODE_TYPES = ("dcn", "conv", "gcn")


def dla_depth(arch: str) -> str:
    """The ``DLA_PLANS`` key of ``--arch dla[_<d>]``, parsed as
    ``deft_tpu/models/factory.py:35-45`` does: the number after the
    underscore (``dla`` alone is 34).  A suffix that is no integer
    (``dla_46_c``) raises ``ValueError``, as ``int()`` does there; a depth
    with no plan raises too."""
    if "_" not in arch:
        return "34"
    tail = arch[arch.find("_") + 1:]
    depth = str(int(tail))
    if depth == "0":
        return "34"
    if depth not in DLA_PLANS:
        raise ValueError(f"dla_{depth} has no plan; available: "
                         f"{sorted(DLA_PLANS)} (reference dla.py:414-496)")
    return depth


def selector_widths(channels: Sequence[int], first_level: int = 2,
                    last_level: int = 5) -> Tuple[int, ...]:
    """Input widths of the AFE's 13 selectors for a trunk of ``channels``:
    the 6 backbone levels, the DLAUp outputs and the IDAUp outputs at
    ``channels[first_level]`` (flax infers them, ``deft_tpu/models/
    afe.py:64-70``)."""
    ch = tuple(int(c) for c in channels)
    return (ch + ch[first_level:]
            + (ch[first_level],) * (last_level - first_level))


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN with residual add (reference ``dla.py:47-87``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = batch_norm(cout)
        self.conv2 = Conv2d(cout, cout, 3, stride=1, padding=1, bias=False)
        self.bn2 = batch_norm(cout)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (reference ``dla.py:88-130``
    Bottleneck, expansion 2); ``cardinality > 0`` is the grouped
    BottleneckX (``dla.py:133-181``, bottle = cout * cardinality // 32)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 cardinality: int = 0):
        super().__init__()
        bottle = cout * cardinality // 32 if cardinality else cout // 2
        self.conv1 = Conv2d(cin, bottle, 1, bias=False)
        self.bn1 = batch_norm(bottle)
        self.conv2 = Conv2d(bottle, bottle, 3, stride=stride, padding=1,
                            groups=max(cardinality, 1), bias=False)
        self.bn2 = batch_norm(bottle)
        self.conv3 = Conv2d(bottle, cout, 1, bias=False)
        self.bn3 = batch_norm(cout)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


def make_block(block: str, cin: int, cout: int, stride: int) -> nn.Module:
    if block == "basic":
        return BasicBlock(cin, cout, stride)
    if block == "bottleneck":
        return BottleneckBlock(cin, cout, stride)
    if block == "bottleneckx":
        return BottleneckBlock(cin, cout, stride, cardinality=32)
    raise ValueError(f"unknown dla block {block}")


class Root(nn.Module):
    """1x1 conv over concatenated children (reference ``dla.py:184-207``),
    plus the first child where ``residual``."""

    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False)
        self.bn = batch_norm(cout)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class Tree(nn.Module):
    """Recursive aggregation node (reference ``dla.py:210-284``)."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False, block: str = "basic"):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self.tree1 = make_block(block, cin, cout, stride)
            self.tree2 = make_block(block, cout, cout, 1)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride,
                              root_residual=root_residual, block=block)
            self.tree2 = Tree(levels - 1, cout, cout, 1,
                              root_dim=root_dim + cout,
                              root_residual=root_residual, block=block)
        self.levels = levels
        self.level_root = level_root
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = (nn.Sequential(Conv2d(cin, cout, 1, bias=False),
                                      batch_norm(cout))
                        if cin != cout else None)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample is not None else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """The 6-level DLA backbone at one plan of ``DLA_PLANS`` (reference
    ``dla.py:287-411``), returning every level's output."""

    def __init__(self, levels: Sequence[int] = DLA34_LEVELS,
                 channels: Sequence[int] = DLA34_CHANNELS,
                 block: str = "basic", residual_root: bool = False):
        super().__init__()
        ch = list(channels)
        self.channels = ch
        self.base_layer = ConvBNReLU(3, ch[0], 7)
        self.level0 = self._conv_level(ch[0], ch[0], levels[0])
        self.level1 = self._conv_level(ch[0], ch[1], levels[1], stride=2)
        for i in (2, 3, 4, 5):
            setattr(self, f"level{i}", Tree(
                levels[i], ch[i - 1], ch[i], 2, level_root=i > 2,
                root_residual=residual_root, block=block))

    @staticmethod
    def _conv_level(cin: int, cout: int, convs: int, stride: int = 1):
        # flat [conv, bn, relu] * convs, keys level<i>.<3j>/.<3j+1>
        mods = []
        for i in range(convs):
            mods.extend(ConvBNReLU(cin, cout, 3, stride if i == 0 else 1))
            cin = cout
        return nn.Sequential(*mods)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.base_layer(x)
        outs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outs.append(x)
        return outs


class DeformNode(nn.Module):
    """DCN -> BN -> ReLU ("dcn" node, reference ``dla.py:646-665``)."""

    def __init__(self, cin: int, cout: int, radius: int, impl: str = "hybrid"):
        super().__init__()
        self.actf = nn.Sequential(batch_norm(cout), nn.ReLU(inplace=True))
        self.conv = DCNv2(cin, cout, radius, impl)

    def forward(self, x):
        return self.actf(self.conv(x))


class ConvNode(nn.Module):
    """1x1 conv -> BN -> ReLU ("conv" node, reference ``dla.py:576-586``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class GlobalConvNode(nn.Module):
    """Separable large-kernel conv node (the "gcn" merge node, reference
    ``dla.py:589-643`` GlobalConv): a (k, 1) -> (1, k) branch ``gcl`` plus a
    (1, k) -> (k, 1) branch ``gcr``, then BN + ReLU (``act``)."""

    def __init__(self, cin: int, cout: int, k: int = 7):
        super().__init__()
        p = k // 2
        self.gcl = nn.Sequential(
            Conv2d(cin, cout, (k, 1), padding=(p, 0), bias=False),
            Conv2d(cout, cout, (1, k), padding=(0, p), bias=False))
        self.gcr = nn.Sequential(
            Conv2d(cin, cout, (1, k), padding=(0, p), bias=False),
            Conv2d(cout, cout, (k, 1), padding=(p, 0), bias=False))
        self.act = nn.Sequential(batch_norm(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.act(self.gcl(x) + self.gcr(x))


class NodeSpec:
    """How IDAUp builds its nodes: the node type, the DCN clamp radii
    (``dcn_radius < 0`` means no clamp) and the ``dcn_impl``.  A ``gcn``
    IDAUp pairs a 1x1 conv projection with a global-conv merge node
    (``DLA_NODE["gcn"] = (Conv, GlobalConv)``, reference dla.py:751-755)."""

    def __init__(self, node_type: str = "dcn", dcn_radius: int = 4,
                 radius_map: Sequence[Tuple[str, int]] = (),
                 dcn_impl: str = "hybrid"):
        if node_type not in NODE_TYPES:
            raise ValueError(f"unknown dla node type: {node_type!r}; one of "
                             f"{NODE_TYPES}")
        self.node_type = node_type
        self.dcn_radius = dcn_radius
        self.radius_map = tuple(radius_map)
        self.dcn_impl = dcn_impl

    def make(self, cin: int, cout: int, path: str) -> nn.Module:
        if self.node_type == "conv" or (self.node_type == "gcn"
                                        and path.rsplit("/", 1)[-1]
                                        .startswith("proj")):
            return ConvNode(cin, cout)
        if self.node_type == "gcn":
            return GlobalConvNode(cin, cout)
        radius = self.dcn_radius
        if radius >= 0:
            radius = resolve_radius(f"{path}/conv", radius, self.radius_map)
        return DeformNode(cin, cout, radius, self.dcn_impl)


class IDAUp(nn.Module):
    """Iterative deep aggregation step (reference ``dla.py:668-699``): for
    each level above ``startp``, project to ``out`` channels, upsample by its
    factor, and merge with the previous level through the node."""

    def __init__(self, out: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], spec: NodeSpec, path: str):
        super().__init__()
        for j in range(1, len(in_channels)):
            f = int(up_factors[j])
            setattr(self, f"proj_{j}",
                    spec.make(in_channels[j], out, f"{path}/proj_{j}"))
            setattr(self, f"up_{j}",
                    bilinear_upsampler(out, f) if f > 1 else nn.Identity())
            setattr(self, f"node_{j}", spec.make(out, out, f"{path}/node_{j}"))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int):
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Stack of IDAUp passes over levels [startp..5] (reference
    ``dla.py:702-735``)."""

    def __init__(self, channels: Sequence[int], spec: NodeSpec, path: str):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]], spec, f"{path}/ida_{i}"))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])
        self.n = len(channels)

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        """``layers`` is the [startp:] window of the backbone outputs."""
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n - 1):
            getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """Trunk: DLA backbone -> DLAUp -> IDAUp (reference ``dla.py:758-817``)
    at the plan ``DLA_PLANS[depth]``.

    ``forward`` returns ``(head_input, feature_maps)``; ``feature_maps`` is
    the 13-scale list the AFE samples from: 6 backbone levels + 4 DLAUp
    outputs + 3 IDAUp outputs (``selector_widths``: for DLA-34 [16, 32, 64,
    128, 256, 512, 64, 128, 256, 512, 64, 64, 64]).  ``DEFTNet`` extends
    this class, as the reference's network does, so ``base``, ``dla_up``
    and ``ida_up`` keep their reference key names.
    """

    def __init__(self, spec: NodeSpec, down_ratio: int = 4,
                 last_level: int = 5, depth: str = "34"):
        super().__init__()
        levels, channels, block, residual_root = DLA_PLANS[depth]
        self.first_level = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4}[down_ratio]
        self.last_level = last_level
        self.base = DLA(levels, channels, block, residual_root)
        channels = self.base.channels
        first = self.first_level
        self.dla_up = DLAUp(channels[first:], spec, "trunk/dla_up")
        self.ida_up = IDAUp(
            channels[first], channels[first:last_level],
            [2 ** i for i in range(last_level - first)], spec, "trunk/ida_up")

    def forward(self, x: torch.Tensor):
        base_outs = self.base(x)
        feature_maps = list(base_outs)
        dla_up_out = self.dla_up(base_outs[self.first_level:])
        feature_maps += dla_up_out
        y = list(dla_up_out[: self.last_level - self.first_level])
        self.ida_up(y, 0, len(y))
        feature_maps += y
        return y[-1], feature_maps
