"""JAX variables -> the port's ``state_dict``.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
trees (numpy arrays) into the port's ``state_dict``, whose keys are the
reference DEFT network's.  It is the inverse of
``deft_tpu/train/torch_convert.py::convert_torch_checkpoint``:

* flax HWIO conv kernels become OIHW;
* flax Dense ``[in, out]`` kernels become 1x1 convs ``[out, in, 1, 1]``;
* BatchNorm scale/bias + mean/var become weight/bias + running stats;
* DCNv2: the tap-major ``[9*Cin, Cout]`` weight becomes ``[Cout, Cin, 3, 3]``
  and the offset conv's tap-major [9 dy, 9 dx, 9 mask] channels go back to
  the reference's interleaved (dy, dx) order;
* depthwise upsampler kernels ``[k, k, 1, C]`` become ``[C, 1, k, k]``;
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
from deft_tpu_torch.models.dla import DLA34_LEVELS

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

    def basic_block(self, src, dst: str):
        self.conv_bn(src + ("conv1",), f"{dst}.conv1", f"{dst}.bn1")
        self.conv_bn(src + ("conv2",), f"{dst}.conv2", f"{dst}.bn2")

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

    def node(self, src, dst: str, node_type: str):
        if node_type == "dcn":
            self.dcn(src + ("conv",), f"{dst}.conv")
            self.bn(src + ("actf_bn",), f"{dst}.actf.0")
        else:
            self.conv_bn(src + ("conv",), f"{dst}.conv.0", f"{dst}.conv.1")

    def ida(self, src, dst: str, n: int, node_type: str):
        for j in range(1, n):
            self.node(src + (f"proj_{j}",), f"{dst}.proj_{j}", node_type)
            self.node(src + (f"node_{j}",), f"{dst}.node_{j}", node_type)
            self.up(src + (f"up_{j}",), f"{dst}.up_{j}")

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


def from_jax_variables(variables: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` (numpy leaves) of a DLA-34 DEFTNet
    -> the port's ``state_dict`` (CPU float32 tensors)."""
    if cfg.dla_node not in ("dcn", "conv"):
        raise NotImplementedError(f"dla_node={cfg.dla_node!r} is not ported")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    inv = _Inverse(params, stats)
    levels = DLA34_LEVELS
    base = ("trunk", "base")
    inv.conv_bn(base + ("base_layer",), "base.base_layer.0",
                "base.base_layer.1")
    for li in (0, 1):
        for i in range(levels[li]):
            inv.conv_bn(base + (f"level{li}_conv{i}",),
                        f"base.level{li}.{3 * i}", f"base.level{li}.{3 * i + 1}")
    for li in (2, 3, 4, 5):
        inv.tree(base + (f"level{li}",), f"base.level{li}", levels[li])
    for i, n in enumerate((2, 3, 4)):
        inv.ida(("trunk", "dla_up", f"ida_{i}"), f"dla_up.ida_{i}", n,
                cfg.dla_node)
    inv.ida(("trunk", "ida_up"), "ida_up", 3, cfg.dla_node)
    inv.heads(list(cfg.heads), cfg.head_convs)
    inv.afe()

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
