"""Model factory, the counterpart of ``deft_tpu/models/factory.py``.

``create_model(arch, cfg, device)`` builds the network of ``--arch``, gives
it a seeded initialization (``init_model``) and moves it to ``device`` in
eval mode.  It computes in ``cfg.compute_dtype`` (float32 or bfloat16,
``models/layers.py``) with float32 parameters.  The arch string parses as
the JAX factory's (``factory.py:34-99``), "name_layers":

* ``dla_<d>`` (``dla`` is DLA-34): ``DEFTNet`` at ``DLA_PLANS[d]``, the
  tracker with its AFE;
* ``res_<d>``: PoseResNet, ResNet-<d> + the plain 256-channel deconv neck;
* ``resdcn_<d>``: PoseResDCN, ResNet-<d> + the DCN deconv neck, its width
  from the heatmap tower's (64: [256, 128, 64]);
* ``mobilenet``: MobileNetV2 + the DCN deconv neck of
  ``cfg.msra_outchannel``;
* ``dlav0_<d>``: DLA-34 + the legacy concat-node DLAUp;
* ``generic``: ``cfg.backbone`` x ``cfg.neck``;

the last five a detection-only ``GenericNet``.  Any other name raises
``ValueError``.
"""

from __future__ import annotations

import json
import math
from typing import Tuple

import torch
import torch.nn as nn

from deft_tpu_torch.config import Config
from deft_tpu_torch.models.dcn import DCNv2
from deft_tpu_torch.models.deft import DEFTNet
from deft_tpu_torch.models.dla import NodeSpec, dla_depth
from deft_tpu_torch.models.generic import (GenericNet, make_backbone,
                                           make_neck, neck_channels)

SUPPORTED = ("dla", "dlav0", "resdcn", "res", "generic", "mobilenet")


# cfg.compute_dtype -> the dtype the trunk, heads and selectors compute in
# (parameters stay float32); "" is the JAX package's float32 too
COMPUTE_DTYPES = {"float32": torch.float32, "": torch.float32,
                  "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def parse_layer_radii(spec: str) -> Tuple[Tuple[str, int], ...]:
    """``cfg.dcn_layer_radii`` (JSON object: path-substring -> radius) as
    (pattern, radius) pairs, longest pattern first so the most specific
    match wins."""
    if not spec:
        return ()
    m = json.loads(spec)
    return tuple(sorted(((str(k), int(v)) for k, v in m.items()),
                        key=lambda kv: -len(kv[0])))


def parse_arch(arch: str):
    """(family, the int after the underscore or 0), as the JAX factory
    parses every arch first; an unknown family raises ``ValueError``."""
    name = arch[: arch.find("_")] if "_" in arch else arch
    layers = int(arch[arch.find("_") + 1:]) if "_" in arch else 0
    if name not in SUPPORTED:
        raise ValueError(f"unknown arch {arch}; supported: {SUPPORTED}")
    return name, layers


def generic_parts(arch: str, cfg: Config):
    """(backbone, neck, resnet depth, msra width, flat keys) of a generic
    arch, as ``deft_tpu/models/factory.py:70-97`` maps it."""
    name, layers = parse_arch(arch)
    backbone, neck = cfg.backbone, cfg.neck
    num_layers, msra = cfg.num_layers, cfg.msra_outchannel
    if name in ("res", "resdcn", "mobilenet"):
        backbone = "mobilenet" if name == "mobilenet" else "resnet"
        neck = "msraup_plain" if name == "res" else "msraup"
        num_layers = layers or num_layers
        if name == "resdcn" and cfg.heads and cfg.head_convs.get("hm"):
            msra = int(cfg.head_convs["hm"][0])
        elif name == "res":
            msra = 256
    elif name == "dlav0":
        backbone, neck = "dla34", "dlaupv0"
    return backbone, neck, num_layers, msra, name in ("res", "resdcn")


def require_deft_arch(arch: str, what: str):
    """Raise ``ValueError`` where ``arch`` builds a detection-only
    ``GenericNet``: it has no AFE and no ``train_forward``, so neither
    tracking nor the training step runs it (in the JAX package neither
    does: ``Detector`` passes ``flip_test`` and ``parity_tf`` that
    ``GenericNet.detect`` does not take, and the trainer calls a
    ``train_forward`` it lacks)."""
    if parse_arch(arch)[0] != "dla":
        raise ValueError(
            f"{what} runs the DEFT tracker (--arch dla_<depth>); {arch!r} "
            "builds a detection-only GenericNet: call create_model and its "
            "detect")


def _build(arch: str, cfg: Config, dtype: torch.dtype) -> nn.Module:
    name, _ = parse_arch(arch)
    if name == "dla":
        spec = NodeSpec(cfg.dla_node, cfg.dcn_offset_range,
                        parse_layer_radii(cfg.dcn_layer_radii), cfg.dcn_impl)
        return DEFTNet(
            heads=cfg.heads,
            head_convs={h: tuple(c) for h, c in cfg.head_convs.items()},
            spec=spec, max_object=cfg.max_object,
            prior_bias=cfg.prior_bias, head_kernel=cfg.head_kernel,
            align_corners=cfg.align_corners, dataset=cfg.dataset,
            depth_scale=cfg.depth_scale, compute_dtype=dtype,
            dla_depth=dla_depth(arch))
    backbone, neck, num_layers, msra, flat = generic_parts(arch, cfg)
    bb = make_backbone(backbone, num_layers)
    nk = make_neck(neck, neck_channels(bb), cfg.dla_node, msra)
    return GenericNet(
        bb, nk, cfg.heads,
        {h: tuple(c) for h, c in cfg.head_convs.items()},
        prior_bias=cfg.prior_bias, head_kernel=cfg.head_kernel,
        compute_dtype=dtype, flat=flat)


def create_model(arch: str, cfg: Config, device="cuda") -> nn.Module:
    """The seeded network of ``arch`` on ``device`` in eval mode (module
    docstring)."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    dev = resolve_device(device)
    # construction draws torch's default init from the global generator;
    # fork it so building a model leaves the caller's random state alone,
    # then overwrite everything from the seeded generator
    with torch.random.fork_rng(devices=[]):
        model = _build(arch, cfg, COMPUTE_DTYPES[cfg.compute_dtype])
    init_model(model, cfg.seed, cfg.prior_bias)
    return model.to(dev).eval()


@torch.no_grad()
def init_model(model: nn.Module, seed: int,
               prior_bias: float = -4.6) -> nn.Module:
    """Seeded initialization in the reference's style: torch's default conv
    and deconv init, CharlesShang's DCN init (uniform weight, zero
    offset/mask conv), identity BatchNorms, bilinear depthwise upsamplers,
    zero head biases except the heatmap's ``prior_bias``.  Runs on the CPU
    generator, so call it before moving the model to another device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCNv2):
            stdv = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-stdv, stdv, generator=g)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d) or (isinstance(m, nn.ConvTranspose2d)
                                          and m.groups == 1):
            fan_in = m.weight[0].numel()
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(fan_in)
                m.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, DCNv2):
            m.conv_offset_mask.weight.zero_()
            m.conv_offset_mask.bias.zero_()
    for h in model.heads:
        tower = getattr(model, h)
        for m in tower:
            if isinstance(m, nn.Conv2d):
                m.bias.zero_()
        if "hm" in h:
            tower[-1].bias.fill_(prior_bias)
    return model
