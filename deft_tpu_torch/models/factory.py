"""Model factory, the counterpart of ``deft_tpu/models/factory.py``.

``create_model("dla_34", cfg, device)`` builds the network, gives it a seeded
initialization (``init_model``) and moves it to ``device`` in eval mode.  It
computes in ``cfg.compute_dtype`` (float32 or bfloat16, ``models/layers.py``)
with float32 parameters.
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
from deft_tpu_torch.models.dla import NodeSpec


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


def create_model(arch: str, cfg: Config, device="cuda") -> DEFTNet:
    if arch not in ("dla_34", "dla"):
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; the port runs dla_34 "
            "(ROADMAP.md, queue A: other archs)")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    dev = resolve_device(device)
    spec = NodeSpec(cfg.dla_node, cfg.dcn_offset_range,
                    parse_layer_radii(cfg.dcn_layer_radii), cfg.dcn_impl)
    # construction draws torch's default init from the global generator;
    # fork it so building a model leaves the caller's random state alone,
    # then overwrite everything from the seeded generator
    with torch.random.fork_rng(devices=[]):
        model = DEFTNet(
            heads=cfg.heads,
            head_convs={h: tuple(c) for h, c in cfg.head_convs.items()},
            spec=spec, max_object=cfg.max_object,
            prior_bias=cfg.prior_bias, head_kernel=cfg.head_kernel,
            align_corners=cfg.align_corners, dataset=cfg.dataset,
            depth_scale=cfg.depth_scale,
            compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype])
    init_model(model, cfg.seed, cfg.prior_bias)
    return model.to(dev).eval()


@torch.no_grad()
def init_model(model: DEFTNet, seed: int, prior_bias: float = -4.6) -> DEFTNet:
    """Seeded initialization in the reference's style: torch's default conv
    init, CharlesShang's DCN init (uniform weight, zero offset/mask conv),
    identity BatchNorms, bilinear upsamplers, zero head biases except the
    heatmap's ``prior_bias``.  Runs on the CPU generator, so call it before
    moving the model to another device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCNv2):
            stdv = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-stdv, stdv, generator=g)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
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
