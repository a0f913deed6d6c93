"""Seeded weights for a cell, made on the device in a few large calls.

``make_state_dict(shapes, seed, device)`` fills a ``state_dict`` in the
reference DEFT key names from one normal draw of a ``torch.Generator`` on
the device: convolutions He-scaled, BatchNorm scales 1 + N(0, 0.1^2) and
shifts 1 + N(0, 0.1^2), biases N(0, 0.1^2), the transposed-convolution
upsamplers the bilinear kernel the reference writes into them.

``calibrate(sd, spec, images, cfg, gen)`` then makes the random network
behave like a trained one where the cell's load depends on it, with one
float32 reference forward over the calibration frames (``deft_ref``):

* every BatchNorm's running variance is set to the mean square of what
  it sees, in network order, and its running mean left at 0, so every
  layer keeps a unit scale without being centred (each channel's square
  at least a tenth of its layer's mean); the AFE's are set on embeddings
  at random centres, and the affinity's last layer is scaled so that its
  logits there spread by 1 about a mean of 1 (most pairs pass its ReLU,
  so the similarity depends on the pair);
* each DCNv2 offset conv is rescaled so the offsets spread by 1 px over
  the frames, with a bias drawn from U(-1, 1): a trained DCN's offsets lie
  within a few pixels;
* the heatmap head's output conv is scaled so its logits spread by 1, and
  each class's bias is set so that on the calibration frames the class
  has ``detections_per_frame[class]`` detections per frame at or above the
  tracking threshold, counted as the program's decode counts them at the
  configuration's compute dtype: rounded logits whose equal neighbours
  tie in the 3x3 max-pool all count (at bfloat16 a broad peak's top cells
  often round alike; counted in float32, the seeds' bf16 programs found
  29-67 detections per frame for a target of 30);
* the box heads' biases are set to the configuration's box prior.

Why rescale without centring, and shift every BatchNorm by 1: a random
network normalized to zero mean and unit variance at every layer is
chaotic.  Rounding grows through the trunk, so at 256x448 a bfloat16
forward differs from the float32 one by 15% of the head input's norm and
moves the heatmap's peaks by up to 0.29 (a float8 one by 0.63), and no
comparison can tell a sound bfloat16 program from a broken one.  Kept
mostly on the linear side of their ReLUs, the layers pass rounding on
without growing it: 1.4-1.7% of the head input, peaks moved by 0.007 at
bfloat16 and by 0.29-0.35 at float8 there.

The reference gets the same ``state_dict``: the program and the
reference compute from identical weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference.deft_ref import Reference

VAR_FLOOR = 0.1      # of a layer's mean square (``_Calibrating.bn``)
BN_SHIFT = 1.0       # the mean of every BatchNorm's shift
OFFSET_SPREAD = 1.0  # px, the offsets' spread over the calibration frames
HM_SPREAD = 1.0      # the spread of the heatmap's logits
AFFINITY_MEAN = 1.0  # the affinity logits' mean, their spread 1


def bilinear_kernel(k: int) -> torch.Tensor:
    """The depthwise bilinear upsampling kernel (CenterNet's
    ``fill_up_weights``)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    row = 1.0 - torch.abs(torch.arange(k, dtype=torch.float32) / f - c)
    return row[:, None] * row[None, :]


def make_state_dict(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                    seed: int, device) -> Dict[str, torch.Tensor]:
    """``shapes``: key -> (shape, dtype) of the network's ``state_dict``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    floats = {k: s for k, (s, dt) in shapes.items() if dt.is_floating_point}
    total = sum(math.prod(s) for s in floats.values())
    noise = torch.randn(total, generator=gen, device=device)
    bn_modules = {k.rsplit(".", 1)[0] for k in shapes
                  if k.endswith(".running_mean")}
    sd, off = {}, 0
    for key, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            sd[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        z = noise[off: off + n].view(shape)
        off += n
        module, leaf = key.rsplit(".", 1)
        if leaf == "running_mean":
            sd[key] = torch.zeros(shape, device=device)
        elif leaf == "running_var":
            sd[key] = torch.ones(shape, device=device)
        elif module in bn_modules:
            sd[key] = ((1.0 + 0.1 * z) if leaf == "weight"
                       else BN_SHIFT + 0.1 * z)
        elif ".up_" in key and len(shape) == 4:
            sd[key] = bilinear_kernel(shape[-1]).to(device).expand(
                shape).contiguous()
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            sd[key] = z * math.sqrt(2.0 / fan_in)
        else:
            sd[key] = 0.1 * z
    return sd


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], spec: dict, images: torch.Tensor,
              cfg: dict, gen: torch.Generator) -> dict:
    """Data-dependent set-up of ``sd`` in place on normalized NCHW
    ``images`` (module docstring).  Returns what it set, for the log."""
    ref = _Calibrating(sd, spec, gen)
    y, maps = ref.trunk(images)
    m = spec["max_object"]
    centers = torch.rand((images.shape[0], m, 2), generator=gen,
                         device=images.device) * 2.0 - 1.0
    emb = ref.embed(maps, centers)
    z = ref.affinity(emb[0], emb[-1], logits=True)
    last = f"AFE.final_net.{_last_conv(sd)}"
    spread = z.std().clamp(min=1e-6)
    sd[last + ".weight"].div_(spread)
    sd[last + ".bias"].div_(spread).add_(AFFINITY_MEAN - z.mean() / spread)
    t = torch.relu(ref.conv(y, "hm.0", padding=1))
    w, b = sd["hm.2.weight"], sd["hm.2.bias"]
    z = F.conv2d(t, w)                                        # [B, C, h, w]
    gain = HM_SPREAD / z.std().item()
    w.mul_(gain)
    z = z * gain
    rnd = _rounding(cfg["compute_dtype"])
    bias = [_class_bias(rnd(z[:, c]), cfg["track_thresh"], n, rnd)
            for c, n in enumerate(cfg["detections_per_frame"])]
    b.copy_(torch.tensor(bias, device=b.device))
    w_box, h_box = cfg["box_prior_cells"]
    for head, value in (("ltrb_amodal", (-w_box / 2, -h_box / 2,
                                         w_box / 2, h_box / 2)),
                        ("wh", (w_box, h_box)), ("reg", (0.5, 0.5)),
                        ("tracking", (0.0, 0.0))):
        if f"{head}.2.bias" in sd:
            sd[f"{head}.2.weight"].mul_(0.1)
            sd[f"{head}.2.bias"].copy_(torch.tensor(value,
                                                    device=b.device))
    return {"hm_gain": gain, "hm_bias": bias}


def _last_conv(sd) -> int:
    """The index of the AFE affinity stack's last conv."""
    return max(int(k.split(".")[2]) for k in sd
               if k.startswith("AFE.final_net.") and k.endswith(".weight")
               and sd[k].dim() == 4)


def _rounding(dtype: str):
    """Rounding to the configuration's compute dtype, in float32."""
    if dtype == "float32":
        return lambda t: t
    return lambda t: t.to(getattr(torch, dtype)).float()


def _class_bias(z: torch.Tensor, thr: float, per_frame: float, rnd,
                steps: int = 40) -> float:
    """The bias of one class's logits z [frames, h, w] (rounded to the
    compute dtype) at which the heatmap's decode finds ``per_frame``
    detections per frame at or above ``thr``: the bias and the sum rounded
    as the program rounds them, then the clamped sigmoid and the 3x3
    max-pool, whose ties (equal rounded neighbours) all count, as the
    program's do.  A bisection; the count grows with the bias."""
    def count(bias):
        logit = rnd(z + rnd(torch.tensor(bias, device=z.device)))
        score = torch.sigmoid(logit).clamp(1e-4, 1.0 - 1e-4)
        mx = F.max_pool2d(score[:, None], 3, 1, 1)[:, 0]
        return float(((mx == score) & (score >= thr)).sum()) / z.shape[0]

    lo, hi = -50.0, 50.0
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if count(mid) >= per_frame:
            hi = mid
        else:
            lo = mid
    return hi


class _Calibrating(Reference):
    """The reference forward that sets what ``calibrate`` sets as it
    goes: each BatchNorm's statistics before it normalizes, each offset
    conv's scale before it samples."""

    def __init__(self, sd, spec, gen):
        super().__init__(sd, spec)
        self.gen = gen

    def bn(self, x, key):
        dims = [d for d in range(x.dim()) if d != 1]
        # the running mean stays 0 and the running variance is the mean
        # square: the layer rescales and does not centre (module docstring)
        var = (x * x).mean(dims)
        var = var.clamp(min=VAR_FLOOR * var.mean().item())
        self.p[key + ".running_var"].copy_(var)
        return super().bn(x, key)

    def dcn(self, x, key):
        w = self.p[key + ".conv_offset_mask.weight"]
        b = self.p[key + ".conv_offset_mask.bias"]
        b.zero_()
        raw = self.conv(x, key + ".conv_offset_mask", padding=1)
        w.mul_(OFFSET_SPREAD / raw[:, :18].std().clamp(min=1e-6).item())
        b.copy_(torch.rand(b.shape, generator=self.gen, device=b.device)
                * 2.0 - 1.0)
        return super().dcn(x, key)


def state_shapes(model) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """key -> (shape, dtype) of a module's ``state_dict``."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()}
