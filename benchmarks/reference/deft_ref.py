"""Plain PyTorch reference of DEFT's DLA-34 tracker network.

A function of a ``state_dict`` in the reference DEFT key names (``base.*``,
``dla_up.*``, ``ida_up.*``, the head towers, ``AFE.*``), written from the
published network (CenterTrack's DLASeg with DCNv2 nodes and DEFT's AFE
head), in float32 with TF32 off and no kernel of the program under test:
convolutions are ``F.conv2d``, the modulated deformable 3x3 convolution is
``F.grid_sample`` at the clamped tap positions (zeros outside the image)
times the mask, then one product with the weight.

``Reference(sd, spec)``:

* ``trunk(x)`` -> (head input, the 13 feature maps the AFE samples);
* ``heads(y)`` -> {head: NCHW float32 map};
* ``embed(maps, centers)`` -> [B, N, E] AFE embeddings at centres in
  [-1, 1] (border padding, corner-aligned);
* ``similarity(ring, counts, emb, n)`` -> the dual-softmax similarity of
  one frame's embeddings against ring slots, the tracker's input.

``quant`` rounds the operands and the result of every convolution and
product, the control's lower precision (``precision.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FALSE_CONSTANT = 1.0
KK = 9


def dla34_spec(cfg: dict) -> dict:
    """The network's shape from a configuration file's keys."""
    return {
        "levels": tuple(cfg["levels"]),
        "channels": tuple(cfg["channels"]),
        "heads": dict(cfg["heads"]),
        "head_conv": int(cfg["head_conv"]),
        "radius": int(cfg["dcn_offset_range"]),
        "max_object": int(cfg["max_object"]),
        "selector_out": tuple(cfg["afe_selector_out"]),
        "affinity_widths": tuple(cfg["afe_affinity_widths"]),
        "affinity_bn": int(cfg["afe_affinity_bn_layers"]),
    }


class Reference:
    def __init__(self, sd: Dict[str, torch.Tensor], spec: dict,
                 quant: Optional[Callable] = None):
        self.p = sd
        self.spec = spec
        self.q = quant

    # ---- primitives ---------------------------------------------------------

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return self.q(t) if self.q is not None else t

    def conv(self, x, key, stride=1, padding=0, groups=1):
        w = self.p[key + ".weight"]
        b = self.p.get(key + ".bias")
        return self._round(F.conv2d(self._round(x), self._round(w), b,
                                    stride, padding, 1, groups))

    def bn(self, x, key):
        w, b = self.p[key + ".weight"], self.p[key + ".bias"]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = self.p[key + ".running_mean"]
        var = self.p[key + ".running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean.view(shape)) * (inv * w).view(shape) + b.view(shape)

    def bn_last(self, x, key):
        """BatchNorm over the last axis of any-rank x."""
        flat = x.reshape(-1, x.shape[-1])
        return self.bn(flat, key).reshape(x.shape)

    def conv_bn_relu(self, x, key, stride=1, padding=1):
        return torch.relu(self.bn(self.conv(x, key + ".0", stride, padding),
                                  key + ".1"))

    def dcn(self, x, key):
        """Modulated deformable 3x3 conv, stride 1, one group: channel 2k of
        the offset conv is tap k's dy, 2k+1 its dx, 18+k its mask logit;
        offsets clamped to +-radius."""
        b, c, h, w = x.shape
        r = self.spec["radius"]
        om = self.conv(x, key + ".conv_offset_mask", padding=1)
        off = om[:, : 2 * KK].reshape(b, KK, 2, h, w)
        if r >= 0:
            off = off.clamp(-r, r)
        mask = torch.sigmoid(om[:, 2 * KK:])                   # [B, 9, H, W]
        k = torch.arange(KK, device=x.device)
        ky = (k // 3 - 1).float().view(1, KK, 1, 1)
        kx = (k % 3 - 1).float().view(1, KK, 1, 1)
        yy = torch.arange(h, device=x.device, dtype=torch.float32).view(
            1, 1, h, 1) + ky + off[:, :, 0]
        xx = torch.arange(w, device=x.device, dtype=torch.float32).view(
            1, 1, 1, w) + kx + off[:, :, 1]
        grid = torch.stack([2.0 * xx / (w - 1) - 1.0,
                            2.0 * yy / (h - 1) - 1.0], dim=-1)
        grid = grid.reshape(b, KK, h * w, 2)
        cols = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)               # [B, C, 9, HW]
        cols = cols * mask.reshape(b, 1, KK, h * w)
        wk = self.p[key + ".weight"].reshape(-1, c * KK)       # [Cout, C*9]
        out = torch.matmul(self._round(wk),
                           self._round(cols.reshape(b, c * KK, h * w)))
        out = out + self.p[key + ".bias"].view(1, -1, 1)
        return self._round(out.reshape(b, -1, h, w))

    # ---- DLA-34 -------------------------------------------------------------

    def basic_block(self, x, key, stride, residual):
        out = torch.relu(self.bn(self.conv(x, key + ".conv1", stride, 1),
                                 key + ".bn1"))
        out = self.bn(self.conv(out, key + ".conv2", 1, 1), key + ".bn2")
        return torch.relu(out + residual)

    def root(self, key, children):
        x = self.bn(self.conv(torch.cat(children, 1), key + ".conv"),
                    key + ".bn")
        return torch.relu(x)

    def tree(self, x, key, levels, cin, cout, stride, level_root,
             children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, stride, stride) if stride > 1 else x
        if cin != cout:
            residual = self.bn(self.conv(bottom, key + ".project.0"),
                               key + ".project.1")
        else:
            residual = bottom
        if level_root:
            children.append(bottom)
        if levels == 1:
            x1 = self.basic_block(x, key + ".tree1", stride, residual)
            x2 = self.basic_block(x1, key + ".tree2", 1, x1)
            return self.root(key + ".root", [x2, x1] + children)
        x1 = self.tree(x, key + ".tree1", levels - 1, cin, cout, stride,
                       False)
        children.append(x1)
        return self.tree(x1, key + ".tree2", levels - 1, cout, cout, 1,
                         False, children)

    def base(self, x) -> List[torch.Tensor]:
        lv, ch = self.spec["levels"], self.spec["channels"]
        x = self.conv_bn_relu(x, "base.base_layer", 1, 3)
        outs = []
        for j in range(lv[0]):
            x = self._seq_level(x, "base.level0", j, 1)
        outs.append(x)
        for j in range(lv[1]):
            x = self._seq_level(x, "base.level1", j, 2 if j == 0 else 1)
        outs.append(x)
        for i in (2, 3, 4, 5):
            x = self.tree(x, f"base.level{i}", lv[i], ch[i - 1], ch[i], 2,
                          i > 2)
            outs.append(x)
        return outs

    def _seq_level(self, x, key, j, stride):
        """Conv j of a flat [conv, bn, relu] * convs level."""
        return torch.relu(self.bn(self.conv(x, f"{key}.{3 * j}", stride, 1),
                                  f"{key}.{3 * j + 1}"))

    def deform_node(self, x, key):
        return torch.relu(self.bn(self.dcn(x, key + ".conv"),
                                  key + ".actf.0"))

    def up(self, x, key, f):
        if f == 1:
            return x
        wt = self.p[key + ".weight"]
        return self._round(F.conv_transpose2d(
            self._round(x), self._round(wt), None, f, f // 2, 0, x.shape[1]))

    def ida_up(self, layers, key, startp, endp, factors):
        for i in range(startp + 1, endp):
            j = i - startp
            proj = self.deform_node(layers[i], f"{key}.proj_{j}")
            x = self.up(proj, f"{key}.up_{j}", factors[j])
            layers[i] = self.deform_node(x + layers[i - 1],
                                         f"{key}.node_{j}")
        return layers

    def trunk(self, x):
        """x [B, 3, H, W] normalized -> (head input, 13 maps)."""
        ch = list(self.spec["channels"])
        first = 2
        base_outs = self.base(x)
        maps = list(base_outs)
        channels = ch[first:]
        scales = [2 ** i for i in range(len(channels))]
        ida_factors = []
        for i in range(len(channels) - 1):
            j = -i - 2
            ida_factors.append([s // scales[j] for s in scales[j:]])
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
        layers = list(base_outs[first:])
        out = [layers[-1]]
        for i in range(len(channels) - 1):
            self.ida_up(layers, f"dla_up.ida_{i}", len(layers) - i - 2,
                        len(layers), ida_factors[i])
            out.insert(0, layers[-1])
        maps += out
        y = list(out[: 5 - first])
        self.ida_up(y, "ida_up", 0, len(y), [2 ** i for i in range(len(y))])
        maps += y
        return y[-1], maps

    def heads(self, y) -> Dict[str, torch.Tensor]:
        out = {}
        for h in self.spec["heads"]:
            t = torch.relu(self.conv(y, f"{h}.0", padding=1))
            out[h] = self.conv(t, f"{h}.2")
        return out

    # ---- AFE ----------------------------------------------------------------

    def embed(self, maps: Sequence[torch.Tensor],
              centers: torch.Tensor) -> torch.Tensor:
        """13 maps + [B, N, 2] centres in [-1, 1] -> [B, N, E]."""
        feats = []
        grid = centers[:, :, None, :]                          # [B, N, 1, 2]
        for i, fm in enumerate(maps):
            s = torch.relu(self.conv(fm, f"AFE.selector.{i}", padding=1))
            v = F.grid_sample(s, grid, mode="bilinear",
                              padding_mode="border", align_corners=True)
            feats.append(v[..., 0].permute(0, 2, 1))           # [B, N, oc]
        return torch.cat(feats, dim=-1)

    def affinity(self, e_pre, e_next, logits: bool = False):
        """[..., N, E] x [..., M, E] -> [..., N, M] raw affinity (with
        ``logits``, the last layer's output before its ReLU)."""
        e = e_pre.shape[-1]
        e_pre = self.bn_last(e_pre, "AFE.stacker2_bn")
        e_next = self.bn_last(e_next, "AFE.stacker2_bn")
        widths = self.spec["affinity_widths"]
        n_bn = self.spec["affinity_bn"]
        idx = 0
        w0 = self.p[f"AFE.final_net.{idx}.weight"][:, :, 0, 0]
        b0 = self.p[f"AFE.final_net.{idx}.bias"]
        pre0 = self._round(torch.matmul(self._round(e_pre),
                                        self._round(w0[:, :e].t())))
        next0 = self._round(torch.matmul(self._round(e_next),
                                         self._round(w0[:, e:].t())))
        x = pre0[..., :, None, :] + next0[..., None, :, :] + b0
        idx += 1
        for li in range(len(widths)):
            if li > 0:
                w = self.p[f"AFE.final_net.{idx}.weight"][:, :, 0, 0]
                b = self.p[f"AFE.final_net.{idx}.bias"]
                x = self._round(torch.matmul(self._round(x),
                                             self._round(w.t())) + b)
                idx += 1
            if li < n_bn:
                x = self.bn_last(x, f"AFE.final_net.{idx}")
                idx += 1
            if not (logits and li == len(widths) - 1):
                x = torch.relu(x)
            idx += 1
        return x[..., 0]

    def similarity(self, ring: torch.Tensor, counts: torch.Tensor,
                   emb: torch.Tensor, n_next: int) -> torch.Tensor:
        """ring [W, N, E] (rows past each slot's count are zeros), counts
        [W], emb [N, E] (rows past n_next zeros) -> [W, N, N+1]: the fused
        dual-softmax similarity, column n_next the unmatched probability,
        invalid rows and columns zero."""
        n = self.spec["max_object"]
        dev = emb.device
        aff = self.affinity(ring, emb)                         # [W, N, N]
        ids = torch.arange(n, device=dev)
        row_ok = ids[None, :, None] < counts[:, None, None]
        aff = aff * (ids < n_next)[None, None, :] * row_ok
        aff = F.pad(aff, (0, 1, 0, 1), value=FALSE_CONSTANT)
        x_f = torch.softmax(aff, dim=-1)
        x_t = torch.softmax(aff, dim=-2)
        real = torch.maximum(x_f[..., :n, :n], x_t[..., :n, :n])
        last = x_f[..., :n, n:]
        fused = torch.cat([real, last], dim=-1)
        col = torch.arange(n + 1, device=dev)
        unmatched = torch.where(col == n_next, last,
                                torch.zeros((), device=dev))
        fused = torch.where(col < n_next, fused, unmatched)
        return fused * row_ok


def sigmoid_clamped(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x).clamp(1e-4, 1.0 - 1e-4)


def peaks(hm: torch.Tensor) -> torch.Tensor:
    """A sigmoided [C, H, W] heatmap with every value that is not the
    maximum of its 3x3 neighbourhood set to 0."""
    mx = F.max_pool2d(hm[None], 3, 1, 1)[0]
    return hm * (mx == hm).to(hm.dtype)


MEAN = (0.40789654, 0.44719302, 0.47026115)   # CenterNet's, BGR order
STD = (0.28863828, 0.27408164, 0.27809835)


def fix_res_affine(frame_h: int, frame_w: int, dst_h: int,
                   dst_w: int) -> torch.Tensor:
    """The 2x3 float64 affine from a frame's pixels to a [dst_h, dst_w]
    grid under CenterNet's fix_res geometry: the frame's centre to the
    grid's, the frame's longer side to ``dst_w`` (one scale for both
    axes)."""
    k = dst_w / float(max(frame_h, frame_w))
    return torch.tensor([[k, 0.0, dst_w / 2.0 - k * frame_w / 2.0],
                         [0.0, k, dst_h / 2.0 - k * frame_h / 2.0]],
                        dtype=torch.float64)


def input_image(frames: torch.Tensor, in_h: int, in_w: int) -> torch.Tensor:
    """uint8 BGR frames [B, H, W, 3] -> normalized float32 [B, 3, in_h,
    in_w]: the fix_res bilinear warp (zeros outside the frame; source
    positions in float64), then the mean and deviation of CenterNet's
    inputs."""
    b, h, w, _ = frames.shape
    a = fix_res_affine(h, w, in_h, in_w)
    k = a[0, 0].item()
    dev = frames.device
    img = frames.permute(0, 3, 1, 2).float()

    def taps(n_out, n_src, shift):
        pos = (torch.arange(n_out, dtype=torch.float64, device=dev)
               - shift) / k
        lo = torch.floor(pos)
        frac = (pos - lo).float()
        lo = lo.long()
        out = []
        for idx, wgt in ((lo, 1.0 - frac), (lo + 1, frac)):
            ok = (idx >= 0) & (idx <= n_src - 1)
            out.append((idx.clamp(0, n_src - 1), wgt * ok.float()))
        return out

    rows = taps(in_h, h, a[1, 2].item())
    cols = taps(in_w, w, a[0, 2].item())
    out = 0.0
    for yi, wy in rows:
        part = img.index_select(2, yi) * wy.view(1, 1, -1, 1)
        for xi, wx in cols:
            out = out + part.index_select(3, xi) * wx.view(1, 1, 1, -1)
    mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
    return (out / 255.0 - mean) / std
