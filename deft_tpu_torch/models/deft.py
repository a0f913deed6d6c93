"""DEFTNet: joint detection + embedding network, the counterpart of
``deft_tpu/models/deft.py`` (inference entry points).

The network is the reference's ``DLASeg`` with its head towers (3x3 conv ->
ReLU -> 1x1 out, heatmap bias = ``prior_bias``) and the AFE head as direct
attributes, so a reference ``state_dict`` loads with its own key names
(``base.*``, ``dla_up.*``, ``ida_up.*``, ``hm.*``, ``AFE.*`` ...).

Entry points, with the JAX layouts at their boundary:

* ``forward(image)`` -> ``({head: [B, H/4, W/4, C]}, feature_maps[13])``;
  ``image`` is NHWC as in the JAX package, feature maps stay NCHW;
* ``trunk(image)`` -> ``(head input, feature_maps[13])``, the forward
  without the head towers;
* ``detect(image, k, parity_tf, flip_test)`` -> sigmoided + decoded top-K
  detections (the depth head decoded to metres) and their AFE embeddings,
  for any batch (the nuScenes rig runs its cameras as one batch);
  ``flip_test`` runs the trunk at twice the batch, on the images and their
  mirrors;
* ``embed_image(image, centers)`` -> the AFE embeddings at given centres
  (public detections: no heads, no decode);
* ``extract`` and ``window_similarity`` re-export the AFE head;
* ``train_forward(image, pre_image, centers_pre, centers_next)`` ->
  (head outputs, [B, N+1, N+1] affinity), the training step's forward
  (``deft_tpu/models/deft.py:175-186``): the image through trunk and
  heads, then the ``pre_image`` through the trunk, then the AFE affinity
  between their centres; in train mode each BatchNorm updates its
  statistics in that order;
* the fused per-frame tracking programs ``frame_step``, ``frame_chunk`` and
  ``frame_chunk_batched`` (``deft_tpu/models/deft.py:319-576``): device warp
  of the raw uint8 frame, detect, the valid-detection prefix, the AFE
  similarity against the ``sim_window`` freshest slots of the embedding ring
  and the conditional ring write, with every detection field packed into one
  float32 vector (``pack_dets``) and the similarity in float16 (or uint8);
  each takes ``flip_test`` into its ``detect``, and ``yuv_in`` for frames
  packed by ``runner.pack_yuv420`` (``_decode_input``).  A ring state
  holding ``prev_frame`` (delta uploads) takes each frame as a uint8
  difference against the previous one.  ``frame_step_embed`` is
  the public-detection frame (it does not flip, as in the JAX package):
  device warp, trunk, embeddings at the given centres, the same similarity
  and ring write.

The ring state ``{"embeds" [W, M, E] float32, "counts" [W] int32, "ptr" []
int64}`` is a dict of device tensors that the frame programs update in place
(the JAX package returns a new state and donates the old); nothing in a
frame program waits for the device or takes a shape from it, so a caller
can queue frames ahead, or capture a program as a CUDA graph
(``PipelinedRunner.run_program``).

``spans`` (``utils/spans.py``; a ``PipelinedRunner`` sets its own) times the
frame programs' stages as the host queues them: ``program.warp`` (the input
path), ``program.forward``, ``program.decode`` (sigmoid, decode, centres),
``program.embed`` (the AFE's sampling) and ``program.tail`` (per frame: the
similarity and the ring write).  A replayed graph opens none of them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from deft_tpu_torch.models.afe import AFE
from deft_tpu_torch.models.dla import DLASeg, NodeSpec, selector_widths
from deft_tpu_torch.models.layers import Conv2d
from deft_tpu_torch.ops.decode import clamped_sigmoid, generic_decode
from deft_tpu_torch.utils.spans import NO_SPANS
from deft_tpu_torch.ops.warp import hat_matrix, warp_affine_with

MEAN = (0.40789654, 0.44719302, 0.47026115)
STD = (0.28863828, 0.27408164, 0.27809835)

# the decode outputs the host consumes (deft_tpu/models/deft.py:462-464)
KEEP_DETS = ("scores", "clses", "cts", "bboxes", "bboxes_amodal",
             "tracking", "dep", "rot", "dim", "amodel_offset",
             "nuscenes_att", "velocity")


def pack_dets(dets: Dict[str, torch.Tensor], n_valid: torch.Tensor):
    """A decode-output dict (batch 1) plus the valid count as one float32
    vector: ``[n_valid, *dets[key] for key in sorted order]``
    (``deft_tpu/models/deft.py:36-45``)."""
    parts = [n_valid.float().reshape(1)]
    for key in sorted(dets):
        parts.append(dets[key][0].float().reshape(-1))
    return torch.cat(parts)


def unpack_dets(packed: np.ndarray, layout: Sequence[Tuple[str, int]],
                k: int):
    """Inverse of ``pack_dets`` on the host: (packed vector, [(key, dim)] in
    sorted order, K) -> (dict of [1, K] or [1, K, dim] numpy arrays,
    n_valid)."""
    n_valid = int(packed[0])
    out = {}
    off = 1
    for key, dim in layout:
        arr = packed[off: off + k * dim]
        out[key] = arr.reshape(1, k) if dim == 1 else arr.reshape(1, k, dim)
        off += k * dim
    return out, n_valid


def new_ring(window: int, max_object: int, embed_dim: int, device):
    """An empty embedding ring for the frame programs."""
    return {"embeds": torch.zeros((window, max_object, embed_dim),
                                  dtype=torch.float32, device=device),
            "counts": torch.zeros((window,), dtype=torch.int32, device=device),
            "ptr": torch.zeros((), dtype=torch.int64, device=device)}


class HeadTower(nn.Sequential):
    """One output head (reference ``base_model.py:36-94``): children
    ``0`` (3x3 conv), ``2`` (1x1 conv) ... with ReLUs between, the 1x1 output
    conv last."""

    def __init__(self, cin: int, out_channels: int, convs: Sequence[int],
                 head_kernel: int = 3, prior_bias=None):
        layers = []
        if len(convs) > 0:
            layers += [Conv2d(cin, convs[0], head_kernel,
                              padding=head_kernel // 2, bias=True),
                       nn.ReLU(inplace=True)]
            for c_prev, c in zip(convs[:-1], convs[1:]):
                layers += [Conv2d(c_prev, c, 1, bias=True),
                           nn.ReLU(inplace=True)]
            cin = convs[-1]
        out = Conv2d(cin, out_channels, 1, bias=True)
        with torch.no_grad():
            out.bias.fill_(0.0 if prior_bias is None else prior_bias)
        layers.append(out)
        super().__init__(*layers)


class DEFTNet(DLASeg):
    """Trunk + heads + AFE (reference ``DLASeg`` with ``opt.AFE``) at the
    DLA plan ``DLA_PLANS[dla_depth]`` (``deft_tpu/models/deft.py:113-131``):
    the head towers take ``channels[first_level]`` channels and the AFE's
    selectors the trunk's 13 widths."""

    def __init__(self, heads: Dict[str, int], head_convs: Dict[str, Sequence[int]],
                 spec: NodeSpec, max_object: int = 100,
                 prior_bias: float = -4.6, head_kernel: int = 3,
                 align_corners: bool = True, dataset: str = "mot",
                 depth_scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 dla_depth: str = "34"):
        super().__init__(spec, depth=dla_depth)
        self.compute_dtype = compute_dtype
        self.heads = dict(heads)
        last_channel = self.base.channels[self.first_level]
        for h, c in self.heads.items():
            setattr(self, h, HeadTower(
                last_channel, c, tuple(head_convs.get(h, ())), head_kernel,
                prior_bias if "hm" in h else None))
        self.AFE = AFE(max_object, align_corners, dataset,
                       selector_widths(self.base.channels, self.first_level,
                                       self.last_level))
        self.max_object = max_object
        self.depth_scale = depth_scale
        # input normalization constants, on the model's device
        self.register_buffer("input_mean", torch.tensor(MEAN),
                             persistent=False)
        self.register_buffer("input_std", torch.tensor(STD), persistent=False)
        # device warp matrices per (transform, frame size): the frame
        # programs reuse them, so no frame builds them from host scalars
        self._hats: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.spans = NO_SPANS

    @property
    def embed_dim(self) -> int:
        return self.AFE.embed_dim

    def trunk(self, image: torch.Tensor):
        """image [B, H, W, 3] -> (the heads' NCHW input, 13 NCHW maps): the
        ``DLASeg`` forward without the head towers, in ``compute_dtype``
        from the input on (``deft_tpu/models/dla.py:399-400``)."""
        x = image.permute(0, 3, 1, 2).to(self.compute_dtype)
        return super().forward(x.contiguous())

    def forward(self, image: torch.Tensor):
        """image [B, H, W, 3] -> ({head: [B, H/4, W/4, C]} float32, 13 NCHW
        maps in ``compute_dtype``); each head's output is cast to float32
        before the sigmoid and the decode (``deft_tpu/models/deft.py:92``)."""
        y, feature_maps = self.trunk(image)
        outputs = {h: getattr(self, h)(y).float().permute(0, 2, 3, 1)
                   for h in self.heads}
        return outputs, feature_maps

    def extract(self, feature_maps, centers):
        return self.AFE.extract(feature_maps, centers)

    def train_forward(self, image: torch.Tensor, pre_image: torch.Tensor,
                      centers_pre: torch.Tensor, centers_next: torch.Tensor):
        """Joint training forward (module docstring): image and pre_image
        [B, H, W, 3] normalized, centres [B, N, 2] in [-1, 1] ->
        ({head: [B, H/4, W/4, C]} float32, [B, N+1, N+1] affinity)."""
        outputs, fm_next = self(image)
        _, fm_pre = self.trunk(pre_image)
        aff = self.AFE.forward_train(fm_pre, fm_next, centers_pre,
                                     centers_next)
        return outputs, aff

    def window_similarity(self, window_embeds, window_counts, e_next, n_next):
        return self.AFE.window_similarity(window_embeds, window_counts,
                                          e_next, n_next)

    def detect(self, image: torch.Tensor, k: int = 100, parity_tf=None,
               flip_test: bool = False):
        """forward -> sigmoid -> decode -> embedding extract.

        Returns (dets, embeddings): dets is a dict of [B, K, ...] decoded
        tensors in output-grid coordinates; embeddings [B, K, E] are sampled
        at the decoded (amodal) box centers, normalized to [-1, 1] over the
        output grid.

        ``parity_tf`` ([8] host float32: the inverse-affine rows a00, a01,
        a02, a10, a11, a12, then the original width and height) samples
        instead where the reference does: each centre mapped back to
        original pixels and normalized by the original dims
        (``deft_tpu/models/deft.py:249-257``), although the feature maps
        live in the warped input frame.

        ``flip_test`` runs the trunk on the images and their horizontal
        mirrors as one batch of 2B and averages the heads as the reference
        does (``deft_tpu/models/deft.py:210-226``): ``hm``, ``wh``, ``dep``
        and ``dim`` with the mirrored half flipped back, ``amodel_offset``
        likewise with its x channels (the even ones) negated; every other
        head and the 13 feature maps come from the unflipped half.
        """
        spans = self.spans
        with spans.span("program.forward"):
            if flip_test:
                outputs, feature_maps = self._flip_forward(image)
            else:
                outputs, feature_maps = self(image)
        with spans.span("program.decode"):
            outputs["hm"] = clamped_sigmoid(outputs["hm"])
            if "dep" in outputs:
                # inference depth decode (deft_tpu/models/deft.py:231-235)
                outputs["dep"] = (1.0 / (torch.sigmoid(outputs["dep"]) + 1e-6)
                                  - 1.0) * self.depth_scale
            dets = generic_decode(outputs, k=k)
            bboxes = dets.get("bboxes")
            if bboxes is None:
                cts = dets["cts"]
            else:
                cts = torch.stack([(bboxes[..., 0] + bboxes[..., 2]) / 2.0,
                                   (bboxes[..., 1] + bboxes[..., 3]) / 2.0],
                                  dim=-1)
            if parity_tf is not None:
                # float32 scalars, as the JAX program's [8] operand, that
                # need no copy to the device
                tf = [float(v)
                      for v in np.asarray(parity_tf, np.float32).ravel()]
                xi = cts[..., 0] * 4.0          # input-frame pixels
                yi = cts[..., 1] * 4.0
                xo = tf[0] * xi + tf[1] * yi + tf[2]
                yo = tf[3] * xi + tf[4] * yi + tf[5]
                centers = torch.stack([2.0 * xo / tf[6] - 1.0,
                                       2.0 * yo / tf[7] - 1.0], dim=-1)
            else:
                out_h = image.shape[1] // 4
                out_w = image.shape[2] // 4
                centers = torch.stack([2.0 * cts[..., 0] / out_w - 1.0,
                                       2.0 * cts[..., 1] / out_h - 1.0],
                                      dim=-1)
        with spans.span("program.embed"):
            return dets, self.extract(feature_maps, centers)

    def _flip_forward(self, image: torch.Tensor):
        """``forward`` under ``flip_test`` (``detect``'s docstring)."""
        b = image.shape[0]
        outputs, feature_maps = self(torch.cat([image, image.flip(2)]))
        for head, o in outputs.items():
            mirrored = o[b:].flip(2)                       # NHWC: W is dim 2
            if head in ("hm", "wh", "dep", "dim"):
                outputs[head] = (o[:b] + mirrored) / 2.0
            elif head == "amodel_offset":
                mirrored[..., 0::2] *= -1.0                # a copy: flip's
                outputs[head] = (o[:b] + mirrored) / 2.0
            else:
                outputs[head] = o[:b]
        return outputs, [fm[:b] for fm in feature_maps]

    def embed_image(self, image: torch.Tensor, centers: torch.Tensor):
        """The trunk, then the AFE embeddings at given centres: the
        public-detection path (``deft_tpu/models/deft.py:267-280``), where
        the boxes come from a file and the model's heads and decode do not
        run.  image [B, H, W, 3] uint8 or normalized; centers [B, N, 2] in
        [-1, 1] -> [B, N, E]."""
        with self.spans.span("program.forward"):
            _, feature_maps = self.trunk(self._maybe_normalize(image))
        with self.spans.span("program.embed"):
            return self.extract(feature_maps, centers)

    # ---- fused per-frame tracking programs -----------------------------------

    def _maybe_normalize(self, image: torch.Tensor) -> torch.Tensor:
        """uint8 frames are normalized on the device; float frames pass."""
        if image.dtype == torch.uint8:
            image = (image.float() / 255.0 - self.input_mean) / self.input_std
        return image

    def _decode_input(self, image: torch.Tensor,
                      yuv_in: bool) -> torch.Tensor:
        """The device half of the input path (``deft_tpu/models/
        deft.py:293-317``): a [B, H, W, 3] frame (uint8 or normalized), or
        with ``yuv_in`` a planar YUV 4:2:0 [B, H*3/2, W] uint8 buffer
        (``runner.pack_yuv420``: BT.601 full range, the chroma averaged over
        2x2 blocks) whose chroma is nearest-upsampled, converted to BGR,
        clipped to [0, 255] and normalized -> [B, H, W, 3] float32."""
        if not yuv_in:
            return self._maybe_normalize(image)
        h = image.shape[1] * 2 // 3
        w = image.shape[2]
        y = image[:, :h, :].float()
        u = image[:, h:, : w // 2].float() - 128.0
        v = image[:, h:, w // 2:].float() - 128.0
        u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        r = y + 1.402 * v
        g = y - 0.344136 * u - 0.714136 * v
        b = y + 1.772 * u
        bgr = torch.stack([b, g, r], dim=-1).clamp(0.0, 255.0)
        return (bgr / 255.0 - self.input_mean) / self.input_std

    @staticmethod
    def _rebuild_delta(images: torch.Tensor, state) -> torch.Tensor:
        """Delta uploads (``deft_tpu/models/deft.py:441-454, :541-556``):
        frame t = frame t-1 + delta t modulo 256, from ``state["prev_frame"]``
        [1, H, W, 3] uint8 over the chunk's deltas [T, H, W, 3] uint8, as one
        cumulative sum in int32 (exact: at most 255 * (T + 1)).  The last
        frame becomes the state's ``prev_frame``."""
        acc = torch.cat([state["prev_frame"], images]).to(torch.int32)
        frames = (acc.cumsum(0, dtype=torch.int32)[1:] % 256).to(torch.uint8)
        state["prev_frame"] = frames[-1:]
        return frames

    def _warp_normalize(self, image: torch.Tensor, warp_tf,
                        warp_out: Tuple[int, int]) -> torch.Tensor:
        """Device input warp (``deft_tpu/models/deft.py:390-401``): raw
        [B, H, W, 3] frames and the [6] separable inverse transform ->
        warped, normalized float32 [B, out_h, out_w, 3]."""
        _, h, w, _ = image.shape
        out_h, out_w = warp_out
        tf = tuple(float(v) for v in np.asarray(warp_tf, np.float32).ravel())
        key = (tf, h, w, out_h, out_w, image.device)
        hats = self._hats.get(key)
        if hats is None:
            if len(self._hats) >= 8:
                self._hats.clear()
            hats = (hat_matrix(tf[0], tf[2], out_w, w, image.device),
                    hat_matrix(tf[4], tf[5], out_h, h, image.device))
            self._hats[key] = hats
        # frame by frame: a frame's warp does not depend on its chunk
        warped = torch.cat([warp_affine_with(image[i: i + 1], *hats)
                            for i in range(image.shape[0])])
        return (warped / 255.0 - self.input_mean) / self.input_std

    def _sim_and_record(self, emb: torch.Tensor, n_valid: torch.Tensor,
                        state: Dict[str, torch.Tensor], sims_quant: bool,
                        sim_window: int = 0) -> torch.Tensor:
        """Window similarity of this frame's embeddings against the ring,
        then the conditional ring write (``deft_tpu/models/deft.py:319-368``;
        empty frames are not buffered).

        ``0 < sim_window < W`` compares against the ``sim_window`` freshest
        slots only, freshest first: slot ``(ptr - 1 - i) % W`` is row i.
        Returns the similarity as float16, or as uint8
        ``round(clip(s, 0, 1) * 255)`` under ``sims_quant``; ``state`` is
        updated in place."""
        m = self.max_object
        dev = emb.device
        emb = emb[:m] * (torch.arange(m, device=dev) < n_valid)[:, None].float()
        embeds, counts, ptr = state["embeds"], state["counts"], state["ptr"]
        w_slots = embeds.shape[0]
        if 0 < sim_window < w_slots:
            idx = (ptr - 1 - torch.arange(sim_window, device=dev)) % w_slots
            sims = self.window_similarity(embeds.index_select(0, idx),
                                          counts.index_select(0, idx), emb,
                                          n_valid)
        else:
            sims = self.window_similarity(embeds, counts, emb, n_valid)

        do = n_valid > 0
        slot = (ptr % w_slots).reshape(1)
        embeds.index_copy_(0, slot, torch.where(
            do, emb, embeds.index_select(0, slot)[0])[None])
        counts.index_copy_(0, slot, torch.where(
            do, n_valid.to(counts.dtype), counts.index_select(0, slot)))
        ptr.add_(do.to(ptr.dtype))
        if sims_quant:
            return torch.round(sims.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return sims.half()

    def _frame_tail(self, dets: Dict[str, torch.Tensor], emb: torch.Tensor,
                    state, out_thresh: float, class_filter: int,
                    sims_quant: bool, sim_window: int):
        """The tail shared by every frame program (``deft_tpu/models/
        deft.py:466-490``): dets [K, ...] and emb [K, E] of one frame ->
        (packed dets, sims); the ring in ``state`` is updated in place.

        Valid detections are the score-sorted prefix above ``out_thresh``,
        at most ``max_object``; with ``class_filter >= 0`` only that class,
        the embeddings stably compacted to the host's filtered order."""
        with self.spans.span("program.tail"):
            valid = dets["scores"] >= out_thresh
            if class_filter >= 0:
                valid = valid & (dets["clses"].int() == class_filter)
                order = torch.sort((~valid).int(), stable=True).indices
                emb = emb[order]
            n_valid = valid.sum().clamp(max=self.max_object).int()
            sims = self._sim_and_record(emb, n_valid, state, sims_quant,
                                        sim_window)
            kept = {k: v[None] for k, v in dets.items() if k in KEEP_DETS}
            return pack_dets(kept, n_valid), sims

    @torch.no_grad()
    def frame_step(self, image: torch.Tensor, state, out_thresh: float,
                   k: int = 100, class_filter: int = -1,
                   sims_quant: bool = False, sim_window: int = 0,
                   parity_tf=None, warp_tf=None, warp_out=None,
                   flip_test: bool = False, yuv_in: bool = False):
        """One frame of tracking on the device (``deft_tpu/models/
        deft.py:403-455``): image [1, H, W, 3] (raw uint8 with ``warp_tf``
        and ``warp_out``, else uint8 or normalized at the input size; a
        packed [1, H*3/2, W] with ``yuv_in``; a uint8 delta when ``state``
        holds ``prev_frame``) -> (packed dets, sims); the ring in ``state``
        is updated in place.  ``parity_tf`` and ``flip_test`` as
        ``detect``'s."""
        _check_wire(state, yuv_in, warp_tf)
        with self.spans.span("program.warp"):
            if warp_tf is not None:
                image = self._warp_normalize(image, warp_tf, warp_out)
            if "prev_frame" in state:
                image = self._rebuild_delta(image, state)
            image = self._decode_input(image, yuv_in)
        dets, emb = self.detect(image, k=k, parity_tf=parity_tf,
                                flip_test=flip_test)
        return self._frame_tail({key: v[0] for key, v in dets.items()},
                                emb[0], state, out_thresh, class_filter,
                                sims_quant, sim_window)

    @torch.no_grad()
    def frame_chunk(self, images: torch.Tensor, state, out_thresh: float,
                    k: int = 100, class_filter: int = -1,
                    sims_quant: bool = False, sim_window: int = 0,
                    parity_tf=None, warp_tf=None, warp_out=None,
                    flip_test: bool = False, yuv_in: bool = False):
        """``frame_step`` over a chunk [T, H, W, 3] in frame order
        (``deft_tpu/models/deft.py:492-523``; a loop where the JAX package
        scans), after one batched warp.  One ``parity_tf`` serves the chunk,
        which is exact under fix_res (one geometry for every frame).
        Returns (packed [T, L], sims [T, ...])."""
        _check_wire(state, yuv_in, warp_tf)
        if warp_tf is not None:
            with self.spans.span("program.warp"):
                images = self._warp_normalize(images, warp_tf, warp_out)
        outs = [self.frame_step(images[t: t + 1], state, out_thresh, k=k,
                                class_filter=class_filter,
                                sims_quant=sims_quant, sim_window=sim_window,
                                parity_tf=parity_tf, flip_test=flip_test,
                                yuv_in=yuv_in)
                for t in range(images.shape[0])]
        return _stack(outs)

    @torch.no_grad()
    def frame_chunk_batched(self, images: torch.Tensor, state,
                            out_thresh: float, k: int = 100,
                            class_filter: int = -1, sims_quant: bool = False,
                            sim_window: int = 0, parity_tf=None,
                            warp_tf=None, warp_out=None,
                            flip_test: bool = False, yuv_in: bool = False):
        """``frame_chunk`` with one batched ``detect`` over the chunk, then
        the tail per frame in frame order (``deft_tpu/models/
        deft.py:525-576``); delta frames are rebuilt, in order, before the
        batched forward."""
        _check_wire(state, yuv_in, warp_tf)
        with self.spans.span("program.warp"):
            if warp_tf is not None:
                images = self._warp_normalize(images, warp_tf, warp_out)
            if "prev_frame" in state:
                images = self._rebuild_delta(images, state)
            images = self._decode_input(images, yuv_in)
        dets, emb = self.detect(images, k=k, parity_tf=parity_tf,
                                flip_test=flip_test)
        outs = [self._frame_tail({key: v[t] for key, v in dets.items()},
                                 emb[t], state, out_thresh, class_filter,
                                 sims_quant, sim_window)
                for t in range(images.shape[0])]
        return _stack(outs)

    @torch.no_grad()
    def frame_step_embed(self, image: torch.Tensor, centers: torch.Tensor,
                         n_dets, state, sims_quant: bool = False,
                         sim_window: int = 0, warp_tf=None, warp_out=None):
        """One public-detection frame on the device (``deft_tpu/models/
        deft.py:370-388``): the trunk, the embeddings at the given centres,
        the similarity against the ring and the conditional ring write; no
        heads, no decode.  image as ``frame_step``'s; centers [max_object,
        2] in [-1, 1], zero-padded; n_dets an int or an int32 tensor, cut
        to max_object.  Returns the sims; the ring in ``state`` is updated
        in place (a frame of 0 detections is not written)."""
        if warp_tf is not None:
            with self.spans.span("program.warp"):
                image = self._warp_normalize(image, warp_tf, warp_out)
        emb = self.embed_image(image, centers[None])[0]
        with self.spans.span("program.tail"):
            if not torch.is_tensor(n_dets):
                n_dets = torch.full((), n_dets, dtype=torch.int32,
                                    device=emb.device)
            n_valid = n_dets.clamp(max=self.max_object).int()
            return self._sim_and_record(emb, n_valid, state, sims_quant,
                                        sim_window)


def _check_wire(state, yuv_in: bool, warp_tf):
    """The device warp takes raw frames: neither packed nor delta ones
    (``deft_tpu/models/deft.py:437-439, :557-559``)."""
    if warp_tf is not None and (yuv_in or "prev_frame" in state):
        raise ValueError("the device warp is exclusive with yuv and delta "
                         "uploads")


def _stack(outs: List[Tuple[torch.Tensor, torch.Tensor]]):
    """Per-frame (packed, sims) pairs -> (packed [T, L], sims [T, ...])."""
    return (torch.stack([p for p, _ in outs]),
            torch.stack([s for _, s in outs]))
