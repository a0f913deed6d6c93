"""Shared by the port's CLI and test-entry tests: the recipes' command
lines, tiny datasets laid out by the repo's own tools, and seeded port
checkpoints.

* ``ROOT``, ``recipe_lines`` and ``recipe_test_argv``, from
  ``recipe_lines.py``;
* ``mot_dataset``, ``kitti_dataset``, ``nuscenes_dataset``: the synthetic
  generators of ``tools/`` plus their COCO converters, in a directory;
* ``seeded_checkpoint``: the port's seeded network with randomized offset
  convs, box heads biased to an extent and its heatmap rescaled on a frame
  so that detections exist, saved as a reference ``.pth``;
  ``motion_checkpoint``: the LSTM motion model's, from the JAX package's
  seeded ``LSTMMotion`` (``from_jax_motion_variables``).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from recipe_lines import ROOT, recipe_lines, recipe_test_argv  # noqa: F401

for _p in (str(ROOT), str(ROOT / "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


# ---- datasets ---------------------------------------------------------------

def _noisy(paths, seed):
    """Add N(0, 12) noise to each image file in place (re-encoded by cv2):
    flat regions otherwise make heatmap plateaus whose peaks tie."""
    import cv2

    rng = np.random.RandomState(seed)
    for path in paths:
        img = cv2.imread(str(path)).astype(np.float32)
        img += rng.normal(0, 12, img.shape)
        cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8))


def mot_dataset(root: Path, frames: int = 16, size=(192, 128)) -> Path:
    """``data_dir/mot17``: one sequence of ``tools/make_synthetic_mot.py``
    (JPEG), then ``convert_mot_to_coco.py`` (half split)."""
    from convert_mot_to_coco import convert
    from make_synthetic_mot import make_sequence

    data = root / "mot17"
    make_sequence(str(data / "train"), "SYN-01", n_frames=frames,
                  w=size[0], h=size[1], n_obj=4, seed=1)
    _noisy(sorted((data / "train" / "SYN-01" / "img1").glob("*.jpg")), 2)
    convert(str(data), "train", half=True)
    return data


def kitti_dataset(root: Path, frames: int = 16) -> Path:
    """``data_dir/kitti_tracking``: one sequence of
    ``tools/make_synthetic_kitti.py`` (PNG, 512x160), then
    ``convert_kittitrack_to_coco.py`` (half split)."""
    from convert_kittitrack_to_coco import convert
    from make_synthetic_kitti import make_sequence

    data = root / "kitti_tracking"
    make_sequence(str(data), "0000", n_frames=frames, seed=3)
    _noisy(sorted((data / "data_tracking_image_2" / "training" / "image_02"
                   / "0000").glob("*.png")), 4)
    convert(str(data), "train")
    return data


def nuscenes_dataset(root: Path, samples: int = 2, size=(96, 64)) -> Path:
    """``data_dir/nuscenes``: ``tools/make_synthetic_nuscenes.py`` (two
    cameras, frames at the test's input size, so that the JAX package's
    cv2 warp and the port's device warp are both the identity), then
    ``convert_nuscenes.py`` into ``annotations/val.json``."""
    from convert_nuscenes import convert
    from make_synthetic_nuscenes import generate

    data = root / "nuscenes"
    generate(str(data), n_samples=samples, width=size[0], height=size[1])
    _noisy(sorted((data / "v1.0-trainval" / "samples").rglob("*.jpg")), 5)
    convert(str(data), "v1.0-trainval", "val.json")
    return data


# ---- checkpoints ------------------------------------------------------------

BOX_BIAS = {"ltrb_amodal": [-4.0, -4.0, 4.0, 4.0], "wh": [8.0, 8.0],
            "dim": [1.6, 1.9, 4.5], "dep": [-3.0]}


@torch.no_grad()
def seeded_checkpoint(cfg, frame: np.ndarray, path: Path, seed: int = 0,
                      top: float = 4.0) -> Dict[str, torch.Tensor]:
    """The port's seeded network for ``cfg`` (float32) with every offset
    conv randomized, the box heads' biases shifted by ``BOX_BIAS`` (a box
    of zero extent ties every IoU) and each heatmap class rescaled so that
    its ``top`` percent of ``frame``'s pixels score above 0.5 with logits
    of std 2; saved to ``path`` as ``{"epoch", "state_dict"}``.  Returns
    the state_dict."""
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.models.dcn import DCNv2

    det = Detector(cfg.replace(compute_dtype="float32", load_model="",
                               load_model_traj=""), device="cpu")
    model = det.model
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DCNv2):
            om = m.conv_offset_mask
            om.weight.copy_(torch.randn(om.weight.shape, generator=gen) * 0.01)
            om.bias.copy_(torch.rand(om.bias.shape, generator=gen) * 2 - 1)
    for head, bias in BOX_BIAS.items():
        if head in cfg.heads:
            getattr(model, head)[-1].bias.add_(torch.tensor(bias))
    images, _ = det.pre_process(frame)
    z = model(images)[0]["hm"].reshape(-1, cfg.heads["hm"])
    out = model.hm[-1]
    gain = 2.0 / z.std(dim=0)
    cut = torch.quantile(z, 1.0 - top / 100.0, dim=0)
    out.weight.mul_(gain[:, None, None, None])
    out.bias.copy_((out.bias - cut) * gain)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "state_dict": sd}, path)
    return sd


def motion_checkpoint(dataset: str, path: Path) -> None:
    """The JAX package's seeded ``LSTMMotion(dataset)`` as a reference
    ``DecoderRNN`` ``.pth``."""
    import jax

    from deft_tpu.tracking.motion_lstm import LSTMMotion
    from deft_tpu_torch.convert import from_jax_motion_variables

    variables = jax.tree.map(np.asarray, LSTMMotion(dataset).variables)
    torch.save(from_jax_motion_variables(variables), path)


def first_frame(data: Path, ann: str, img_dir: str) -> np.ndarray:
    """The first image of an annotation file, read with cv2."""
    import json

    import cv2

    with open(data / "annotations" / ann) as f:
        info = json.load(f)["images"][0]
    return cv2.imread(os.path.join(data, img_dir, info["file_name"]))
