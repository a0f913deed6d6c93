"""The port's training samples and loader against the JAX package's, on the
CPU.

One ``tools/make_synthetic_mot.py`` sequence (``torch_port_recipes.
mot_dataset``), the MOT recipe's train flags (``--dataset_version
17trainval --ltrb_amodal --same_aug_pre --hm_disturb 0.05 --lost_disturb
0.4 --fp_disturb 0.1``, tracking, AFE) at 96x160, ``max_object`` 8.  Both packages' datasets and
loaders (``num_workers`` 1: in process, so the batches are a function of
the seeds) run from the same seeds of ``np.random`` and ``random``, and
must give:

* every target key equal (``hm``, ``ind``, ``mask``, ``cat``, ``reg``,
  ``wh``, ``tracking``, ``ltrb_amodal`` with their masks, the AFE
  ``centers_*``, ``labels`` and ``mask_*``): the same draws in the same
  order, the same float operations;
* the images (``image``, ``pre_img``, ``pre_image``) within the warp's one
  uint8 step carried through colour augmentation and normalization: the
  port warps with ``ops/warp.py::warp_affine_uint8`` where the JAX package
  calls ``cv2.warpAffine``; a step of 1/255 is scaled by at most
  1.4^3 + 2 x 0.4 x 1.4^2 < 4.4 by the three colour jitters (the input, its
  grayscale and the grayscale's mean) and divided by the smallest STD.

``warp_affine_uint8`` itself is held against ``cv2.warpAffine`` (one uint8
step, any rotation), and ``gaussian`` against the JAX copy.
"""

from __future__ import annotations

import random

import cv2
import numpy as np
import pytest

from torch_port_recipes import mot_dataset

from deft_tpu.cli import parse_config as jax_parse_config
from deft_tpu.data.datasets import get_dataset as jax_get_dataset
from deft_tpu.data.loader import DataLoader as JaxLoader
from deft_tpu.ops.affine import get_affine_transform
from deft_tpu.ops.gaussian import draw_gaussian as jax_draw_gaussian
from deft_tpu.ops.gaussian import gaussian_radius as jax_gaussian_radius
from deft_tpu_torch.cli import parse_config
from deft_tpu_torch.data.datasets import STD, get_dataset
from deft_tpu_torch.data.loader import DataLoader
from deft_tpu_torch.ops.gaussian import draw_gaussian, gaussian_radius
from deft_tpu_torch.ops.warp import warp_affine_uint8

ARGV = ["tracking", "--dataset", "mot", "--dataset_version", "17trainval",
        "--ltrb_amodal", "--same_aug_pre", "--hm_disturb", "0.05",
        "--lost_disturb", "0.4", "--fp_disturb", "0.1", "--input_h", "96",
        "--input_w", "160", "--max_object", "8", "--batch_size", "2"]
IMAGES = ("image", "pre_img", "pre_image")
IMAGE_BOUND = 4.4 / 255.0 / float(STD.min())
BATCHES = 3


def _batches(make, dataset_cls, cfg, data, seed):
    np.random.seed(seed)
    random.seed(seed)
    ds = dataset_cls(cfg, "train", data_dir=str(data))
    loader = make(ds, cfg.batch_size, num_workers=1, seed=cfg.seed)
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == BATCHES:
            break
    return out


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    data = mot_dataset(tmp_path_factory.mktemp("mot"), frames=12,
                       size=(320, 192))
    jcfg, _ = jax_parse_config(ARGV)
    pcfg, _ = parse_config(ARGV)
    want = _batches(JaxLoader, jax_get_dataset("mot"), jcfg, data, 5)
    got = _batches(DataLoader, get_dataset("mot"), pcfg, data, 5)
    return want, got


def test_batch_keys_and_shapes(batches):
    want, got = batches
    assert len(want) == len(got) == BATCHES
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k


def test_targets_equal(batches):
    """Every key but the images equal, bit for bit."""
    want, got = batches
    for w, g in zip(want, got):
        for k in w:
            if k not in IMAGES:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert w["mask"].sum() > 0 and w["labels"][:, :-1, :-1].sum() > 0


@pytest.mark.parametrize("key", IMAGES)
def test_images_within_one_warp_step(batches, key):
    want, got = batches
    for w, g in zip(want, got):
        err = np.abs(g[key] - w[key])
        assert err.max() <= IMAGE_BOUND, (key, err.max())
        # the warps differ in a few pixels only
        assert (err > 1e-5).mean() < 0.05, key


@pytest.mark.parametrize("rot", [0.0, 12.5])
@pytest.mark.parametrize("flip", [False, True])
def test_warp_matches_cv2(rot, flip):
    """``warp_affine_uint8`` within one uint8 step of ``cv2.warpAffine``
    (INTER_LINEAR, zeros outside), downscaled and upscaled crops, with and
    without rotation, on a flipped view as the dataset passes it."""
    rng = np.random.RandomState(int(rot * 10) + flip)
    img = rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
    if flip:
        img = img[:, ::-1, :]
    for scale in (0.7, 1.0, 1.6):
        c = np.array([100 + rng.randn() * 20, 60 + rng.randn() * 10],
                     np.float32)
        trans = get_affine_transform(c, 200 * scale, rot, [96, 64])
        want = cv2.warpAffine(img, trans, (96, 64), flags=cv2.INTER_LINEAR)
        got = warp_affine_uint8(img, trans, 96, 64)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1


def test_gaussian_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        h, w = rng.uniform(1, 60, 2)
        r = int(gaussian_radius((h, w)))
        assert r == int(jax_gaussian_radius((h, w)))
        a = np.zeros((40, 50), np.float32)
        b = np.zeros((40, 50), np.float32)
        ct = rng.randint(-3, 53, 2)
        k = rng.uniform(0.2, 1.0)
        draw_gaussian(a, ct, r, k)
        jax_draw_gaussian(b, ct, r, k)
        np.testing.assert_array_equal(a, b)
