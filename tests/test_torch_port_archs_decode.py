"""The decode heads of the generic detectors and keypoint post-processing
against the JAX package's ``generic_decode`` and ``generic_post_process``
on the CPU.

Random head maps from a seed (16x24, K 10, 17 joints): the category-specific
``wh`` (2 x 3 classes), ``ltrb``, ``hps`` with ``hm_hp`` and ``hp_offset``
(or ``reg``, or neither: the 0.5 shift), with and without boxes (the
keypoints' own extent then bounds them), and ``pre_inds``.  Scores,
indices and classes come out equal; every float within 1e-5 (the same
float32 arithmetic in another order).  Post-processing maps each keypoint
through the inverse affine as the JAX package does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.inference.post_process import \
    generic_post_process as jax_post_process
from deft_tpu.ops.decode import generic_decode as jax_decode
from deft_tpu_torch.inference.post_process import generic_post_process
from deft_tpu_torch.ops.decode import generic_decode

H, W, K, J, CLASSES = 16, 24, 10, 17, 3

CASES = {
    "cat_wh": ("hm", "reg", "wh6"),
    "ltrb": ("hm", "reg", "wh", "ltrb"),
    "hps_offset": ("hm", "reg", "wh", "hps", "hm_hp", "hp_offset"),
    "hps_reg": ("hm", "reg", "ltrb", "hps", "hm_hp"),
    "hps_no_box": ("hm", "hps", "hm_hp"),
    "hps_alone": ("hm", "reg", "wh", "hps"),
    "pre_inds": ("hm", "reg", "wh", "tracking", "pre_inds"),
}


def heads(names, seed=0, classes=CLASSES):
    """Seeded head maps [1, H, W, C] (sigmoids where the decode takes
    them), keypoint offsets spread over a few cells."""
    rng = np.random.RandomState(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))          # noqa: E731
    maps = {}
    for name in names:
        if name == "hm":
            maps[name] = sig(rng.randn(1, H, W, classes) * 2 - 1)
        elif name == "hm_hp":
            maps[name] = sig(rng.randn(1, H, W, J) * 2 - 1)
        elif name == "wh6":
            maps["wh"] = rng.uniform(-1, 8, (1, H, W, 2 * classes))
        elif name == "wh":
            maps[name] = rng.uniform(-1, 8, (1, H, W, 2))
        elif name == "ltrb":
            maps[name] = rng.uniform(-4, 4, (1, H, W, 4))
        elif name == "hps":
            maps[name] = rng.uniform(-3, 3, (1, H, W, 2 * J))
        elif name == "pre_inds":
            maps[name] = rng.randint(0, H * W, (1, K)).astype(np.int32)
        else:
            maps[name] = rng.uniform(-1, 1, (1, H, W,
                                             {"reg": 2, "hp_offset": 2,
                                              "tracking": 2}[name]))
    return {k: (v if k == "pre_inds" else v.astype(np.float32))
            for k, v in maps.items()}


def decode_both(maps):
    want = {k: np.asarray(v) for k, v in jax_decode(
        {k: jnp.asarray(v) for k, v in maps.items()}, k=K).items()}
    got = {k: v.numpy() for k, v in generic_decode(
        {k: torch.from_numpy(v) for k, v in maps.items()}, k=K).items()}
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(case):
    got, want = decode_both(heads(CASES[case]))
    if "hm_hp" not in CASES[case] and "hps" in CASES[case]:
        # the JAX package sets kps_score to the keypoints there (ROADMAP
        # C.3); the port leaves it out
        assert "kps_score" not in got
        want.pop("kps_score")
    assert set(got) == set(want)
    for key in ("scores", "inds", "clses"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    if "hm_hp" in CASES[case]:
        # some keypoints snap to a peak, some keep their regression
        maps = heads(CASES[case])
        raw = (maps["hps"].reshape(H * W, J, 2)[got["inds"][0]]
               + got["cts"][0][:, None, :]).reshape(1, K, 2 * J)
        kept = np.isclose(got["hps"], raw, rtol=0, atol=1e-5)
        assert 0 < kept.mean() < 1


def test_category_wh_picks_the_class_pair():
    maps = heads(CASES["cat_wh"], seed=3)
    got, _ = decode_both(maps)
    cls = got["clses"][0].astype(int)
    ind = got["inds"][0]
    wh = maps["wh"].reshape(H * W, CLASSES, 2)[ind, cls].clip(min=0)
    np.testing.assert_allclose(got["bboxes"][0, :, 2] - got["bboxes"][0, :, 0],
                               wh[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["hps_offset", "ltrb"])
def test_post_process_matches_jax(case):
    got, want = decode_both(heads(CASES[case], seed=1))
    c, s = np.array([50.0, 30.0], np.float32), 110.0
    kw = dict(out_h=H, out_w=W, out_thresh=0.3)
    p = generic_post_process(got, [c], [s], **kw)[0]
    j = jax_post_process(want, [c], [s], **kw)[0]
    assert len(p) == len(j) > 0
    for a, b in zip(p, j):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-4,
                                       err_msg=key)
    if case == "hps_offset":
        assert p[0]["hps"].shape == (2 * J,)
