"""The PyTorch port's DEFTNet vs the JAX package's, on the CPU.

Weights go JAX ``init_model`` -> (every leaf perturbed, offsets randomized)
-> numpy -> ``deft_tpu_torch.convert.from_jax_variables`` -> the port.  The
same seeded numpy inputs then go through both networks.  64x64 input,
max_object 8, K 16, dcn_offset_range 1 (the JAX compile time grows with the
radius); ``dla_node="dcn"`` runs the JAX hybrid DCN, i.e. ``deform_conv_onehot``
on the CPU, against the port's plain DCN.

Tolerance for fp32 modules: rtol 1e-4, atol 1e-4 * max|ref| (convolutions
and reductions sum in another order in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deft_tpu.config import mot_config
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.models.factory import create_model

SIZE = dict(input_h=64, input_w=64, max_object=8, K=16, dcn_offset_range=1)


def _close(got, ref, what, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=1e-4 * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def jax_variables(cfg, seed):
    """JAX init with every leaf perturbed (so a leaf the converters drop
    cannot come back equal to its fresh init) and DCN offsets randomized so
    they are fractional and reach past the radius."""
    model = jax_create_model(cfg.arch, cfg)
    params, stats = jax_init_model(model, cfg)
    rng = np.random.RandomState(seed)
    out = {"params": {}, "batch_stats": {}}
    for kind, tree in (("params", params), ("batch_stats", stats)):
        for path, v in _leaves(jax.tree.map(np.asarray, tree)):
            name = path[-1]
            if "conv_offset_mask" in path:
                v = (rng.normal(0, 0.01, v.shape) if name == "kernel"
                     else rng.uniform(-1.0, 1.0, v.shape))
            elif name in ("scale", "var"):
                v = rng.uniform(0.8, 1.2, v.shape)
            elif name in ("bias", "mean"):
                v = v + rng.normal(0, 0.05, v.shape)
            else:
                v = v * rng.uniform(0.9, 1.1, v.shape)
            _set(out[kind], path, np.asarray(v, np.float32))
    return model, out


def raise_heatmap(model, variables, image):
    """Rescale the heatmap head so that ~10% of this image's pixels score
    above 0.5 with logits of std 2 (random weights give a flat heatmap far
    below the 0.4 threshold)."""
    out, _ = model.apply(variables, jnp.asarray(image), train=False)
    z = np.asarray(out["hm"])
    gain = 2.0 / z.std()
    hm = variables["params"]["head_hm"]["out"]
    hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
    hm["bias"] = ((hm["bias"] - np.percentile(z, 90)) * gain).astype(np.float32)


@pytest.fixture(scope="module", params=["conv", "dcn"])
def nets(request):
    cfg = mot_config(dla_node=request.param, **SIZE)
    model, variables = jax_variables(cfg, seed=1)
    raise_heatmap(model, variables, _image(3))
    sd = from_jax_variables(variables, cfg)
    port = create_model(cfg.arch, port_mot_config(dla_node=request.param,
                                                  **SIZE), "cpu")
    port.load_state_dict(sd)
    return cfg, model, variables, sd, port


def _image(seed):
    return np.random.RandomState(seed).randn(1, 64, 64, 3).astype(np.float32)


def test_conversion_round_trip(nets):
    """from_jax_variables is the exact inverse of the JAX package's torch
    converter: every leaf comes back bit-identical and none is unused."""
    from deft_tpu.train.torch_convert import TorchConverter, convert_torch_checkpoint

    cfg, _, variables, sd, _ = nets
    sd_np = {k: v.numpy() for k, v in sd.items()}
    conv = TorchConverter(cfg.dataset)
    params_t, stats_t = conv.convert_dla34(sd_np, cfg.heads, cfg.dla_node)
    assert conv.unused == []
    for kind, tree in (("params", params_t), ("batch_stats", stats_t)):
        got = dict(_leaves(tree))
        ref = dict(_leaves(variables[kind]))
        assert set(got) == set(ref), kind
        for path, v in ref.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    if cfg.dla_node == "dcn":
        back = convert_torch_checkpoint(sd_np, cfg)
        for kind in ("params", "batch_stats"):
            for path, v in _leaves(variables[kind]):
                got = dict(_leaves(back[kind]))[path]
                np.testing.assert_array_equal(got, v, err_msg=str(path))


def test_forward_heads_and_feature_maps(nets):
    cfg, model, variables, _, port = nets
    x = _image(2)
    j_out, j_fmaps = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_out, t_fmaps = port(torch.from_numpy(x))
    assert len(t_fmaps) == 13
    for i, (tf, jf) in enumerate(zip(t_fmaps, j_fmaps)):
        _close(tf.permute(0, 2, 3, 1).numpy(), jf, f"feature map {i}")
    assert set(t_out) == set(cfg.heads)
    for h in cfg.heads:
        _close(t_out[h].numpy(), j_out[h], f"head {h}")


def test_detect(nets):
    """The valid (score >= out_thresh) detections and the embeddings sampled
    at them.  Rows are matched by their heatmap index, so two valid scores
    that tie within the tolerance may come back in either order."""
    cfg, model, variables, _, port = nets
    x = _image(3)
    j_dets, j_emb = model.apply(variables, jnp.asarray(x), k=cfg.K,
                                method="detect")
    with torch.no_grad():
        t_dets, t_emb = port.detect(torch.from_numpy(x), k=cfg.K)
    scores = np.asarray(j_dets["scores"])[0]
    valid = scores >= cfg.out_thresh
    n = int(valid.sum())
    assert 3 <= n < cfg.K, n
    # no score sits within 10x the tolerance of the threshold
    assert np.abs(scores - cfg.out_thresh).min() > 1e-3
    t_n = int((t_dets["scores"][0] >= cfg.out_thresh).sum())
    assert t_n == n
    j_order = np.argsort(np.asarray(j_dets["inds"])[0, :n])
    t_order = np.argsort(t_dets["inds"][0, :n].numpy())
    np.testing.assert_array_equal(t_dets["inds"][0, :n].numpy()[t_order],
                                  np.asarray(j_dets["inds"])[0, :n][j_order])
    for key in ("scores", "clses", "cts", "bboxes", "tracking",
                "bboxes_amodal"):
        _close(t_dets[key][0, :n].numpy()[t_order],
               np.asarray(j_dets[key])[0, :n][j_order], f"dets[{key}]")
    _close(t_emb[0, :n].numpy()[t_order], np.asarray(j_emb)[0, :n][j_order],
           "embeddings")


def test_afe_extract_and_affinity(nets):
    """extract on the same feature maps and centers; the split-first-layer
    affinity on the same embeddings."""
    _, model, variables, _, port = nets
    rng = np.random.RandomState(4)
    _, j_fmaps = model.apply(variables, jnp.asarray(_image(5)), train=False)
    fmaps = [np.array(f) for f in j_fmaps]
    centers = rng.uniform(-1.1, 1.1, (1, 8, 2)).astype(np.float32)
    j_e = model.apply(variables, [jnp.asarray(f) for f in fmaps],
                      jnp.asarray(centers), method="extract")
    with torch.no_grad():
        t_e = port.extract([torch.from_numpy(f).permute(0, 3, 1, 2)
                            for f in fmaps], torch.from_numpy(centers))
    _close(t_e.numpy(), j_e, "extract")

    e1 = rng.randn(1, 8, 416).astype(np.float32)
    e2 = rng.randn(1, 6, 416).astype(np.float32)
    j_aff = model.apply(variables, jnp.asarray(e1), jnp.asarray(e2),
                        method=lambda m, a, b: m.afe.affinity(a, b))
    with torch.no_grad():
        t_aff = port.AFE.affinity(torch.from_numpy(e1), torch.from_numpy(e2))
    _close(t_aff.numpy(), j_aff, "affinity")


@pytest.mark.parametrize("n_pre,n_next", [(0, 5), (3, 0), (8, 8), (5, 3)])
def test_afe_similarity(nets, n_pre, n_next):
    """stacker_features and the batched window_similarity, with the valid
    counts at 0 and at max_object."""
    _, model, variables, _, port = nets
    rng = np.random.RandomState(6 + n_pre + 10 * n_next)
    ids = np.arange(8)
    e_pre = rng.randn(8, 416).astype(np.float32) * (ids < n_pre)[:, None]
    e_next = rng.randn(8, 416).astype(np.float32) * (ids < n_next)[:, None]
    j_s = model.apply(variables, jnp.asarray(e_pre), jnp.asarray(e_next),
                      jnp.int32(n_pre), jnp.int32(n_next),
                      method="stacker_features")
    with torch.no_grad():
        t_s = port.AFE.stacker_features(torch.from_numpy(e_pre),
                                        torch.from_numpy(e_next), n_pre, n_next)
    _close(t_s.numpy(), j_s, "stacker_features")

    win = rng.randn(4, 8, 416).astype(np.float32)
    counts = np.array([n_pre, 0, 8, 2], np.int32)
    win *= (ids[None, :] < counts[:, None])[..., None]
    j_w = model.apply(variables, jnp.asarray(win), jnp.asarray(counts),
                      jnp.asarray(e_next), jnp.int32(n_next),
                      method="window_similarity")
    with torch.no_grad():
        t_w = port.window_similarity(torch.from_numpy(win),
                                     torch.from_numpy(counts),
                                     torch.from_numpy(e_next), n_next)
    assert t_w.shape == (4, 8, 9)
    _close(t_w.numpy(), j_w, "window_similarity")
