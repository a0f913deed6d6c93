"""The bench entry point and the offset tool, on the CPU:

* ``bench.main(["--smoke"])`` prints ONE JSON line on stdout with the JAX
  bench's keys (read from the root ``bench.py``'s source) less
  ``vs_baseline``, ``device_ms`` and ``mfu`` (the port's come from a
  ``--profile`` trace, and there is no peak for a CPU); its ``#`` lines go
  to stderr, the launches among them;
* ``measure_dcn_offsets``: per layer, the |offset| maxima and percentiles of
  the port's forward hooks against the JAX model's
  ``capture_intermediates`` on the same seeded weights (the offset convs
  randomized so that offsets reach past one pixel), with the same layer
  keys; its ``--dcn_layer_radii`` value builds a model whose DCN layers take
  those radii.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deft_tpu_torch import bench
from deft_tpu_torch.tools import measure_dcn_offsets as M

ROOT = Path(__file__).resolve().parents[1]
OFFSET_TOL = 1e-4          # pixels: float32 sums in another order
ROUNDING = 5e-4            # the tool's rows keep 3 decimals


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_bench_keys():
    """The keys the root bench's JSON line always has, and those it adds
    with a chunk above 1 (the ``out[...] =`` assignments)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    always, added = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "out" for t in node.targets)):
            always |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", "") == "out"
                and isinstance(node.targets[0].slice, ast.Constant)):
            added.add(node.targets[0].slice.value)
    return always, added


def test_bench_smoke_json_line(capsys):
    out = bench.main(["--smoke"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == out
    always, added = jax_bench_keys()
    assert "vs_baseline" in always and {"mfu", "device_ms"} <= added
    want = (always | added) - {"vs_baseline", "mfu", "device_ms"}
    assert want <= set(out), want - set(out)
    assert not {"vs_baseline", "mfu", "device_ms",
                "device_busy_ms_per_frame"} & set(out)
    assert out["metric"] == "e2e_mot17_tracking_fps_per_chip"
    assert out["value"] > 0
    assert {"t_warp_ms", "t_dispatch_ms", "t_cascade_ms"} <= set(out)
    assert "# launches over the timed passes (12 frames)" in captured.err
    assert "# no mfu" in captured.err


def randomized_state(cfg):
    from deft_tpu_torch.models.factory import create_model

    torch.manual_seed(0)
    model = create_model(cfg.arch, cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                scale = 0.01 if name.endswith("weight") else 0.8
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return model


def test_measure_dcn_offsets_matches_jax():
    import jax.numpy as jnp

    from deft_tpu.config import mot_config as jax_mot_config
    from deft_tpu.models import create_model as jax_create_model
    from deft_tpu.models.dla import DLA_PLANS
    from deft_tpu.train.torch_convert import TorchConverter
    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.models.factory import create_model

    size = dict(input_h=64, input_w=96, max_object=8, K=16, dla_node="dcn")
    cfg, jcfg = mot_config(**size), jax_mot_config(**size)
    model = randomized_state(cfg).eval()
    frames = M.probe_frames(2, 64, 96)
    rows = M.summarize(M.measure(model, frames, torch.device("cpu")))

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = TorchConverter(jcfg.dataset).convert_dla34(
        sd, jcfg.heads, "dcn", DLA_PLANS["34"][0])
    jmodel = jax_create_model(jcfg.arch, jcfg)
    want = {}
    for img in frames:
        x = jnp.asarray((img.astype(np.float32) / 255.0 - M.MEAN) / M.STD)
        _, inter = jmodel.apply(
            {"params": params, "batch_stats": stats}, x[None],
            method="img2feats",
            capture_intermediates=lambda mdl, name:
                getattr(mdl, "name", "") == "conv_offset_mask")

        def walk(tree, path=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from walk(v, f"{path}/{k}")
            elif isinstance(tree, tuple):
                for v in tree:
                    yield path, v

        for path, om in walk(inter["intermediates"]):
            a = np.abs(np.asarray(om, np.float32)[..., :18])
            key = path.replace("/__call__", "")
            w = want.setdefault(key, {"absmax": 0.0, "p99": []})
            w["absmax"] = max(w["absmax"], float(a.max()))
            w["p99"].append(float(np.percentile(a, 99.0)))
    assert [r["layer"] for r in rows] == sorted(want)
    assert len(rows) == 16
    for r in rows:
        w = want[r["layer"]]
        assert abs(r["absmax"] - w["absmax"]) <= OFFSET_TOL + ROUNDING, r
        assert abs(r["p99"] - np.mean(w["p99"])) <= OFFSET_TOL + ROUNDING, r
    assert max(r["absmax"] for r in rows) > 1.0

    radii = M.layer_radii(rows)
    assert radii and all(1 <= v < M.DEFAULT_RADIUS for v in radii.values())
    built = create_model(cfg.arch, mot_config(
        **size, dcn_layer_radii=json.dumps(radii)), "cpu")
    from deft_tpu_torch.models.dcn import DCNv2

    for name, mod in built.named_modules():
        if isinstance(mod, DCNv2):
            assert mod.radius == radii.get(M.jax_path(name),
                                           M.DEFAULT_RADIUS), name


def test_measure_dcn_offsets_main_loads_a_pth(tmp_path, capsys):
    from deft_tpu_torch.config import mot_config

    size = dict(input_h=64, input_w=96, max_object=8, K=16)
    model = randomized_state(mot_config(**size))
    path = tmp_path / "model_last.pth"
    torch.save({"epoch": 1, "state_dict": model.state_dict()}, path)
    out = M.main(["--load_model", str(path), "--input_h", "64", "--input_w",
                  "96", "--frames", "1", "--device", "cpu", "--radii_out",
                  str(tmp_path / "radii.json")])
    rows = M.summarize(M.measure(model.eval(), M.probe_frames(1, 64, 96),
                                 torch.device("cpu")))
    assert out["layers"] == rows
    assert json.loads((tmp_path / "radii.json").read_text()) == out["radii"]
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in printed[: len(rows)]] == rows
