"""Per-layer DCN offset statistics of a checkpoint, the counterpart of
``tools/measure_dcn_offsets.py``:

    python -m deft_tpu_torch.tools.measure_dcn_offsets \
        --load_model exp/tracking/e2e/model_last.pth \
        [--input_h 544 --input_w 960] [--frames 4] [--images DIR]

A forward hook on every DCNv2 ``conv_offset_mask`` records the offsets
while the trunk runs on ``--frames`` frames (smooth noise made from a seed,
or real frames of ``--images`` resized to the input), where the JAX tool
captures the same convs' outputs with ``capture_intermediates``.  Prints
one JSON line per layer: its JAX module path (the key of
``--dcn_layer_radii``), its feature map, |dy| and |dx| max and the mean over
frames of their 99.9th and 99th percentiles, and the smallest exact clamp
radius (the ceiling of the max).  Then the smallest exact global radius and
a ``--dcn_layer_radii`` value for the layers that need less than the
default 4 (``--radii_out FILE`` writes that JSON object to a file).

The checkpoint is a reference-layout ``.pth`` (``checkpoint.load_model``);
without ``--load_model`` the seeded weights are measured.  The model runs
on ``--device`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
DEFAULT_RADIUS = 4


def noise_frame(h: int, w: int, rng) -> np.ndarray:
    """Natural-ish uint8 frame: smooth low-frequency content and texture
    noise (``tools/measure_dcn_offsets.py:75-82``)."""
    base = rng.normal(0, 1, (h // 8, w // 8, 3))
    img = np.kron(base, np.ones((8, 8, 1)))
    img = img + rng.normal(0, 0.3, img.shape)
    return ((img - img.min()) / (np.ptp(img) + 1e-6) * 255).astype(np.uint8)


def probe_frames(n: int, h: int, w: int, images: str = "", seed: int = 0):
    """``n`` uint8 [h, w, 3] frames: ``noise_frame``s from ``seed``, or
    frames of ``images`` spread over the directory and resized."""
    if not images:
        rng = np.random.RandomState(seed)
        return [noise_frame(h, w, rng) for _ in range(n)]
    from deft_tpu_torch.data.image_io import imread
    from deft_tpu_torch.ops.warp import resize_linear

    paths = []
    for ext in ("*.png", "*.jpg", "*.jpeg"):
        paths += glob.glob(os.path.join(images, "**", ext), recursive=True)
    paths.sort()
    if not paths:
        raise SystemExit(f"no images under {images}")
    paths = paths[::max(len(paths) // n, 1)][:n]
    return [resize_linear(imread(paths[t % len(paths)]), w, h)
            for t in range(n)]


def jax_path(module_name: str) -> str:
    """The JAX module path of a port DCNv2 (``dla_up.ida_0.proj_1.conv`` ->
    ``trunk/dla_up/ida_0/proj_1/conv``), the key ``--dcn_layer_radii``
    matches (``models/dcn.py::resolve_radius``)."""
    return "trunk/" + module_name.replace(".", "/")


def measure(model, frames, device) -> dict:
    """{JAX path of the offset conv: {"shape", "absmax", "p999", "p99"}}
    over ``frames`` through ``model.trunk`` (normalized as the frame
    programs do)."""
    import torch

    from deft_tpu_torch.models.dcn import DCNv2

    stats: dict = {}
    current: dict = {}
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, DCNv2):
            key = "/" + jax_path(name) + "/conv_offset_mask"

            def hook(_mod, _args, out, key=key):
                current[key] = out.float().permute(0, 2, 3, 1).cpu().numpy()

            handles.append(mod.conv_offset_mask.register_forward_hook(hook))
    try:
        with torch.no_grad():
            for img in frames:
                x = torch.from_numpy(
                    (img.astype(np.float32) / 255.0 - MEAN) / STD)[None]
                current.clear()
                model.trunk(x.to(device))
                for key, om in current.items():
                    kk = om.shape[-1] // 3
                    a = np.abs(om[..., : 2 * kk])
                    s = stats.setdefault(key, {"shape": list(om.shape),
                                               "absmax": 0.0, "p999": [],
                                               "p99": []})
                    s["absmax"] = max(s["absmax"], float(a.max()))
                    s["p999"].append(float(np.percentile(a, 99.9)))
                    s["p99"].append(float(np.percentile(a, 99.0)))
    finally:
        for h in handles:
            h.remove()
    return stats


def summarize(stats: dict) -> list:
    """One row per layer, in path order (``tools/measure_dcn_offsets.py:
    125-135``)."""
    return [{"layer": key, "fmap": s["shape"][1:3],
             "absmax": round(s["absmax"], 3),
             "p99.9": round(float(np.mean(s["p999"])), 3),
             "p99": round(float(np.mean(s["p99"])), 3),
             "exact_radius": int(np.ceil(s["absmax"]))}
            for key, s in sorted(stats.items())]


def layer_radii(rows: list) -> dict:
    """The ``--dcn_layer_radii`` object: each layer whose exact radius is
    below the default, at that radius (at least 1)."""
    radii = {}
    for row in rows:
        pat = row["layer"].lstrip("/")
        if pat.endswith("/conv_offset_mask"):
            pat = pat[: -len("/conv_offset_mask")]
        if row["exact_radius"] < DEFAULT_RADIUS:
            radii[pat] = max(row["exact_radius"], 1)
    return radii


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load_model", default="",
                    help="a reference-layout .pth (else seeded weights)")
    ap.add_argument("--input_h", type=int, default=544)
    ap.add_argument("--input_w", type=int, default=960)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--arch", default="dla_34")
    ap.add_argument("--images", default="",
                    help="directory of real frames (png/jpg) to probe with "
                         "instead of synthetic noise")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--radii_out", default="",
                    help="write the --dcn_layer_radii object to this file")
    args = ap.parse_args(argv)

    from deft_tpu_torch.checkpoint import load_model
    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.models.factory import create_model, resolve_device

    device = resolve_device(args.device)
    cfg = mot_config(input_h=args.input_h, input_w=args.input_w,
                     dla_node="dcn", arch=args.arch)
    model = create_model(cfg.arch, cfg, device).eval()
    if args.load_model:
        load_model(model, args.load_model)
    frames = probe_frames(args.frames, args.input_h, args.input_w,
                          args.images)
    rows = summarize(measure(model, frames, device))
    for row in rows:
        print(json.dumps(row))
    radii = layer_radii(rows)
    if rows:
        print("# smallest exact global radius for this checkpoint: "
              f"{max(r['exact_radius'] for r in rows)}")
    if radii:
        print(f"# --dcn_layer_radii '{json.dumps(radii)}'")
    if args.radii_out:
        with open(args.radii_out, "w") as f:
            json.dump(radii, f)
    return {"layers": rows, "radii": radii}


if __name__ == "__main__":
    main()
