"""Input-pipeline throughput of the port: ``DataLoader`` samples/s against
the train step's demand, the counterpart of ``tools/bench_loader.py``:

    python -m deft_tpu_torch.tools.bench_loader [--h 544 --w 960] \
        [--batch 32] [--steps 8] [--workers 1,4,8,16] [--skip-step] \
        [--data_dir DIR]

Over a MOT17-layout dataset (``--data_dir``, whose
``annotations/train.json`` the ``17trainval`` split reads; else a
synthetic one written to a temporary directory: two sequences of 1080x1920
PNG frames of moving rectangles with their ground truth), it measures
(a) the port's ``DataLoader`` in samples/s for each worker count of
``--workers`` (0 and 1 load in process) over the first ``--frames``
samples, one batch warmed first, and
(b) unless ``--skip-step``, the port's training step (``Trainer``) at the
same batch on the card: the seeded model at ``--dla_node`` (dcn: T4 or T1
forward, T5 backward), median ms of ``--steps`` steps after one warm-up
step, and the peak device memory.  Prints one JSON line: ``value`` is the
best loader rate; ``loader_bound`` says whether it falls below the step's
demand.  The default batch of 32 is the JAX tool's, sized for an 8-chip
mesh; one card holds the batch its memory allows, which the line reports
as ``peak_device_bytes``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def synthetic_mot(root: Path, n_frames: int, size=(1080, 1920),
                  seqs: int = 2, n_obj: int = 24) -> Path:
    """``seqs`` sequences of ``n_frames // seqs`` frames as ``mot17/``:
    ``train/SYN-0k/img1/*.png``, ``gt/gt.txt`` and ``annotations/train.json``
    (``tools/convert_mot_to_coco.py``'s format)."""
    from deft_tpu_torch.data.image_io import imwrite_png

    h, w = size
    data = root / "mot17"
    images, anns = [], []
    for v in range(1, seqs + 1):
        rng = np.random.RandomState(v)
        name = f"SYN-{v:02d}"
        seq = data / "train" / name
        (seq / "img1").mkdir(parents=True, exist_ok=True)
        (seq / "gt").mkdir(parents=True, exist_ok=True)
        bh = rng.randint(h // 10, h // 3, n_obj)
        bw = np.maximum(bh // 2, 8)
        pos = rng.uniform(0, 1, (n_obj, 2)) * [h - bh.max(), w - bw.max()]
        vel = rng.uniform(-4, 4, (n_obj, 2))
        colours = rng.randint(60, 256, (n_obj, 3))
        rows = []
        for f in range(1, n_frames // seqs + 1):
            img = np.full((h, w, 3), 40, np.uint8)
            image_id = len(images) + 1
            for i in range(n_obj):
                y, x = (pos[i] + vel[i] * f).astype(int)
                y = int(np.clip(y, 0, h - bh[i]))
                x = int(np.clip(x, 0, w - bw[i]))
                img[y: y + bh[i], x: x + bw[i]] = colours[i]
                rows.append(f"{f},{i + 1},{x},{y},{bw[i]},{bh[i]},1,1,1")
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": 1,
                             "bbox": [float(x), float(y), float(bw[i]),
                                      float(bh[i])],
                             "area": float(bw[i] * bh[i]), "iscrowd": 0,
                             "track_id": i + 1, "conf": 1.0})
            imwrite_png(str(seq / "img1" / f"{f:06d}.png"), img)
            images.append({"id": image_id,
                           "file_name": f"{name}/img1/{f:06d}.png",
                           "video_id": v, "frame_id": f, "height": h,
                           "width": w})
        (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
    ann = {"images": images, "annotations": anns,
           "videos": [{"id": v, "file_name": f"SYN-{v:02d}"}
                      for v in range(1, seqs + 1)],
           "categories": [{"id": 1, "name": "pedestrian"}]}
    (data / "annotations").mkdir(parents=True, exist_ok=True)
    (data / "annotations" / "train.json").write_text(json.dumps(ann))
    return data


def loader_rate(ds, batch: int, workers: int) -> float:
    """Samples/s of one pass of ``DataLoader(ds, batch, workers)`` after a
    warm batch."""
    from deft_tpu_torch.data.loader import DataLoader

    loader = DataLoader(ds, batch, num_workers=workers, seed=0)
    try:
        next(iter(loader))
        t0 = time.perf_counter()
        count = 0
        for b in loader:
            count += b["image"].shape[0]
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    _log(f"# loader workers={workers}: {count} samples in {dt:.2f}s -> "
         f"{count / dt:.1f} samples/s")
    return count / dt


def step_times(cfg, ds, batch: int, steps: int, device) -> dict:
    """Median ms of ``steps`` training steps at ``batch`` after a warm one,
    and the peak device memory."""
    import torch

    from deft_tpu_torch.data.loader import DataLoader
    from deft_tpu_torch.models.factory import create_model
    from deft_tpu_torch.train.trainer import (Trainer, to_device,
                                              training_keys)

    loader = DataLoader(ds, batch, num_workers=1, seed=0)
    host = next(iter(loader))
    trainer = Trainer(create_model(cfg.arch, cfg, device), cfg)
    data = to_device(host, training_keys(host, cfg), device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer.train_step(data)                   # builds the kernels
    times = []
    for _ in range(steps):
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        trainer.train_step(data)               # ends in a host read
        times.append((time.perf_counter() - t0) * 1000.0)
    out = {"train_step_ms": statistics.median(times)}
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=544)
    ap.add_argument("--w", type=int, default=960)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--frames", type=int, default=96,
                    help="synthetic frames to write, and the samples "
                         "measured")
    ap.add_argument("--workers", type=str, default="1,4,8,16")
    ap.add_argument("--skip-step", action="store_true")
    ap.add_argument("--data_dir", type=str, default="",
                    help="an existing MOT17 layout with annotations/"
                         "train.json")
    ap.add_argument("--frame_size", type=str, default="1080x1920",
                    help="HxW of the synthetic frames")
    ap.add_argument("--dla_node", default="dcn")
    ap.add_argument("--fp32", action="store_true",
                    help="float32 compute (default bfloat16, the recipes' "
                         "train lines)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from deft_tpu_torch.config import mot_config
    from deft_tpu_torch.data.datasets import get_dataset

    if args.data_dir:
        mot_dir = Path(args.data_dir)
    else:
        size = tuple(int(v) for v in args.frame_size.split("x"))
        t0 = time.perf_counter()
        mot_dir = synthetic_mot(Path(tempfile.mkdtemp(prefix="bench_loader_")),
                                args.frames, size)
        _log(f"# wrote {args.frames} {size[0]}x{size[1]} frames in "
             f"{time.perf_counter() - t0:.1f}s under {mot_dir}")
    cfg = mot_config(input_h=args.h, input_w=args.w, dla_node=args.dla_node,
                     dataset_version="17trainval",
                     compute_dtype="float32" if args.fp32 else "bfloat16")
    ds = get_dataset("mot")(cfg, "train", data_dir=str(mot_dir))
    # at most --frames samples: a pass that stops early leaves results in
    # flight, and a pool terminated under them can hang
    ds.images = ds.images[: args.frames]
    rates = {w: loader_rate(ds, args.batch, w)
             for w in (int(x) for x in args.workers.split(","))}
    out = {"metric": "loader_samples_per_s",
           "value": round(max(rates.values()), 2), "unit": "samples/s",
           "per_workers": {str(k): round(v, 2) for k, v in rates.items()},
           "shape": f"{args.h}x{args.w}", "batch": args.batch,
           "samples": len(ds)}
    if not args.skip_step:
        import torch

        from deft_tpu_torch.models.factory import resolve_device

        device = resolve_device(args.device)
        step = step_times(cfg, ds, args.batch, args.steps, device)
        demand = args.batch / (step["train_step_ms"] / 1000.0)
        out.update({k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in step.items()})
        out["train_samples_per_s"] = round(demand, 2)
        out["loader_bound"] = bool(max(rates.values()) < demand)
        _log(f"# train step {step['train_step_ms']:.1f} ms at batch "
             f"{args.batch} on {device}"
             + (f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
             + f" -> demand {demand:.1f} samples/s")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
