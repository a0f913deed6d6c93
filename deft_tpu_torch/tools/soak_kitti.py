"""KITTI tracking soak through the port: generate -> convert -> train ->
test -> evaluate, the counterpart of ``tools/soak_kitti.py``:

    python -m deft_tpu_torch.tools.soak_kitti            # full soak, card
    python -m deft_tpu_torch.tools.soak_kitti --smoke    # tiny, on the CPU

1. ``--seqs`` sequences of ``data/synthetic_kitti.py::make_sequence`` (the
   rich scene: ``--objects`` cars with depth, lanes, crossings, entries and
   exits) at 384x1280, as PNG frames, ``label_02`` and ``calib`` under
   ``<work_dir>/data/kitti_tracking``;
2. the port's ``tools/convert_kittitrack_to_coco.py`` (``train_half`` and
   ``val_half`` splits among others);
3. ``python -m deft_tpu_torch.train`` on the first half of every sequence;
4. ``python -m deft_tpu_torch.test`` on the second half with its
   ``model_last.pth``;
5. the port's ``tools/eval_kitti.py`` against the ground truth of the
   second halves only (first-half ground truth would count as misses),
   the half-video protocol the reference uses for its ablations.

Everything runs in ``--work_dir`` (default ``build/soak_kitti`` under the
repository root, which git ignores); the summary is printed as one JSON
line and written to ``<work_dir>/exp/tracking/<exp_id>/soak_summary.json``.
``--smoke`` is 1 sequence of 24 frames with 8 cars at 96x320, 2 epochs, on
the CPU (``--gpus -1``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def run(cmd, cwd: Path):
    print("+ " + " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(cmd, check=True, cwd=cwd, env=env)


def generate(data_dir: Path, seqs: int, frames: int, objects: int,
             size, seed: int):
    """The rich scenes as a KITTI tracking layout, then its COCO-video
    annotations."""
    from deft_tpu_torch.data.image_io import imwrite_png
    from deft_tpu_torch.data.synthetic_kitti import make_sequence
    from deft_tpu_torch.tools.convert_kittitrack_to_coco import convert

    h, w = size
    img_root = data_dir / "data_tracking_image_2" / "training" / "image_02"
    for d in ("label_02", "calib"):
        (data_dir / d).mkdir(parents=True, exist_ok=True)
    for i in range(seqs):
        seq = f"{i:04d}"
        imgs, rows = make_sequence(n_frames=frames, height=h, width=w,
                                   n_objects=objects, seed=seed + i)
        (img_root / seq).mkdir(parents=True, exist_ok=True)
        for f, img in enumerate(imgs):
            imwrite_png(str(img_root / seq / f"{f:06d}.png"), img)
        (data_dir / "label_02" / f"{seq}.txt").write_text(
            "\n".join(rows) + "\n")
        (data_dir / "calib" / f"{seq}.txt").write_text(
            f"P2: 700.0 0.0 {w / 2} 0.0 0.0 700.0 {h / 2} 0.0 "
            "0.0 0.0 1.0 0.0\n")
    with contextlib.redirect_stdout(sys.stderr):
        convert(str(data_dir), "train")


def write_val_half_gt(data_dir: Path, out_dir: Path):
    """Ground truth of each sequence's second half (frames > n//2), the
    val_half split of the converter (``tools/soak_kitti.py:45-63``)."""
    img_root = data_dir / "data_tracking_image_2" / "training" / "image_02"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label in sorted((data_dir / "label_02").iterdir()):
        n = len(list((img_root / label.stem).iterdir()))
        keep = [line for line in label.read_text().splitlines(True)
                if line.split() and int(line.split()[0]) + 1 > n // 2]
        (out_dir / label.name).write_text("".join(keep))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU (the pipeline only)")
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--objects", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--input_h", type=int, default=384)
    ap.add_argument("--input_w", type=int, default=1280)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gpus", default="0")
    ap.add_argument("--work_dir", default=str(REPO / "build" / "soak_kitti"))
    ap.add_argument("--exp_id", default="kitti_soak")
    ap.add_argument("--keep_data", action="store_true",
                    help="reuse an existing generated layout")
    ap.add_argument("--skip_train", action="store_true",
                    help="test and evaluate an already trained model_last")
    args = ap.parse_args(argv)
    if args.smoke:
        args.seqs, args.frames, args.objects = 1, 24, 8
        args.epochs, args.input_h, args.input_w = 2, 96, 320
        args.gpus = "-1"

    work = Path(args.work_dir).resolve()
    data_dir = work / "data" / "kitti_tracking"
    if not args.keep_data:
        if data_dir.exists():
            shutil.rmtree(data_dir)
        generate(data_dir, args.seqs, args.frames, args.objects,
                 (args.input_h, args.input_w), args.seed)

    common = ["tracking", "--dataset", "kitti_tracking",
              "--exp_id", args.exp_id, "--data_dir", str(work / "data"),
              "--exp_dir", str(work / "exp"), "--gpus", args.gpus,
              "--input_h", str(args.input_h), "--input_w", str(args.input_w)]
    save_dir = work / "exp" / "tracking" / args.exp_id
    if not args.skip_train:
        run([sys.executable, "-m", "deft_tpu_torch.train", *common,
             "--dataset_version", "train_half",
             "--batch_size", str(args.batch_size),
             "--num_epochs", str(args.epochs),
             "--lr_step", str(max(args.epochs * 3 // 4, 1)),
             "--num_workers", "2"], cwd=work)
    run([sys.executable, "-m", "deft_tpu_torch.test", *common,
         "--dataset_version", "val_half",
         "--load_model", str(save_dir / "model_last.pth"),
         "--track_thresh", "0.4"], cwd=work)

    from deft_tpu_torch.tools.eval_kitti import evaluate_kitti_dir

    gt_half = save_dir / "gt_val_half"
    write_val_half_gt(data_dir, gt_half)
    metrics = evaluate_kitti_dir(str(gt_half),
                                 str(save_dir / "results_kitti_tracking"))
    overall = metrics.get("overall", {})
    summary = {
        "soak": "kitti", "seqs": args.seqs, "frames_per_seq": args.frames,
        "objects": args.objects, "epochs": args.epochs,
        "res": f"{args.input_h}x{args.input_w}",
        "MOTA": round(overall.get("mota", 0.0) * 100, 2),
        "IDF1": round(overall.get("idf1", 0.0) * 100, 2),
        "IDS": overall.get("num_switches", -1),
        "Frag": overall.get("num_fragmentations", -1),
        "MT": overall.get("mostly_tracked", -1),
        "ML": overall.get("mostly_lost", -1),
    }
    print(json.dumps(summary))
    (save_dir / "soak_summary.json").write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
