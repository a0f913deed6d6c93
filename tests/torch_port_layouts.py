"""PNG datasets of the port's numpy generators
(``deft_tpu_torch/data/synthetic_{kitti,nuscenes}.py``) with their
converted annotations: the layouts ``chip_smoke.py`` trains and tests on at
full size and the port's CPU tests at a small one.  numpy and the port
only, no cv2 and no JAX (the card's machine has neither).

* ``write_pngs``: ``image_io.imwrite_png`` for (path, frame) pairs;
* ``layout_kitti``: a KITTI tracking sequence through the port's
  ``tools/convert_kittitrack_to_coco.py``;
* ``layout_nuscenes_train``: a six-camera nuScenes scene, its v1.0 tables
  and ``deft_tpu_torch/tools/convert_nuscenes.py``'s ``train.json``;
* ``layout_coco``: one split of a COCO-format dataset of videos
  (``{split}2017/`` and ``annotations/instances_{split}2017.json``),
  moving boxes on noise in the given categories.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import numpy as np


def write_pngs(paths_and_frames):
    """``image_io.imwrite_png`` for each (path, frame)."""
    from deft_tpu_torch.data.image_io import imwrite_png

    for path, frame in paths_and_frames:
        path.parent.mkdir(parents=True, exist_ok=True)
        imwrite_png(str(path), frame)


def layout_kitti(root: Path, n_frames: int, size, seed: int,
                 classes=("Car",)) -> Path:
    """The numpy KITTI scene (``synthetic_kitti.make_sequence``, objects of
    ``classes``) as
    ``kitti_tracking/``: PNG frames under
    ``data_tracking_image_2/training/image_02/0000``, ``label_02/0000.txt``
    and ``calib/0000.txt``, then the port's
    ``tools/convert_kittitrack_to_coco.py``
    (``tracking_train.json`` holds every frame, ``tracking_val_half.json``
    the last half)."""
    from deft_tpu_torch.data.synthetic_kitti import make_sequence
    from deft_tpu_torch.tools.convert_kittitrack_to_coco import convert

    data = root / "kitti_tracking"
    frames, rows = make_sequence(n_frames=n_frames, height=size[0],
                                 width=size[1], seed=seed, classes=classes)
    write_pngs((data / "data_tracking_image_2" / "training" / "image_02"
                / "0000" / f"{f:06d}.png", img) for f, img in enumerate(frames))
    (data / "label_02").mkdir(parents=True, exist_ok=True)
    (data / "label_02" / "0000.txt").write_text("\n".join(rows) + "\n")
    (data / "calib").mkdir(parents=True, exist_ok=True)
    (data / "calib" / "0000.txt").write_text(
        f"P2: 700.0 0.0 {size[1] / 2} 0.0 0.0 700.0 {size[0] / 2} 0.0 "
        "0.0 0.0 1.0 0.0\n")
    with contextlib.redirect_stdout(sys.stderr):
        convert(str(data), "train")
    return data


def layout_nuscenes_train(root: Path, samples: int, size, seed: int,
                          cameras: int = 6) -> Path:
    """The numpy six-camera rig (``synthetic_nuscenes``) as ``nuscenes/``:
    PNG frames at ``frame_path``, the v1.0 tables of ``make_tables`` and the
    port's ``convert_nuscenes.convert`` of them into
    ``annotations/train.json`` (camera-major, as the trajectory windows
    need)."""
    from deft_tpu_torch.data.synthetic_nuscenes import (frame_path,
                                                        make_scene,
                                                        make_tables)
    from deft_tpu_torch.tools.convert_nuscenes import convert

    data = root / "nuscenes"
    version = data / "v1.0-trainval"
    scene = make_scene(n_samples=samples, cameras=cameras, height=size[0],
                       width=size[1], seed=seed)
    write_pngs((version / frame_path(info["sensor_id"] - 1,
                                     info["frame_id"] - 1), frame)
               for info, frame in scene)
    for name, rows in make_tables(samples, seed=seed, cameras=cameras,
                                  height=size[0], width=size[1]).items():
        (version / f"{name}.json").write_text(json.dumps(rows))
    with contextlib.redirect_stdout(sys.stderr):
        convert(str(data), "v1.0-trainval", "train.json")
    return data


def layout_coco(root: Path, split: str, categories, videos: int = 2,
                frames: int = 4, size=(64, 96), seed: int = 0,
                objects: int = 3) -> Path:
    """One split of a COCO-format dataset in ``root`` (the layout of the
    JAX ``CocoDataset``): ``{split}2017/v<video>_<frame>.png``, ``objects``
    boxes per video moving on noise, each in a category of
    ``categories`` ([{"id", "name"}], in turn), with ``video_id``,
    ``frame_id`` and ``track_id``; returns the instances json's path."""
    rng = np.random.RandomState(seed)
    h, w = size
    images, anns, vids, pngs = [], [], [], []
    for v in range(1, videos + 1):
        vids.append({"id": v, "file_name": f"video{v}"})
        moving = [(rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h,
                   rng.uniform(0.15, 0.3) * w, rng.uniform(0.15, 0.3) * h,
                   rng.uniform(-0.02, 0.02, 2) * (w, h),
                   categories[(v * objects + k) % len(categories)]["id"])
                  for k in range(objects)]
        for f in range(1, frames + 1):
            img = rng.randint(30, 80, (h, w, 3)).astype(np.uint8)
            image_id = len(images) + 1
            for tid, (x, y, bw, bh, vel, cat) in enumerate(moving, 1):
                x0, y0 = x + vel[0] * f, y + vel[1] * f
                img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = (
                    rng.randint(120, 255, 3))
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": cat, "bbox": [x0, y0, bw, bh],
                             "area": bw * bh, "iscrowd": 0,
                             "track_id": 100 * v + tid})
            name = f"v{v}_{f:03d}.png"
            pngs.append((root / f"{split}2017" / name, img))
            images.append({"id": image_id, "file_name": name,
                           "video_id": v, "frame_id": f,
                           "height": h, "width": w})
    write_pngs(pngs)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    path = root / "annotations" / f"instances_{split}2017.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "videos": vids, "categories": categories}))
    return path
