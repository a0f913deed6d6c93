"""MOTChallenge -> COCO-video json converter, copied from
``tools/convert_mot_to_coco.py`` (numpy only; the port keeps its own copy):

    python -m deft_tpu_torch.tools.convert_mot_to_coco --data_dir data/mot17

Equivalent of the reference ``src/tools/convert_mot_to_coco.py``: scans
``<data>/mot<year>/{train,test}/<seq>/img1`` + ``gt/gt.txt``, emits
``annotations/{train,test}.json`` plus the CenterTrack-style half-video
protocol: ``train_half.json`` / ``val_half.json`` (first/second half of each
training sequence) and matching ``gt/gt_{train,val}_half.txt`` files for the
evaluator.

MOT gt columns: frame, id, x, y, w, h, conf, class, visibility.  The
image size comes from each sequence's first frame read with
``data/image_io.imread`` (the JAX tool's ``cv2.imread``), so PNG sequences
convert where cv2 is missing.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def seq_image_size(seq_dir):
    from deft_tpu_torch.data.image_io import imread

    imgs = sorted(os.listdir(os.path.join(seq_dir, "img1")))
    im = imread(os.path.join(seq_dir, "img1", imgs[0]))
    return im.shape[0], im.shape[1], len(imgs)


def convert(data_dir: str, split: str, half: bool):
    split_dir = os.path.join(data_dir, split)
    seqs = sorted(
        s for s in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, s))
    )
    out = {
        "images": [], "annotations": [], "videos": [],
        "categories": [{"id": 1, "name": "pedestrian"}],
    }
    halves = ({"images": [], "annotations": [], "videos": [],
               "categories": out["categories"]},
              {"images": [], "annotations": [], "videos": [],
               "categories": out["categories"]}) if half else None

    img_id = ann_id = 0
    for video_id, seq in enumerate(seqs, start=1):
        seq_dir = os.path.join(split_dir, seq)
        h, w, num_frames = seq_image_size(seq_dir)
        video = {"id": video_id, "file_name": seq}
        out["videos"].append(video)
        if halves:
            halves[0]["videos"].append(video)
            halves[1]["videos"].append(video)
        split_frame = num_frames // 2

        frame_to_img = {}
        for frame in range(1, num_frames + 1):
            img_id += 1
            info = {
                "id": img_id,
                "file_name": f"{seq}/img1/{frame:06d}.jpg",
                "video_id": video_id,
                "frame_id": frame,
                "height": h, "width": w,
            }
            out["images"].append(info)
            frame_to_img[frame] = img_id
            if halves:
                if frame <= split_frame:
                    halves[0]["images"].append(
                        dict(info, frame_id=frame)
                    )
                else:
                    halves[1]["images"].append(
                        dict(info, frame_id=frame - split_frame)
                    )

        gt_path = os.path.join(seq_dir, "gt", "gt.txt")
        gt_rows = []
        if os.path.exists(gt_path):
            gt = np.loadtxt(gt_path, delimiter=",", ndmin=2)
            for row in gt:
                frame, tid = int(row[0]), int(row[1])
                cat = int(row[7]) if len(row) > 7 else 1
                conf = float(row[6]) if len(row) > 6 else 1.0
                # category 1 = pedestrian; others become ignore (-1) like the
                # reference converter (distractor classes)
                category_id = 1 if cat in (1, 2, 7) else -1
                ann_id += 1
                ann = {
                    "id": ann_id,
                    "image_id": frame_to_img[frame],
                    "category_id": category_id,
                    "bbox": row[2:6].tolist(),
                    "area": float(row[4] * row[5]),
                    "iscrowd": 0 if conf != 0 else 1,
                    "track_id": tid,
                    "conf": conf,
                }
                out["annotations"].append(ann)
                gt_rows.append((frame, row))
                if halves:
                    if frame <= split_frame:
                        halves[0]["annotations"].append(ann)
                    else:
                        halves[1]["annotations"].append(
                            dict(ann, image_id=ann["image_id"])
                        )

        if halves and gt_rows:
            for idx, name in ((0, "gt_train_half.txt"), (1, "gt_val_half.txt")):
                with open(os.path.join(seq_dir, "gt", name), "w") as f:
                    for frame, row in gt_rows:
                        in_first = frame <= split_frame
                        if (idx == 0) != in_first:
                            continue
                        fr = frame if idx == 0 else frame - split_frame
                        rest = ",".join(str(x) for x in row[1:])
                        f.write(f"{fr},{rest}\n")

    ann_dir = os.path.join(data_dir, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(ann_dir, f"{split}.json"), "w") as f:
        json.dump(out, f)
    print(f"{split}: {len(out['images'])} images, "
          f"{len(out['annotations'])} annotations")
    if halves:
        for part, name in zip(halves, ("train_half", "val_half")):
            with open(os.path.join(ann_dir, f"{name}.json"), "w") as f:
                json.dump(part, f)
            print(f"{name}: {len(part['images'])} images")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/mot17")
    ap.add_argument("--no_half", action="store_true")
    args = ap.parse_args(argv)
    convert(args.data_dir, "train", half=not args.no_half)
    if os.path.isdir(os.path.join(args.data_dir, "test")):
        convert(args.data_dir, "test", half=False)


if __name__ == "__main__":
    main()
