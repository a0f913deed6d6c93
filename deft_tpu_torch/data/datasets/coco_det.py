"""COCO-format detection datasets, the counterpart of
``deft_tpu/data/datasets/coco_det.py``.

``CocoDataset`` reads ``<data_dir>/{split}2017/`` with
``annotations/instances_{split}2017.json`` (``--dataset coco``; 80
classes at 512x512 by default), maps the json's category ids to classes
1..N in sorted order and back for the results file, and scores results
with the port's ``tools/eval_coco.py`` (COCOeval's 12 numbers).
``CustomDataset`` (``--dataset custom``) reads any COCO-format json named
by ``--custom_dataset_ann_path`` over ``--custom_dataset_img_path``, with
``--num_classes`` classes (1 by default); it has no evaluator.

Both read through ``GenericDataset``, so ``test.py`` groups their images
by ``video_id`` and ``frame_id``: a json without ``videos`` gets one video
per image (``coco_index.py``), one whose images lack ``video_id`` under a
``videos`` list raises ``KeyError``, as the JAX package does (ROADMAP C.3).
"""

from __future__ import annotations

import json
import os

from deft_tpu_torch.data.datasets import COCO_INFO
from deft_tpu_torch.data.generic_dataset import GenericDataset


class CocoDataset(GenericDataset):
    default_resolution = COCO_INFO.default_resolution
    num_categories = COCO_INFO.num_categories
    max_objs = COCO_INFO.max_objs

    def __init__(self, cfg, split, data_dir=None):
        data_dir = data_dir or os.path.join("data", "coco")
        img_dir = os.path.join(data_dir, f"{split}2017")
        ann_path = os.path.join(data_dir, "annotations",
                                f"instances_{split}2017.json")
        super().__init__(cfg, split, ann_path, img_dir)
        cat_ids = sorted(self.coco.cats.keys())
        self.cat_ids = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.class_name = tuple(self.coco.cats[cid]["name"]
                                for cid in cat_ids)

    def convert_eval_format(self, all_bboxes):
        """COCO results json: {image_id, category_id (the json's), bbox
        [x, y, w, h], score to two decimals} per item."""
        inv = {v: k for k, v in self.cat_ids.items()}
        detections = []
        for image_id, dets in all_bboxes.items():
            for item in dets:
                b = item["bbox"]
                detections.append({
                    "image_id": int(image_id),
                    "category_id": inv[int(item["class"])],
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "score": float(f"{item['score']:.2f}"),
                })
        return detections

    def save_results(self, results, save_dir):
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, "results_coco.json")
        with open(path, "w") as f:
            json.dump(self.convert_eval_format(results), f)
        return path

    def run_eval(self, results, save_dir):
        """Write ``results_coco.json`` and return the 12-number COCO summary
        of ``tools/eval_coco.py`` (printed as COCOeval prints it)."""
        self.save_results(results, save_dir)
        from deft_tpu_torch.tools.eval_coco import evaluate, print_summary

        stats = evaluate(self.coco, self.convert_eval_format(results))
        print_summary(stats)
        return stats


class CustomDataset(GenericDataset):
    """A user's COCO-format dataset (the reference's
    ``custom_dataset.py``)."""

    def __init__(self, cfg, split, data_dir=None):
        assert cfg.custom_dataset_img_path and cfg.custom_dataset_ann_path, (
            "custom dataset needs custom_dataset_img_path and "
            "custom_dataset_ann_path")
        self.num_categories = cfg.num_classes if cfg.num_classes > 0 else 1
        self.class_name = tuple(str(i) for i in range(self.num_categories))
        self.default_resolution = (cfg.input_h, cfg.input_w)
        self.cat_ids = {i: i for i in range(1, self.num_categories + 1)}
        super().__init__(cfg, split, cfg.custom_dataset_ann_path,
                         cfg.custom_dataset_img_path)

    def run_eval(self, results, save_dir):
        raise NotImplementedError("custom datasets have no bundled evaluator")
