"""MOT16/17 tracking split, the counterpart of
``deft_tpu/data/datasets/mot.py``: the annotation file and image
directory of a ``dataset_version``, the MOTChallenge txt writer
(``track.py::save_mot_results``) and the CLEAR-MOT scores of the port's
``tools/eval_mot.py``."""

from __future__ import annotations

import os

from deft_tpu_torch.data.datasets import MOT_INFO
from deft_tpu_torch.data.generic_dataset import GenericDataset
from deft_tpu_torch.track import save_mot_results


class MOTDataset(GenericDataset):
    num_categories = MOT_INFO.num_categories
    default_resolution = MOT_INFO.default_resolution
    class_name = MOT_INFO.class_name
    cat_ids = dict(MOT_INFO.cat_ids)
    max_objs = MOT_INFO.max_objs

    def __init__(self, cfg, split, data_dir=None):
        self.dataset_version = cfg.dataset_version
        self.year = (int(self.dataset_version[:2]) if self.dataset_version
                     else 17)
        data_dir = data_dir or os.path.join("data", f"mot{self.year}")
        ann_file = {
            "17halftrain": "train_half.json",
            "17halfval": "val_half.json",
            "15halftrain": "train_half.json",
            "15halfval": "val_half.json",
        }.get(self.dataset_version,
              "train.json" if split == "train" else "test.json")
        img_dir = os.path.join(
            data_dir, "test" if "test" in self.dataset_version else "train")
        ann_path = os.path.join(data_dir, "annotations", ann_file)
        super().__init__(cfg, split, ann_path, img_dir)

    def save_results(self, results, save_dir):
        """One MOTChallenge txt per sequence under
        ``results_mot<version>/``; returns that directory."""
        return save_mot_results(results, self.coco.dataset["videos"],
                                self.video_to_images, save_dir,
                                self.dataset_version)

    def run_eval(self, results, save_dir, gt_dir=None):
        """Write the results, then score them against ``gt_dir``'s
        ``<seq>/gt/gt<gt_type>.txt`` with the port's ``tools/eval_mot.py``."""
        results_dir = self.save_results(results, save_dir)
        from deft_tpu_torch.tools.eval_mot import evaluate_mot_dir

        gt_type = ""
        if "17halftrain" in self.dataset_version:
            gt_type = "_train_half"
        elif "17halfval" in self.dataset_version or self.year in (16, 19):
            gt_type = "_val_half"
        if gt_dir is None:
            gt_dir = os.path.join("data", f"mot{self.year}", "train")
        return evaluate_mot_dir(gt_dir, results_dir, gt_type=gt_type)
