"""KITTI tracking split, the counterpart of
``deft_tpu/data/datasets/kitti_tracking.py``: the annotation file and image
directory of a ``dataset_version``, the KITTI tracking txt writer
(``track.py::save_kitti_results``) and the scores of the port's
``tools/eval_kitti.py``."""

from __future__ import annotations

import os

from deft_tpu_torch.data.datasets import KITTI_TRACKING_INFO
from deft_tpu_torch.data.generic_dataset import GenericDataset
from deft_tpu_torch.track import save_kitti_results


class KITTITrackingDataset(GenericDataset):
    num_categories = KITTI_TRACKING_INFO.num_categories
    default_resolution = KITTI_TRACKING_INFO.default_resolution
    class_name = KITTI_TRACKING_INFO.class_name
    cat_ids = dict(KITTI_TRACKING_INFO.cat_ids)
    max_objs = KITTI_TRACKING_INFO.max_objs

    def __init__(self, cfg, split, data_dir=None):
        data_dir = data_dir or os.path.join("data", "kitti_tracking")
        split_ = "train" if cfg.dataset_version != "test" else "test"
        img_dir = os.path.join(data_dir, "data_tracking_image_2",
                               f"{split_}ing", "image_02")
        ann_file = split_ if cfg.dataset_version == "" else cfg.dataset_version
        ann_path = os.path.join(data_dir, "annotations",
                                f"tracking_{ann_file}.json")
        super().__init__(cfg, split, ann_path, img_dir)

    def save_results(self, results, save_dir):
        """One KITTI tracking txt per sequence under
        ``results_kitti_tracking/``; returns that directory."""
        return save_kitti_results(results, self.coco.dataset["videos"],
                                  self.video_to_images, save_dir)

    def run_eval(self, results, save_dir, gt_dir=None):
        """Write the results, then score the cars against ``gt_dir``'s
        ``<seq>.txt`` with the port's ``tools/eval_kitti.py``."""
        results_dir = self.save_results(results, save_dir)
        from deft_tpu_torch.tools.eval_kitti import evaluate_kitti_dir

        if gt_dir is None:
            gt_dir = os.path.join("data", "kitti_tracking", "label_02")
        return evaluate_kitti_dir(gt_dir, results_dir)
