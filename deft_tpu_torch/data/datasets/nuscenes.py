"""nuScenes monocular 3-D tracking split, the counterpart of
``deft_tpu/data/datasets/nuscenes.py``: the annotation file and image
directory of a split, the submission writer (``track.py::
nuscenes_submission``) and the AMOTA scores of the port's
``tools/eval_nuscenes.py``.

Unlike the JAX class, ``run_eval`` lets an evaluator failure raise (the JAX
one prints it and goes on, ``nuscenes.py:150-158``): a swallowed failure
would hide a broken run.  It returns the evaluator's result with the
submission's path under ``"submission"`` (the JAX one returns the path
alone and prints the table).
"""

from __future__ import annotations

import json
import os

from deft_tpu_torch.data.datasets import NUSCENES_INFO
from deft_tpu_torch.data.generic_dataset import GenericDataset
from deft_tpu_torch.track import nuscenes_submission


class NuScenesDataset(GenericDataset):
    num_categories = NUSCENES_INFO.num_categories
    default_resolution = NUSCENES_INFO.default_resolution
    class_name = NUSCENES_INFO.class_name
    cat_ids = dict(NUSCENES_INFO.cat_ids)
    max_objs = NUSCENES_INFO.max_objs
    focal_length = NUSCENES_INFO.focal_length

    def __init__(self, cfg, split, data_dir=None):
        data_dir = data_dir or os.path.join("data", "nuscenes")
        test = cfg.dataset_version == "test" or split == "test"
        if test:
            ann_path = os.path.join(data_dir, "annotations", "test.json")
        else:
            ann_path = os.path.join(data_dir, "annotations",
                                    f"{cfg.dataset_version}{split}.json")
        self.data_dir = data_dir
        self.version = "v1.0-test" if test else "v1.0-trainval"
        super().__init__(cfg, split, ann_path,
                         os.path.join(data_dir, self.version))

    def convert_eval_format(self, results):
        """{image id: items} -> the tracking (or, without ``cfg.tracking``,
        detection) submission."""
        return nuscenes_submission(results, self.coco.imgs,
                                   tracking=self.cfg.tracking)

    def save_results(self, results, save_dir, task="tracking"):
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, f"results_nuscenes_{task}.json")
        with open(out, "w") as f:
            json.dump(self.convert_eval_format(results), f)
        return out

    def run_eval(self, results, save_dir):
        """Write the submission; where the split's ``scene.json`` (and the
        other v1.0 tables) are present and the task is tracking, score it
        with the port's ``tools/eval_nuscenes.py`` and print the table.
        Returns ``{"submission": path}`` plus the evaluator's ``overall``
        and ``classes`` when it ran."""
        task = "tracking" if self.cfg.tracking else "det"
        out = self.save_results(results, save_dir, task)
        tables = os.path.join(self.data_dir, self.version, "scene.json")
        if task != "tracking" or not os.path.exists(tables):
            return {"submission": out}
        from deft_tpu_torch.tools.eval_nuscenes import (
            evaluate_submission, format_table)

        res = evaluate_submission(out, self.data_dir, self.version)
        print(format_table(res))
        return {"submission": out, **res}
