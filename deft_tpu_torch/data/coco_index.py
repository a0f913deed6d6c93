"""Thin COCO-format JSON index, copied from ``deft_tpu/data/coco_index.py``.

pycocotools is not a dependency; the reference uses it only as an id ->
record index (``generic_dataset.py:106-116``).  This provides the subset
used: image ids, per-image annotation lookup, category list, and the video
/ frame index of the tracking datasets.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


class CocoIndex:
    def __init__(self, ann_path: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if dataset is None:
            with open(ann_path, "r") as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {im["id"]: im for im in dataset.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in dataset.get("annotations", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in dataset.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns_for_img(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    # --- video index (tracking) ---------------------------------------------

    def ensure_video_index(self):
        """Adds fake per-image videos for still-image datasets
        (generic_dataset.py:910-922) and builds video -> images."""
        if "videos" not in self.dataset:
            self.dataset["videos"] = []
            for im in self.dataset.get("images", []):
                im["video_id"] = im["id"]
                im["frame_id"] = 1
                self.dataset["videos"].append({"id": im["id"]})
            for i, a in enumerate(self.dataset.get("annotations", [])):
                a.setdefault("track_id", i + 1)
        self.video_to_images: Dict[int, List[dict]] = defaultdict(list)
        for im in self.dataset.get("images", []):
            self.video_to_images[im["video_id"]].append(im)
        return self.video_to_images
