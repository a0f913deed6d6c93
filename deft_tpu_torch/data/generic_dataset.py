"""The index half of ``deft_tpu/data/generic_dataset.py::GenericDataset``:
what ``test.py`` reads from a dataset.

``GenericDataset(cfg, split, ann_path, img_dir)`` loads a COCO-format
annotation file into a ``CocoIndex`` (``self.coco``) and keeps the image
ids (``self.images``, ``len``) and, for tracking (or AFE) configs, the
video -> images index (``self.video_to_images``), as the JAX class does
(``generic_dataset.py:87-106``).  Training samples (augmentation and target
assembly, ``__getitem__``) are not ported yet (ROADMAP.md, queue A.6).
"""

from __future__ import annotations

from typing import Optional

from deft_tpu_torch.data.coco_index import CocoIndex


class GenericDataset:
    """A COCO-format split: image index, video index, image directory."""

    def __init__(self, cfg, split: str, ann_path: Optional[str] = None,
                 img_dir: Optional[str] = None,
                 coco: Optional[CocoIndex] = None):
        self.cfg = cfg
        self.split = split
        self.img_dir = img_dir
        if coco is not None:
            self.coco = coco
        elif ann_path is not None:
            self.coco = CocoIndex(ann_path)
        else:
            self.coco = None
        if self.coco is not None:
            self.images = self.coco.get_img_ids()
            if cfg.tracking or cfg.afe:
                self.video_to_images = self.coco.ensure_video_index()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        raise NotImplementedError(
            "training samples are not ported yet (ROADMAP.md, queue A.6: "
            "data pipeline)")
