"""Alias module, as ``deft_tpu/data/datasets/custom.py``: ``CustomDataset``
lives beside ``CocoDataset``."""
from deft_tpu_torch.data.datasets.coco_det import CustomDataset  # noqa: F401
