"""Dataset metadata and the dataset classes' factory, the counterpart of
``deft_tpu/data/datasets/__init__.py``.

What the configuration and the trackers need: ``DatasetInfo``, the
per-dataset info table, ``get_dataset_info``, the nuScenes tracking classes
and the nuScenes submission's class families
(``deft_tpu/data/datasets/nuscenes.py:22-27``).  ``get_dataset`` returns the
class that ``test.py`` and ``train.py`` read a split with:
``mot.MOTDataset``, ``kitti_tracking.KITTITrackingDataset`` or
``nuscenes.NuScenesDataset``, ``coco_det.CocoDataset``,
``coco_det.CustomDataset`` (``custom.py``), and for ``prediction_model``
the motion model's ``trajectory_dataset.TrajectoryDataset`` (each imported
when asked for).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# ImageNet-style normalization and colour-augmentation constants shared by
# every dataset (deft_tpu/data/datasets/__init__.py:15-28)
MEAN = np.array([0.40789654, 0.44719302, 0.47026115], dtype=np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], dtype=np.float32)
EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], dtype=np.float32)
EIG_VEC = np.array(
    [
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938],
    ],
    dtype=np.float32,
)
# nuScenes attribute-consistency ranges per class (generic_dataset.py:83-92)
NUSCENES_ATT_RANGE = {
    0: [0, 1], 1: [0, 1],
    2: [2, 3, 4], 3: [2, 3, 4], 4: [2, 3, 4],
    5: [5, 6, 7], 6: [5, 6, 7], 7: [5, 6, 7],
}


@dataclass(frozen=True)
class DatasetInfo:
    name: str
    num_categories: int
    default_resolution: Tuple[int, int]   # (h, w)
    class_name: Tuple[str, ...]
    max_objs: int
    cat_ids: Dict[int, int]
    focal_length: int = 1200
    attribute_to_id: Dict[str, int] = field(default_factory=dict)


MOT_INFO = DatasetInfo(
    name="mot",
    num_categories=1,
    default_resolution=(544, 960),
    class_name=("",),
    max_objs=256,
    cat_ids={1: 1, -1: -1},
)

KITTI_TRACKING_INFO = DatasetInfo(
    name="kitti_tracking",
    num_categories=3,
    default_resolution=(384, 1280),
    class_name=("Pedestrian", "Car", "Cyclist"),
    max_objs=50,
    cat_ids={1: 1, 2: 2, 3: 3, 4: -2, 5: -2, 6: -1, 7: -9999, 8: -9999, 9: 0},
)

NUSCENES_INFO = DatasetInfo(
    name="nuscenes",
    num_categories=10,
    default_resolution=(448, 800),
    class_name=(
        "car", "truck", "bus", "trailer", "construction_vehicle",
        "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
    ),
    max_objs=128,
    cat_ids={i + 1: i + 1 for i in range(10)},
    attribute_to_id={
        "": 0,
        "cycle.with_rider": 1,
        "cycle.without_rider": 2,
        "pedestrian.moving": 3,
        "pedestrian.standing": 4,
        "pedestrian.sitting_lying_down": 5,
        "vehicle.moving": 6,
        "vehicle.parked": 7,
        "vehicle.stopped": 8,
    },
)

COCO_INFO = DatasetInfo(
    name="coco",
    num_categories=80,
    default_resolution=(512, 512),
    class_name=tuple(f"class_{i}" for i in range(80)),
    max_objs=128,
    cat_ids={},  # filled by the COCO dataset class from the annotation file
)

CUSTOM_INFO = DatasetInfo(
    name="custom",
    num_categories=1,
    default_resolution=(512, 512),
    class_name=("object",),
    max_objs=128,
    cat_ids={1: 1},
)

_INFOS = {
    "mot": MOT_INFO,
    "kitti_tracking": KITTI_TRACKING_INFO,
    "nuscenes": NUSCENES_INFO,
    "coco": COCO_INFO,
    "custom": CUSTOM_INFO,
}

NUSCENES_TRACKING_CLASSES = (
    "car", "truck", "bus", "trailer", "pedestrian", "motorcycle", "bicycle",
)
# the nuScenes submission: classes left out of tracking, and the families
# whose attribute is the argmax of their slice of the nuscenes_att head
NUSCENES_TRACKING_IGNORED = ("construction_vehicle", "traffic_cone", "barrier")
NUSCENES_VEHICLES = ("car", "truck", "bus", "trailer", "construction_vehicle")
NUSCENES_CYCLES = ("motorcycle", "bicycle")
NUSCENES_PEDESTRIANS = ("pedestrian",)
NUSCENES_ID_TO_ATTRIBUTE = {v: k for k, v in
                            NUSCENES_INFO.attribute_to_id.items()}


def get_dataset_info(name: str) -> DatasetInfo:
    return _INFOS[name]


def get_dataset(name: str, prediction_model: bool = False):
    """Dataset class factory (``deft_tpu/data/datasets/__init__.py:
    124-138``; the reference's ``dataset_factory.py:16-34``)."""
    if prediction_model:
        from deft_tpu_torch.data.trajectory_dataset import TrajectoryDataset
        return TrajectoryDataset
    if name == "mot":
        from deft_tpu_torch.data.datasets.mot import MOTDataset
        return MOTDataset
    if name == "kitti_tracking":
        from deft_tpu_torch.data.datasets.kitti_tracking import (
            KITTITrackingDataset)
        return KITTITrackingDataset
    if name == "nuscenes":
        from deft_tpu_torch.data.datasets.nuscenes import NuScenesDataset
        return NuScenesDataset
    if name == "coco":
        from deft_tpu_torch.data.datasets.coco_det import CocoDataset
        return CocoDataset
    if name == "custom":
        from deft_tpu_torch.data.datasets.custom import CustomDataset
        return CustomDataset
    raise KeyError(name)
