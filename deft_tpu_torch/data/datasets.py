"""Dataset metadata, copied from ``deft_tpu/data/datasets/__init__.py``.

What the configuration and the trackers need: ``DatasetInfo``, the
per-dataset info table, ``get_dataset_info``, the nuScenes tracking classes
and the nuScenes submission's class families
(``deft_tpu/data/datasets/nuscenes.py:22-27``).  The dataset classes and the
data pipeline are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


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
