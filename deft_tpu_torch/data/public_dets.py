"""Public detections for MOTChallenge's public-detection protocol: the row
mapping of ``tools/convert_mot_det_to_results.py`` (numpy and json only).

Each sequence's ``det/det.txt`` (MOT rows ``frame, id, x, y, w, h, score,
...``) gives, per image of a dataset json, the detection dicts that
``track.py::track_videos(..., public_dets=...)`` and
``track_videos_detector`` hand the runner or ``Detector.run`` as
``meta["cur_dets"]`` under ``cfg.public_det``:
``{"bbox": [x1, y1, x2, y2], "score", "class": 1, "ct": [cx, cy]}``.
``load_results`` reads such a mapping back from the json the tool writes
(``--load_results``, ``test.py:79-82``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Union

import numpy as np


def load_results(path: str) -> Dict[int, List[dict]]:
    """{image id: detection dicts} from a ``--load_results`` json (keys
    are image ids as strings)."""
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def load_det_txt(path: str) -> np.ndarray:
    """A ``det.txt`` as [N, >= 6] float64 rows; [0, 7] when it is absent."""
    if not os.path.exists(path):
        return np.zeros((0, 7))
    return np.loadtxt(path, delimiter=",", ndmin=2)


def frame_dets(rows: np.ndarray, raw_frame: int) -> List[dict]:
    """The detection dicts of one frame (its 1-based number in the
    sequence) from a ``det.txt``'s rows; score 1.0 where a row has none."""
    sel = rows[rows[:, 0] == raw_frame] if len(rows) else rows
    return [{"bbox": [float(r[2]), float(r[3]),
                      float(r[2] + r[4]), float(r[3] + r[5])],
             "score": float(r[6]) if len(r) > 6 else 1.0,
             "class": 1,
             "ct": [float(r[2] + r[4] / 2), float(r[3] + r[5] / 2)]}
            for r in sel]


def public_dets(dataset: Union[str, Mapping], data_dir: str,
                split: str = "train") -> Dict[int, List[dict]]:
    """{image id: detection dicts} for every image of ``dataset`` (a COCO
    tracking json or its path), from ``data_dir/split/<seq>/det/det.txt``.
    An image's raw frame number comes from its file name (half-split jsons
    renumber ``frame_id``)."""
    if isinstance(dataset, str):
        with open(dataset) as f:
            dataset = json.load(f)
    seq_of_video = {v["id"]: v["file_name"] for v in dataset["videos"]}
    rows_of_seq: Dict[str, np.ndarray] = {}
    out: Dict[int, List[dict]] = {}
    for im in dataset["images"]:
        seq = seq_of_video[im["video_id"]]
        if seq not in rows_of_seq:
            rows_of_seq[seq] = load_det_txt(
                os.path.join(data_dir, split, seq, "det", "det.txt"))
        raw_frame = int(os.path.basename(im["file_name"]).split(".")[0])
        out[int(im["id"])] = frame_dets(rows_of_seq[seq], raw_frame)
    return out
