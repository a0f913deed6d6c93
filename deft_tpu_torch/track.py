"""Sequence tracking and the MOT results writer, the counterpart of the
tracking path of ``test.py`` and of ``deft_tpu/data/datasets/mot.py``'s
writer.

* ``track_videos`` drives a ``PipelinedRunner`` over sequences of decoded
  frames the way ``test.py:172-210`` does: ``reset`` per sequence, ``submit``
  per frame, ``flush`` at the end, results keyed by image id;
* ``tracks_to_results`` turns a frame's tracks into submission items;
* ``save_mot_results`` writes one MOTChallenge txt per sequence, renumbering
  track ids from 1 in sorted order.

Scoring is ``tools/eval_mot.py::evaluate_mot_dir`` on the written directory
(numpy and scipy only).  Reading image files waits for a decoder in the port
(ROADMAP.md, queue A): callers pass decoded uint8 BGR frames.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def tracks_to_results(online, cls_default: int = 1) -> List[dict]:
    """One frame's tracks -> submission items (``test.py:43-65``; the 2-D
    tracks carry no class of their own)."""
    return [{"bbox": np.asarray(t.tlbr, np.float32),
             "score": float(t.score),
             "class": cls_default,
             "tracking_id": int(t.track_id),
             "active": 1 if t.is_activated else 0} for t in online]


Video = Tuple[object, Sequence[Tuple[int, np.ndarray]]]


def track_videos(runner, videos: Iterable[Video],
                 cls_default: int = 1) -> Dict[int, List[dict]]:
    """``videos``: (video id, [(image id, decoded BGR frame), ...] in frame
    order) pairs.  Returns {image id: submission items}."""
    results: Dict[int, List[dict]] = {}
    for _, frames in videos:
        runner.reset()
        pending: List[int] = []
        for image_id, image in frames:
            pending.append(image_id)
            done = runner.submit(image)
            if done is None:
                continue
            for tracks in (done if runner.chunk > 1 else [done]):
                results[pending.pop(0)] = tracks_to_results(tracks,
                                                            cls_default)
        for tracks in runner.flush():
            results[pending.pop(0)] = tracks_to_results(tracks, cls_default)
    return results


def save_mot_results(results: Dict[int, List[dict]], videos: Sequence[dict],
                     video_to_images: Dict[object, Sequence[dict]],
                     save_dir: str, dataset_version: str = "17halfval") -> str:
    """MOT txt writer with track renumbering
    (``deft_tpu/data/datasets/mot.py:37-60``).  ``videos``: [{"id",
    "file_name"}]; ``video_to_images``: video id -> [{"id", "frame_id"}] in
    frame order.  Returns the results directory."""
    results_dir = os.path.join(save_dir, f"results_mot{dataset_version}")
    os.makedirs(results_dir, exist_ok=True)
    for video in videos:
        tracks = defaultdict(list)
        for image_info in video_to_images[video["id"]]:
            for item in results.get(image_info["id"], ()):
                if item.get("active", 1) == 0:
                    continue
                b = item["bbox"]
                tracks[item["tracking_id"]].append(
                    [image_info["frame_id"], b[0], b[1], b[2], b[3]])
        path = os.path.join(results_dir, f"{video['file_name']}.txt")
        with open(path, "w") as f:
            for new_id, tid in enumerate(sorted(tracks), start=1):
                for t in tracks[tid]:
                    f.write(f"{t[0]},{new_id},{t[1]:.2f},{t[2]:.2f},"
                            f"{t[3] - t[1]:.2f},{t[4] - t[2]:.2f},"
                            "-1,-1,-1,-1\n")
    return results_dir
