"""Sequence tracking and the results writers, the counterpart of the
tracking path of ``test.py``, of the MOT and KITTI tracking writers of
``deft_tpu/data/datasets/`` and of ``deft_tpu/data/datasets/nuscenes.py``'s
submission.

* ``track_videos`` drives a ``PipelinedRunner`` over sequences of decoded
  frames the way ``test.py:172-210`` does: ``reset`` per sequence, ``submit``
  per frame, ``flush`` at the end, results keyed by image id
  (``cls_default=2`` on KITTI, ``test.py:184, :204``);
* ``track_videos_detector`` is the same loop through ``Detector.run``, one
  frame at a time (``test.py``'s path without a runner);
* both take ``public_dets`` ({image id: [det dicts]}, from
  ``data/public_dets.py``) for ``cfg.public_det``: each frame's boxes go in
  as ``meta["cur_dets"]`` (``test.py:181-182``);
* ``track_nuscenes`` drives ``Detector.run_multi`` over nuScenes scenes the
  way ``test.py:134-170`` does: each scene's frames in sample-major order,
  every sample's cameras as one batch;
* ``tracks_to_results`` turns a frame's tracks into submission items;
* ``save_mot_results`` writes one MOTChallenge txt per sequence, renumbering
  track ids from 1 in sorted order;
* ``save_kitti_results`` writes one KITTI tracking txt per sequence;
* ``nuscenes_submission`` builds the nuScenes tracking submission.

Scoring MOT is ``tools/eval_mot.py::evaluate_mot_dir`` on the written
directory, scoring KITTI ``tools/eval_kitti.py::evaluate_kitti_dir`` (numpy
and scipy only).  ``Detector.run`` reads an image path through
``data/image_io.py``, so ``track_videos_detector`` takes paths as well as
decoded uint8 BGR frames; the runner takes decoded frames.
"""

from __future__ import annotations

import os
from collections import defaultdict
from itertools import groupby
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from deft_tpu_torch.data.datasets import (
    KITTI_TRACKING_INFO,
    NUSCENES_CYCLES,
    NUSCENES_ID_TO_ATTRIBUTE,
    NUSCENES_INFO,
    NUSCENES_PEDESTRIANS,
    NUSCENES_TRACKING_IGNORED,
    NUSCENES_VEHICLES,
)
from deft_tpu_torch.inference.geometry import camera_box_to_global


def tracks_to_results(online, cls_default: int = 1) -> List[dict]:
    """One frame's tracks -> submission items (``test.py:43-65``).  The 2-D
    tracks carry no class of their own; a nuScenes track adds its global box
    and its class.  The class is the track's own (``test.py`` gives every
    nuScenes item ``cls_default``, which the submission then reads as
    "car")."""
    out = []
    for t in online:
        item = {"bbox": np.asarray(t.tlbr, np.float32),
                "score": float(t.score),
                "class": cls_default,
                "tracking_id": int(t.track_id),
                "active": 1 if t.is_activated else 0}
        if t.ddd_submission is not None:
            sub = np.asarray(t.ddd_submission, np.float64)
            item.update({
                "class": NUSCENES_INFO.class_name.index(t.classe) + 1,
                "translation": sub[0:3].tolist(),
                "size": sub[3:6].tolist(),
                "rotation": sub[6:10].tolist(),
                "detection_name": t.classe,
                "velocity": [0, 0],
            })
        out.append(item)
    return out


Video = Tuple[object, Sequence[Tuple[int, np.ndarray]]]


def _frame_meta(public_dets: Optional[Mapping[int, Sequence[dict]]],
                image_id) -> Optional[dict]:
    if public_dets is not None and image_id in public_dets:
        return {"cur_dets": public_dets[image_id]}
    return None


def track_videos(runner, videos: Iterable[Video], cls_default: int = 1,
                 public_dets: Optional[Mapping[int, Sequence[dict]]] = None
                 ) -> Dict[int, List[dict]]:
    """``videos``: (video id, [(image id, decoded BGR frame), ...] in frame
    order) pairs; ``public_dets``: {image id: public detections}.  Returns
    {image id: submission items}."""
    results: Dict[int, List[dict]] = {}
    for _, frames in videos:
        runner.reset()
        pending: List[int] = []
        for image_id, image in frames:
            pending.append(image_id)
            done = runner.submit(image, _frame_meta(public_dets, image_id))
            if done is None:
                continue
            for tracks in (done if runner.chunk > 1 else [done]):
                results[pending.pop(0)] = tracks_to_results(tracks,
                                                            cls_default)
        for tracks in runner.flush():
            results[pending.pop(0)] = tracks_to_results(tracks, cls_default)
    return results


def track_videos_detector(
        detector, videos: Iterable[Video], cls_default: int = 1,
        public_dets: Optional[Mapping[int, Sequence[dict]]] = None
) -> Dict[int, List[dict]]:
    """``track_videos`` through ``Detector.run``: trackers reset per
    sequence, one ``run`` per frame.  A frame may be a decoded BGR frame,
    an image path or ``run``'s prefetched ``{"images", "meta"}`` form."""
    results: Dict[int, List[dict]] = {}
    for _, frames in videos:
        detector.reset_tracking()
        for image_id, image in frames:
            online = detector.run(image, _frame_meta(public_dets, image_id))
            results[image_id] = tracks_to_results(online, cls_default)
    return results


NuScene = Tuple[object, Sequence[Tuple[dict, np.ndarray]]]


def sample_major(frames: Iterable[Tuple[dict, np.ndarray]]):
    """One scene's (image info, frame) pairs in the reference's nuScenes
    order: every camera of sample t, by sensor id, before sample t+1
    (``test.py:26-40``)."""
    return sorted(frames, key=lambda f: (f[0]["frame_id"],
                                         f[0].get("sensor_id", 1)))


def track_nuscenes(detector, scenes: Iterable[NuScene]
                   ) -> Dict[int, List[dict]]:
    """``scenes``: (scene id, [(image info, decoded BGR frame), ...]) pairs;
    an image info holds the converter's ``id``, ``frame_id``,
    ``sensor_id``, ``calib`` and camera / ego-pose records.  Trackers reset
    per scene; each sample's cameras go through one ``run_multi``.  Returns
    {image id: submission items}."""
    results: Dict[int, List[dict]] = {}
    for _, frames in scenes:
        detector.reset_tracking()
        for _, sample in groupby(sample_major(frames),
                                 key=lambda f: f[0]["frame_id"]):
            infos, images = zip(*sample)
            online = detector.run_multi(
                list(images),
                [{"calib": info["calib"]} if "calib" in info else {}
                 for info in infos],
                list(infos), materialize=tracks_to_results)
            for info, items in zip(infos, online):
                results[info["id"]] = items
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


def save_kitti_results(results: Dict[int, List[dict]], videos: Sequence[dict],
                       video_to_images: Dict[object, Sequence[dict]],
                       save_dir: str) -> str:
    """KITTI tracking txt writer
    (``deft_tpu/data/datasets/kitti_tracking.py:28-59``): per item ``frame
    track_id type -1 -1 alpha x1 y1 x2 y2 h w l x y z rot_y score`` with the
    0-based frame, the track id as it is, every item (active or not) and the
    3-D fields integer-cast, defaulted where a 2-D item has none.  Arguments
    as ``save_mot_results``'; returns the results directory."""
    results_dir = os.path.join(save_dir, "results_kitti_tracking")
    os.makedirs(results_dir, exist_ok=True)
    for video in videos:
        path = os.path.join(results_dir, f"{video['file_name']}.txt")
        with open(path, "w") as f:
            for image_info in video_to_images[video["id"]]:
                if image_info["id"] not in results:
                    continue
                frame_id = image_info["frame_id"]
                for item in results[image_info["id"]]:
                    cname = KITTI_TRACKING_INFO.class_name[item["class"] - 1]
                    alpha = item.get("alpha", -1)
                    rot_y = item.get("rot_y", -10)
                    dim = item.get("dim", [-1, -1, -1])
                    if "dim" in item:
                        dim = [max(d, 0.01) for d in item["dim"]]
                    loc = item.get("loc", [-1000, -1000, -1000])
                    tid = item.get("tracking_id", -1)
                    b = item["bbox"]
                    f.write(
                        f"{frame_id - 1} {tid} {cname} -1 -1 {int(alpha):d}"
                        f" {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f}"
                        f" {int(dim[0]):d} {int(dim[1]):d} {int(dim[2]):d}"
                        f" {int(loc[0]):d} {int(loc[1]):d} {int(loc[2]):d}"
                        f" {int(rot_y):d} {item['score']:.2f}\n")
    return results_dir


def _attribute(class_name: str, natt) -> str:
    """The attribute of a class family: the argmax of its slice of the
    8-way nuscenes_att head."""
    natt = np.asarray(natt, np.float32)
    if class_name in NUSCENES_CYCLES:
        return NUSCENES_ID_TO_ATTRIBUTE[int(np.argmax(natt[0:2])) + 1]
    if class_name in NUSCENES_PEDESTRIANS:
        return NUSCENES_ID_TO_ATTRIBUTE[int(np.argmax(natt[2:5])) + 3]
    if class_name in NUSCENES_VEHICLES:
        return NUSCENES_ID_TO_ATTRIBUTE[int(np.argmax(natt[5:8])) + 6]
    return ""


def nuscenes_submission(results: Mapping[int, Sequence[dict]],
                        image_infos: Mapping[int, dict],
                        tracking: bool = True) -> dict:
    """The nuScenes tracking / detection submission
    (``deft_tpu/data/datasets/nuscenes.py:44-134``): each item in the global
    frame (camera boxes go through the image's camera and ego-pose records),
    its attribute by class family, its velocity in the global frame, and per
    sample the 500 best by score.  ``results``: {image id: items};
    ``image_infos``: {image id: image info}."""
    ret = {
        "meta": {"use_camera": True, "use_lidar": False, "use_radar": False,
                 "use_map": False, "use_external": False},
        "results": {},
    }
    for image_id, dets in results.items():
        info = image_infos[image_id]
        trans_matrix = np.array(info["trans_matrix"], np.float64)
        sample_results = []
        for item in dets:
            class_name = (NUSCENES_INFO.class_name[int(item["class"] - 1)]
                          if "class" in item else item["detection_name"])
            if tracking and class_name in NUSCENES_TRACKING_IGNORED:
                continue
            score = float(item["score"] if "score" in item
                          else item["detection_score"])
            if "size" in item:
                size = list(item["size"])
            else:
                size = [float(item["dim"][1]), float(item["dim"][2]),
                        float(item["dim"][0])]
            if "translation" in item:
                translation = item["translation"]
            else:
                translation = trans_matrix @ np.array(
                    [item["loc"][0], item["loc"][1] - size[2],
                     item["loc"][2], 1], np.float64)
            if "rotation" in item:
                rotation = item["rotation"]
            else:
                q = camera_box_to_global(
                    item["loc"], size, item["rot_y"], info["cs_record_rot"],
                    info["cs_record_trans"], info["pose_record_rot"],
                    info["pose_record_trans"]).orientation
                rotation = [float(q.w), float(q.x), float(q.y), float(q.z)]
            att = item.get("attribute_name")
            if att is None:
                att = _attribute(class_name,
                                 item.get("nuscenes_att", np.zeros(8)))
            vel = item.get("velocity", [0, 0, 0])
            if len(vel) != 2:
                v = trans_matrix @ np.array([vel[0], vel[1], vel[2], 0],
                                            np.float64)
                vel = [float(v[0]), float(v[1])]
            sample_results.append({
                "sample_token": info["sample_token"],
                "translation": [float(t) for t in translation[:3]],
                "size": [float(v) for v in size],
                "rotation": rotation,
                "velocity": vel,
                "detection_name": class_name,
                "attribute_name": att,
                "detection_score": score,
                "tracking_name": class_name,
                "tracking_score": score,
                "tracking_id": item.get("tracking_id", 1),
                "sensor_id": info.get("sensor_id", 1),
                "det_id": item.get("det_id", -1),
            })
        ret["results"].setdefault(info["sample_token"], []).extend(
            sample_results)
    for token, dets in ret["results"].items():
        order = sorted(range(len(dets)),
                       key=lambda i: -dets[i]["detection_score"])
        ret["results"][token] = [dets[i] for i in order[:500]]
    return ret
