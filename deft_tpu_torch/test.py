"""Sequence tracking evaluation, the counterpart of the JAX package's root
``test.py``:

    python -m deft_tpu_torch.test tracking --dataset mot \\
        --dataset_version 17halfval --ltrb_amodal --track_thresh 0.4 \\
        --pre_thresh 0.5 --load_model model_mot.pth --compute_dtype bfloat16

The flags are the JAX ``test.py``'s (``cli.py``), so each line of
``experiments/*.sh`` runs as it is.  ``--gpus -1`` runs on the CPU; by
default the run is on ``cuda:0``, and it raises where there is no card.

The loop is the JAX one (``test.py:67-254``), built on ``track.py``: the
split's images grouped by video (``group_videos``; sample-major on
nuScenes), frames read with ``data/image_io.imread`` (a frame that does not
read is skipped), then

* MOT, KITTI, COCO and custom datasets: ``track_videos`` through a
  ``PipelinedRunner`` (the runner resets per video; KITTI items take
  class 2);
* nuScenes: ``track_nuscenes``, each sample's cameras through one
  ``Detector.run_multi`` with their ``calib``;
* under ``--debug`` > 0 (``test.py:98-110``), every dataset frame by frame
  through ``track_videos_detector`` -> ``Detector.run``, which saves the
  debug boards under ``<save_dir>/debug/`` (at ``--debug 2`` with the
  raw heatmap's board, a second forward on the card).

``--save_video`` writes each video's frames with their tracks drawn
(``utils/visualize.py::plot_tracking``) to ``<save_dir>/video_<id>.mp4``
(``VideoWriter``: where cv2 is missing, PNG frames in
``<save_dir>/video_<id>/``).

Under ``--public_det --load_results <json>`` the file's detections
(``data/public_dets.py::load_results``) feed the frames they name.  The
results go through the dataset's ``run_eval`` (the writers of ``track.py``
and ``tools/eval_*.py``), whose value ``main`` returns; ``--save_results``
also writes ``save_results_<dataset>.json``, and ``--profile <dir>``
exports a ``torch.profiler`` trace of the loop there.

The JAX loop reads each video's first frame to set the detector's
``img_height`` / ``img_width``, which nothing reads; the port's detector
and runner take every frame's own size (its ``meta``, the ``parity_tf`` of
``embed_parity`` included), so there is no probe.  Its per-frame ``calib``
reaches only the 3-D decoding, so the runner's 2-D lines go without it and
the nuScenes rig and ``Detector.run`` take it from each image info.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


def group_videos(dataset, sample_major: bool = False):
    """video_id -> image infos sorted by frame_id (``test.py:26-40``);
    ``sample_major`` orders every sensor of frame t before frame t+1."""
    videos = defaultdict(list)
    for info in dataset.coco.dataset["images"]:
        videos[info["video_id"]].append(info)
    for infos in videos.values():
        if sample_major:
            infos.sort(key=lambda ii: (ii["frame_id"], ii.get("sensor_id", 1)))
        else:
            infos.sort(key=lambda ii: (ii.get("sensor_id", 1), ii["frame_id"]))
    return videos


class FrameReader:
    """Reads a video's frames with ``image_io.imread``, skipping those that
    do not read, and keeps the count and the host seconds spent reading."""

    def __init__(self, img_dir: str):
        self.img_dir = img_dir
        self.frames = 0
        self.seconds = 0.0

    def read(self, info):
        from deft_tpu_torch.data.image_io import imread

        t0 = time.perf_counter()
        image = imread(os.path.join(self.img_dir, info["file_name"]))
        self.seconds += time.perf_counter() - t0
        self.frames += image is not None
        return image

    def video(self, infos, with_info: bool = False):
        """(image id or info, frame) pairs of the frames that read."""
        for info in infos:
            image = self.read(info)
            if image is not None:
                yield (info if with_info else info["id"]), image


def main(argv=None, stats: Optional[dict] = None):
    """Run the test line ``argv``; returns ``run_eval``'s value.  A dict
    passed as ``stats`` receives ``frames``, ``seconds`` (the tracking loop,
    image reads included) and ``read_seconds``."""
    from deft_tpu_torch.cli import parse_config

    cfg, extras = parse_config(argv)
    cfg = cfg.replace(dataset=cfg.test_dataset or cfg.dataset)

    import torch

    from deft_tpu_torch.data.datasets import get_dataset
    from deft_tpu_torch.data.public_dets import load_results
    from deft_tpu_torch.inference.detector import Detector
    from deft_tpu_torch.inference.runner import PipelinedRunner
    from deft_tpu_torch.models.factory import resolve_device
    from deft_tpu_torch.track import (track_nuscenes, track_videos,
                                      track_videos_detector)
    from deft_tpu_torch.utils.logger import Logger
    from deft_tpu_torch.utils.visualize import VideoWriter, plot_tracking

    device = resolve_device(extras["device"])
    logger = Logger(cfg)
    dataset = get_dataset(cfg.dataset)(
        cfg, "val",
        data_dir=os.path.join(extras["data_dir"], _dataset_dirname(cfg)))
    detector = Detector(cfg, device=device)
    public = (load_results(cfg.load_results)
              if cfg.public_det and cfg.load_results else None)
    nuscenes = cfg.dataset == "nuscenes"
    # the debug boards come from Detector.run: no runner, no batched rig
    debug = cfg.debug > 0
    runner = None if nuscenes or debug else PipelinedRunner(detector)
    cls_default = 2 if cfg.dataset == "kitti_tracking" else 1
    reader = FrameReader(dataset.img_dir)

    if cfg.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof_ctx = profile(activities=activities)
    else:
        prof_ctx = contextlib.nullcontext()
    results: Dict[int, list] = {}
    t_start = time.perf_counter()
    with prof_ctx as prof:
        for video_id, infos in group_videos(dataset, nuscenes).items():
            writer = sink = None
            if cfg.save_video:
                writer = VideoWriter(os.path.join(cfg.save_dir,
                                                  f"video_{video_id}.mp4"))

                def sink(image_id, frame, tracks, writer=writer):
                    writer.write(plot_tracking(frame, tracks,
                                               frame_id=image_id))
            if nuscenes and not debug:
                results.update(track_nuscenes(
                    detector, [(video_id, reader.video(infos, True))],
                    frame_sink=sink))
                done = "(batched rig)"
            elif runner is not None:
                results.update(track_videos(
                    runner, [(video_id, reader.video(infos))], cls_default,
                    public_dets=public, frame_sink=sink))
                done = ""
            else:
                results.update(track_videos_detector(
                    detector, [(video_id, reader.video(infos))], cls_default,
                    public_dets=public, frame_sink=sink,
                    image_infos={info["id"]: info for info in infos}))
                done = ""
            if writer is not None:
                writer.release()
            logger.write(f"video {video_id}: {len(infos)} frames done "
                         f"{done}".rstrip())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t_start
    if cfg.profile:
        os.makedirs(cfg.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile, "trace.json"))
    logger.write(f"tracked {reader.frames} frames at "
                 f"{reader.frames / max(seconds, 1e-6):.2f} FPS")
    if stats is not None:
        stats.update(frames=reader.frames, seconds=seconds,
                     read_seconds=reader.seconds)

    os.makedirs(cfg.save_dir, exist_ok=True)
    if cfg.save_results:
        with open(os.path.join(cfg.save_dir,
                               f"save_results_{cfg.dataset}.json"), "w") as f:
            json.dump({str(k): _jsonable(v) for k, v in results.items()}, f)
    eval_kw = {}
    if cfg.dataset == "mot":
        eval_kw["gt_dir"] = os.path.join(extras["data_dir"],
                                         _dataset_dirname(cfg), "train")
    elif cfg.dataset == "kitti_tracking":
        eval_kw["gt_dir"] = os.path.join(extras["data_dir"],
                                         _dataset_dirname(cfg), "label_02")
    metrics = dataset.run_eval(results, cfg.save_dir, **eval_kw)
    logger.close()
    return metrics


def _jsonable(items):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in it.items()} for it in items]


def _dataset_dirname(cfg):
    if cfg.dataset == "mot":
        year = int(cfg.dataset_version[:2]) if cfg.dataset_version else 17
        return f"mot{year}"
    return cfg.dataset


if __name__ == "__main__":
    main()
