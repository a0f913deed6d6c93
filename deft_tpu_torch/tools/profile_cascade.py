"""Per-frame cost of the host association cascade at the bench's load, the
counterpart of ``tools/profile_cascade.py`` on the port's ``Tracker``:

    python -m deft_tpu_torch.tools.profile_cascade [--frames 100] \
        [--dets 100] [--worker] [--lstm] [--churn] [--cprofile]

The bench's ``cascade`` bucket (``runner._finish_frame``) is
post-processing plus ``Tracker.update``; this harness feeds the tracker the
same synthetic load without a model: K detections per frame (drifting boxes
so that tracks persist, a 10% churn band that spawns and drops some) and
freshest-first window similarities that reward the true identities.
``--churn`` is an untrained net's regime instead (random boxes and noise
similarities: tracks churn and the pools grow to several hundred, the
bench's max-load shape).  ``--lstm`` steps the LSTM motion model (seeded
weights) in place of the Kalman filter; ``--worker`` runs each update on one
worker thread, as the runner's cascade worker does, so that the hand-off is
counted; ``--cprofile`` prints the 30 costliest calls.  Set
``DEFT_USE_NATIVE=1`` to assign with the C++ solver (``native/``).

The tracker and its motion model run on the CPU, as the JAX harness
forces: this measures the host's cascade alone.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

WINDOW = 12     # similarity rows: freshness_window("mot") + 2


def synth_frame_dets(t: int, n: int, rng) -> list:
    """Frame t's detections: identity i drifts smoothly; the last 10% of the
    identities come and go (``tools/profile_cascade.py:31-49``)."""
    dets = []
    for i in range(n):
        if i > n * 0.9 and (t // 7 + i) % 3 == 0:
            continue
        cx = 100.0 + (i % 20) * 90.0 + 2.0 * t + 3.0 * np.sin(0.1 * t + i)
        cy = 80.0 + (i // 20) * 180.0 + 1.0 * np.cos(0.07 * t + i)
        w = 46.0 + (i % 5) * 4
        h = 98.0 + (i % 7) * 3
        dets.append({
            "bbox": np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                             np.float32),
            "score": 0.6 + 0.4 * rng.rand(),
            "class": 1,
        })
    return dets


def synth_sims(frame_ids: list, max_obj: int, window: int, id_of: dict,
               rng) -> np.ndarray:
    """Freshest-first [window, M, M+1] similarity: noise, and 0.92-0.98
    where a buffered frame's row and the current frame's column are one
    identity (``tools/profile_cascade.py:52-67``)."""
    f = min(len(frame_ids), window)
    sims = rng.rand(window, max_obj, max_obj + 1).astype(np.float32) * 0.25
    for rank in range(f):
        pre_ids = id_of[frame_ids[-(rank + 1)]]
        cur_ids = id_of["cur"]
        for r, pid in enumerate(pre_ids):
            if pid is not None and pid in cur_ids:
                sims[rank, r, cur_ids.index(pid)] = 0.92 + 0.06 * rng.rand()
    return sims


def make_frames(n_frames: int, n_dets: int, churn: bool, rng,
                window: int = WINDOW) -> list:
    """The whole load, (detections, sims) per frame, made before the timed
    loop so that it times the cascade alone (``tools/profile_cascade.py:
    100-135``)."""
    max_obj = n_dets
    frame_ids: list = []
    id_of: dict = {}
    frames = []
    for t in range(n_frames):
        if churn:
            dets = []
            for _ in range(n_dets):
                x1 = rng.rand() * 1800
                y1 = rng.rand() * 1000
                dets.append({
                    "bbox": np.array([x1, y1, x1 + 30 + rng.rand() * 120,
                                      y1 + 40 + rng.rand() * 160],
                                     np.float32),
                    "score": rng.rand(),
                    "class": 1,
                })
            sims = (rng.rand(window, max_obj, max_obj + 1)
                    .astype(np.float32) * 0.6)
            frames.append((dets, sims))
            continue
        dets = synth_frame_dets(t, n_dets, rng)
        ids = [i for i in range(n_dets)
               if not (i > n_dets * 0.9 and (t // 7 + i) % 3 == 0)]
        id_of["cur"] = ids
        sims = synth_sims(frame_ids, max_obj, window, id_of, rng)
        fid = t + 1
        frame_ids.append(fid)
        id_of[fid] = ids + [None] * (max_obj - len(ids))
        if len(frame_ids) > 50:
            id_of.pop(frame_ids.pop(0), None)
        frames.append((dets, sims[:window]))
    return frames


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--dets", type=int, default=100)
    ap.add_argument("--dataset", default="mot")
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--worker", action="store_true",
                    help="run each update on one worker thread, as the "
                         "runner's cascade worker does")
    ap.add_argument("--lstm", action="store_true",
                    help="the LSTM motion model in place of the Kalman filter")
    ap.add_argument("--churn", action="store_true",
                    help="an untrained net's regime: random boxes and noise "
                         "similarities")
    args = ap.parse_args(argv)

    from deft_tpu_torch.tracking.motion_lstm import LSTMMotion
    from deft_tpu_torch.tracking.tracker import Tracker

    rng = np.random.RandomState(0)
    motion = LSTMMotion(args.dataset, device="cpu") if args.lstm else None
    tracker = Tracker(args.dataset, args.dets, 128, similarity_fn=None,
                      use_lstm=args.lstm, motion=motion, device="cpu")
    frames = make_frames(args.frames, args.dets, args.churn, rng)
    pool = ThreadPoolExecutor(max_workers=1) if args.worker else None

    def run():
        ts = []
        for dets, sims in frames:
            t0 = time.perf_counter()
            if pool is None:
                tracker.update(dets, None, sims=sims)
            else:
                pool.submit(tracker.update, dets, None, sims=sims).result()
            ts.append(time.perf_counter() - t0)
        return ts

    if args.cprofile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        ts = run()
        prof.disable()
        pstats.Stats(prof).sort_stats("cumulative").print_stats(30)
    else:
        ts = run()
    if pool is not None:
        pool.shutdown()

    arr = np.array(ts[10:] or ts) * 1000.0
    out = {"mean": float(arr.mean()), "p50": float(np.median(arr)),
           "p90": float(np.percentile(arr, 90)), "max": float(arr.max()),
           "tracked": len(tracker.tracked_stracks),
           "lost": len(tracker.lost_stracks),
           "removed": len(tracker.removed_stracks)}
    print(f"cascade ms/frame: mean {out['mean']:.2f}  p50 {out['p50']:.2f}"
          f"  p90 {out['p90']:.2f}  max {out['max']:.2f}")
    print(f"tracks: tracked={out['tracked']} lost={out['lost']} "
          f"removed={out['removed']}")
    return out


if __name__ == "__main__":
    main()
