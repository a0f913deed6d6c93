"""The spans and counters of the tracking loop (``utils/spans.py``), on the
CPU, with a seeded 96x160 DLA-34 (conv nodes, K 16, ``track_thresh``
1e-3 so that every candidate reaches the cascade):

* the recorder: nesting, CPU ms within wall ms, counters, ``reset()``,
  kept spans with their parents and inherited ids;
* ``record_function`` only while a profiler records: with it patched to
  raise, the runner and ``Detector.run`` run; under a CPU
  ``torch.profiler`` the trace holds the main thread's spans (``warp``,
  ``dispatch``, ``program.*``) and none of the cascade worker's;
* kept spans: each frame id once under ``warp`` and once under
  ``cascade``, chunk ids joining ``dispatch``, ``fetch_wait`` and
  ``casc_wait``, ``spans.jsonl`` on the trace's clock;
* ``timings()``: every key it had, ``<span>.cpu``, the counters against
  the tracker's own lists, the ``program.*`` spans inside ``dispatch``
  on every frame program;
* ``bench --smoke --profile`` and ``test --profile`` write ``spans.jsonl``
  beside ``trace.json``.
"""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from deft_tpu_torch.config import mot_config
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.utils.spans import Spans

SIZE = dict(input_h=96, input_w=160, max_object=8, K=16, dla_node="conv",
            track_thresh=1e-3)
FRAMES = 8
CHUNK = 4
# the keys timings() returned before it read the spans (stage_wait only
# under force_resident on a card, where an upload has an event)
BUCKETS = {"warp", "host_prep", "upload", "dispatch", "casc_wait",
           "fetch_wait", "cascade", "casc_post", "casc_desims", "casc_track"}
PROGRAM = {"program.warp", "program.forward", "program.decode",
           "program.embed", "program.tail"}
TRACKER = {"tracker.predict", "tracker.affinity", "tracker.assign",
           "tracker.iou", "tracker.births", "tracker.bookkeeping"}
WORKER = {"fetch_wait", "cascade", "casc_post", "casc_desims",
          "casc_track"} | TRACKER
COUNTERS = {"n.dets", "n.matched", "n.births", "n.tracks_held",
            "n.tracks_removed"}
CLOCK_US = 100.0          # a kept span against its record_function twin


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def frames(n=FRAMES):
    """Noise frames of 120x200, warped to the 96x160 input."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def det():
    torch.manual_seed(0)
    return Detector(mot_config(**SIZE), device="cpu")


def make_runner(det, chunk, batched=False):
    run = PipelinedRunner(det, depth=2, chunk=chunk)
    run.cfg = run.cfg.replace(chunk_batched=batched)
    return run


class Loads:
    """Wraps the tracker's ``update``: per frame the detections it took,
    and its held and removed tracks after it."""

    def __init__(self, tracker):
        self.rows = []
        inner = tracker.update

        def update(results, *a, **kw):
            out = inner(results, *a, **kw)
            self.rows.append((len(results), len(tracker.tracked_stracks)
                              + len(tracker.lost_stracks),
                              len(tracker.removed_stracks)))
            return out

        tracker.update = update


@pytest.fixture(scope="module")
def profiled(det, tmp_path_factory):
    """A chunk-4 batched run under a CPU profiler with its spans kept:
    (runner, directory, export's record, tracker loads, trace events)."""
    d = tmp_path_factory.mktemp("profile")
    run = make_runner(det, CHUNK, batched=True)
    loads = Loads(run.det.tracker)
    run.spans.keep = True
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run.track_sequence(frames())
    assert len(out) == FRAMES
    prof.export_chrome_trace(str(d / "trace.json"))
    info = run.spans.export(str(d))
    with open(d / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return run, d, info, loads, events


def read_spans(directory):
    with open(directory / "spans.jsonl") as f:
        return [json.loads(line) for line in f]


def annotations(events):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_nest_time_and_count():
    spans = Spans(("stage",))
    assert spans.count == {"stage": 0} and spans.mean_ms() == {"stage": 0.0}
    with spans.span("outer", chunk=3):
        with spans.span("inner", frame=5):
            time.sleep(0.02)
        sum(range(200000))
    spans.add("dets", 4)
    spans.add("dets", 2)
    t = spans.per_frame(2)
    assert t["outer"] >= t["inner"] >= 10.0          # 20 ms over 2 frames
    for name in ("outer", "inner"):
        assert 0.0 <= t[f"{name}.cpu"] <= t[name]
    assert t["inner.cpu"] < t["inner"] / 2           # a sleep is off-CPU
    assert t["outer.cpu"] > t["inner.cpu"]           # the sum ran on it
    assert t["n.dets"] == 3.0
    assert spans.count == {"stage": 0, "outer": 1, "inner": 1}
    assert spans.mean_ms()["inner"] >= 20.0
    spans.reset()
    assert spans.per_frame(1) == {"stage": 0.0, "stage.cpu": 0.0}
    assert spans.count == {"stage": 0} and not spans.kept


def test_kept_spans_inherit_ids_per_thread():
    spans = Spans()
    spans.keep = True

    def worker():
        with spans.span("cascade", chunk=1, frame=7):
            with spans.span("casc_track"):
                pass

    with spans.span("dispatch", chunk=1):
        with spans.span("program.forward"):
            th = threading.Thread(target=worker, name="worker")
            th.start()
            th.join(timeout=10)
    assert not th.is_alive()
    by_name = {k.name: k for k in spans.kept}
    assert len(by_name) == 4
    fwd, track = by_name["program.forward"], by_name["casc_track"]
    assert (fwd.parent, fwd.chunk, fwd.frame) == (
        by_name["dispatch"].id, 1, None)
    assert (track.parent, track.chunk, track.frame) == (
        by_name["cascade"].id, 1, 7)
    assert by_name["cascade"].parent is None      # another thread's stack
    assert track.thread == "worker" and fwd.thread != "worker"
    for k in spans.kept:
        assert k.t0 <= k.t1 and 0 <= k.cpu_ns <= k.t1 - k.t0


def test_no_record_function_without_profiler(det, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run = make_runner(det, CHUNK, batched=True)
    assert len(run.track_sequence(frames())) == FRAMES
    assert run.timings()["dispatch"] > 0
    det.reset_tracking()
    det.run(frames(1)[0])
    assert det.timers.count["tot"] >= 1


def test_profiler_sees_main_thread_spans_only(profiled):
    _, _, _, _, events = profiled
    names = Counter(e["name"] for e in annotations(events))
    assert {"warp", "host_prep", "upload", "dispatch", "runner.fetch",
            "casc_wait"} | PROGRAM <= set(names), names
    assert not WORKER & set(names), WORKER & set(names)
    assert names["warp"] == FRAMES and names["dispatch"] == FRAMES // CHUNK
    assert names["program.tail"] == FRAMES
    ours = set(names) & ({"warp", "dispatch"} | PROGRAM)
    tids = {e["tid"] for e in annotations(events) if e["name"] in ours}
    assert len(tids) == 1


def test_kept_spans_join_by_ids(profiled):
    run, d, info, _, _ = profiled
    spans = read_spans(d)
    assert info["spans"] == len(spans) and info["offset_us"] is not None
    frames_of = {name: Counter(s["frame"] for s in spans
                               if s["name"] == name)
                 for name in ("warp", "cascade")}
    for name, seen in frames_of.items():
        assert seen == Counter(range(FRAMES)), (name, seen)
    chunks = {name: sorted(s["chunk"] for s in spans if s["name"] == name)
              for name in ("dispatch", "fetch_wait", "casc_wait")}
    assert chunks["dispatch"] == list(range(FRAMES // CHUNK))
    assert chunks["fetch_wait"] == chunks["casc_wait"] == chunks["dispatch"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in TRACKER:
            parent = by_id[s["parent"]]
            assert parent["name"] == "casc_track"
            assert s["frame"] == by_id[parent["parent"]]["frame"]
        assert s["start_us"] <= s["end_us"] and s["cpu_ms"] >= 0.0
        if s["name"] in WORKER:
            # no twin: its own clocks, shifted
            assert s["thread"] != threading.main_thread().name
            assert s["cpu_ms"] <= (s["end_us"] - s["start_us"]) / 1e3


def test_spans_jsonl_on_the_trace_clock(profiled):
    """The main thread's spans lie on their twins; the worker's, shifted
    by the twins' median offset, keep the order the pipeline forces across
    the threads: a chunk's copy is waited for after its dispatch, and its
    ``casc_wait`` ends after its frames' cascades."""
    _, d, info, _, events = profiled
    spans = read_spans(d)
    main = threading.main_thread().name
    theirs = {}
    for e in annotations(events):
        theirs.setdefault(e["name"], []).append(float(e["ts"]))
    checked = 0
    for name, ts in theirs.items():
        mine = sorted(s["start_us"] for s in spans
                      if s["name"] == name and s["thread"] == main)
        if not mine:
            continue
        assert len(mine) == len(ts), name
        for a, b in zip(mine, sorted(ts)):
            assert abs(a - b) <= CLOCK_US, (name, a - b)
            checked += 1
    assert checked >= FRAMES * 3
    by_chunk = {}
    for s in spans:
        if s["chunk"] is not None and s["parent"] is None:
            by_chunk.setdefault((s["name"], s["chunk"]), []).append(s)
    for c in range(FRAMES // CHUNK):
        (dispatch,) = by_chunk[("dispatch", c)]
        (fetch,) = by_chunk[("fetch_wait", c)]
        (wait,) = by_chunk[("casc_wait", c)]
        cascades = by_chunk[("cascade", c)]
        assert len(cascades) == CHUNK and fetch["thread"] != main
        assert fetch["start_us"] >= dispatch["end_us"] - CLOCK_US
        assert wait["end_us"] >= max(x["end_us"] for x in cascades) - CLOCK_US


def test_timings_keys_and_program_within_dispatch(profiled):
    run, d, _, loads, _ = profiled
    t = run.timings()
    spans = {s["name"] for s in read_spans(d)}
    assert BUCKETS | PROGRAM | TRACKER | {"runner.fetch"} <= set(t)
    assert {f"{k}.cpu" for k in spans} <= set(t)
    assert COUNTERS <= set(t)
    assert sum(t[k] for k in PROGRAM) + t["runner.fetch"] <= t["dispatch"]
    assert sum(t[k] for k in TRACKER) <= t["casc_track"]
    assert t["casc_post"] + t["casc_desims"] + t["casc_track"] <= t["cascade"]
    rows = np.array(loads.rows, np.float64)
    assert len(rows) == FRAMES
    np.testing.assert_allclose(
        [t["n.dets"], t["n.tracks_held"], t["n.tracks_removed"]],
        rows.mean(axis=0))
    assert t["n.dets"] > 0 and t["n.tracks_held"] > 0
    assert 0 < t["n.matched"] + t["n.births"] <= t["n.dets"]
    # per chunk, its program spans lie within its dispatch
    kept = read_spans(d)
    for s in kept:
        if s["name"] == "dispatch":
            inner = [k for k in kept if k["parent"] == s["id"]]
            assert {k["name"] for k in inner} == PROGRAM | {"runner.fetch"}
            assert sum(k["end_us"] - k["start_us"] for k in inner) <= (
                s["end_us"] - s["start_us"])


@pytest.mark.parametrize("chunk,batched", [(1, False), (CHUNK, False)])
def test_every_frame_program_has_program_spans(det, chunk, batched):
    run = make_runner(det, chunk, batched)
    assert len(run.track_sequence(frames())) == FRAMES
    t = run.timings()
    assert PROGRAM <= set(t) and BUCKETS <= set(t)
    assert sum(t[k] for k in PROGRAM) <= t["dispatch"]
    assert run.spans.count["program.tail"] == FRAMES
    assert run.spans.count["dispatch"] == FRAMES // chunk
    run.reset()
    assert run.timings() == {}


def test_detector_run_stages_reach_the_trace(det):
    det.reset_tracking()
    det.timers.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for frame in frames(2):
            det.run(frame)
    names = {e.key for e in prof.key_averages()}
    assert {"pre", "net", "post", "track", "tot"} <= names
    assert det.timers.count == {"pre": 2, "net": 2, "post": 2, "track": 2,
                                "tot": 2}
    means = det.timers.mean_ms()
    assert means["tot"] >= means["net"] > 0


def test_bench_profile_writes_spans(tmp_path, capsys):
    from deft_tpu_torch import bench

    out = bench.main(["--smoke", "--fp32", "--profile", str(tmp_path)])
    capsys.readouterr()
    assert {"trace.json", "spans.jsonl"} <= {p.name
                                             for p in tmp_path.iterdir()}
    # the CPU has no device lanes: no busy time, so no mfu
    assert out["device_busy_ms_per_frame"] == 0.0
    assert "mfu" not in out and "device_ms" not in out
    assert 0 <= out["t_dispatch_wait_ms"] <= out["t_dispatch_ms"]
    assert out["n_dets"] > 0 and "n_tracks_held" in out
    spans = read_spans(tmp_path)
    assert {s["chunk"] for s in spans if s["name"] == "dispatch"}
    assert len([s for s in spans if s["name"] == "cascade"]) == 12


def test_test_entry_profile_writes_spans(tmp_path):
    from deft_tpu_torch import test as port_test
    from deft_tpu_torch.tools.convert_mot_to_coco import convert
    from deft_tpu_torch.tools.make_synthetic_mot import make_sequence

    data = tmp_path / "data" / "mot17"
    make_sequence(str(data / "train"), "SYN-01", n_frames=8, w=192, h=128,
                  n_obj=3, seed=1)
    convert(str(data), "train", half=True)
    prof = tmp_path / "prof"
    port_test.main(["tracking", "--dataset", "mot", "--dataset_version",
                    "17halfval", "--ltrb_amodal", "--input_h", "64",
                    "--input_w", "96", "--dla_node", "conv", "--max_object",
                    "8", "--track_thresh", "0.001", "--gpus", "-1",
                    "--data_dir", str(tmp_path / "data"), "--exp_dir",
                    str(tmp_path / "exp"), "--exp_id", "spans",
                    "--profile", str(prof)])
    spans = read_spans(prof)
    warp = [s["frame"] for s in spans if s["name"] == "warp"]
    assert warp and sorted(warp) == list(range(len(warp)))
    assert sorted(s["frame"] for s in spans
                  if s["name"] == "cascade") == sorted(warp)
    assert all(s["chunk"] is not None for s in spans
               if s["name"] == "dispatch")
