"""Shared by the runner test files of the port
(``test_torch_port_runner*.py``): the weights, the frames, the runs of each
case and the checks.  The files split the JAX runs between them so that
each case's interpret-mode T2 runs on a worker of its own; each builds its
module fixture with ``build_setup``.  What they hold, and why, is the
docstring below.

The pipelined tracking path: the port's ``PipelinedRunner`` vs the JAX
package's, on the CPU.

Both run ``mot_config`` at 64x96 with ``dla_node="dcn"``,
``dcn_impl="pallas"`` (the JAX T2 kernel in interpret mode, as its own tests
run it), max_object 8, K 16, the JAX runner with ``device_warp=True`` (the
port always warps on the device), on 18 raw 120x180 frames of moving
rectangles: more than ``sim_window`` + 2 = 14, so the freshest-first window
drops frames the ring still holds, and 18 = 4 * 4 + 2, so a chunk of 4 ends
in a padded partial chunk.  The weights are the JAX init with every offset
conv randomized, the heatmap head rescaled so that real detections exist
and the box heads biased so that their boxes have an extent (a box of zero
size makes IoU ties that no tolerance can order).  Random weights make
smooth heatmaps, where two neighbouring peaks can tie to float32 noise and
the two packages then keep different ones, as a batched convolution and a
single one may; the offset seed is one whose 18 frames have no such tie
(seeds 11, 12, 13 and 15 do).

Per frame the online tracks must agree: track ids exactly, boxes within
BOX_TOL pixels (float32 convolutions sum in another order in the two
packages; the boxes are Kalman states of detections within ~1e-4 px).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deft_tpu.ops.pallas_dcn as pallas_dcn
from deft_tpu.config import mot_config
from deft_tpu.data.datasets.mot import MOTDataset
from deft_tpu.inference.detector import Detector as JaxDetector
from deft_tpu.inference.runner import PipelinedRunner as JaxRunner
from deft_tpu.models import create_model as jax_create_model
from deft_tpu.models.factory import init_model as jax_init_model
from deft_tpu_torch.config import mot_config as port_mot_config
from deft_tpu_torch.convert import from_jax_variables
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.track import save_mot_results, track_videos
from tools.eval_mot import evaluate_mot_dir

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZE = dict(input_h=64, input_w=96, max_object=8, K=16, dcn_offset_range=1,
            dcn_impl="pallas")
FRAMES = 18
BOX_TOL = 1e-3            # pixels
# (chunk, chunk_batched, sims_quant)
CASES = {"step": (1, False, False), "chunk_quant": (4, False, True),
         "batched": (4, True, False)}
OBJECTS = [  # y, x, h, w, colour, (vy, vx) per frame, in 120x180 pixels
    (10, 15, 30, 18, (250, 40, 40), (2, 3)),
    (60, 120, 26, 16, (30, 220, 60), (-1, -3)),
    (35, 70, 34, 22, (40, 60, 240), (2, 1)),
    (75, 25, 22, 30, (230, 230, 30), (-2, 2)),
]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module's models: the suite runs several
    test processes on one machine, and each one's default of a thread per
    core oversubscribes it (as ``test_torch_port_nuscenes.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def gt_boxes(f):
    """tlwh of every object in frame f (clipped to the image)."""
    out = []
    for oid, (y, x, h, w, _, (vy, vx)) in enumerate(OBJECTS, start=1):
        y0, x0 = max(y + vy * f, 0), max(x + vx * f, 0)
        y1, x1 = min(y + vy * f + h, 120), min(x + vx * f + w, 180)
        if y1 > y0 and x1 > x0:
            out.append((oid, (x0, y0, x1 - x0, y1 - y0)))
    return out


def frames(n=FRAMES):
    rng = np.random.RandomState(0)
    out = []
    for f in range(n):
        img = rng.randint(0, 40, (120, 180, 3)).astype(np.uint8)
        for (_, (x0, y0, w, h)), obj in zip(gt_boxes(f), OBJECTS):
            img[y0: y0 + h, x0: x0 + w] = obj[4]
        out.append(img)
    return out


def build_setup(cases, port_only=()):
    """Yields (weights, frames, {case: (JAX tracks, port tracks)}, JAX
    runners) for the ``CASES`` named in ``cases``, and the port's tracks alone
    ((None, tracks)) for those in ``port_only``, as the module fixture of
    each runner test file builds them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_dcn, "deform_conv_pallas_tap", functools.partial(
            pallas_dcn.deform_conv_pallas_tap, interpret=True))
        cfg = mot_config(device_warp=True, **SIZE)
        model = jax_create_model(cfg.arch, cfg)
        params, stats = jax_init_model(model, cfg)
        variables = jax.tree.map(np.array, {"params": params,
                                            "batch_stats": stats})
        rng = np.random.RandomState(14)

        def randomize(tree):
            for key, v in tree.items():
                if key == "conv_offset_mask":
                    v["kernel"] = rng.normal(0, 0.01, v["kernel"].shape
                                             ).astype(np.float32)
                    v["bias"] = rng.uniform(-1.0, 1.0, v["bias"].shape
                                            ).astype(np.float32)
                elif isinstance(v, dict):
                    randomize(v)

        randomize(variables["params"])
        seq = frames()
        # random weights give a flat heatmap far below the threshold:
        # rescale the head so ~4% of the first frame's pixels score > 0.5
        image, _ = JaxDetector(cfg, model=model,
                               variables=variables).pre_process(seq[0])
        out, _ = model.apply(variables, jnp.asarray(image))
        z = np.asarray(out["hm"])
        gain = 2.0 / z.std()
        hm = variables["params"]["head_hm"]["out"]
        hm["kernel"] = (hm["kernel"] * gain).astype(np.float32)
        hm["bias"] = ((hm["bias"] - np.percentile(z, 96)) * gain).astype(
            np.float32)
        for head, bias in (("ltrb_amodal", [-4, -4, 4, 4]), ("wh", [8, 8])):
            out = variables["params"][f"head_{head}"]["out"]
            out["bias"] = (out["bias"] + np.float32(bias)).astype(np.float32)
        sd = from_jax_variables(variables, cfg)

        runs, runners = {}, {}
        for name in cases:
            chunk, batched, quant = CASES[name]
            jcfg = cfg.replace(chunk_batched=batched, sims_quant=quant)
            runners[name] = JaxRunner(JaxDetector(jcfg, model=model,
                                                  variables=variables),
                                      depth=3, chunk=chunk)
            prun = port_runner(sd, chunk, batched, quant)
            runs[name] = (runners[name].track_sequence(seq),
                          prun.track_sequence(seq))
        for name in port_only:
            runs[name] = (None, port_runner(sd, *CASES[name]).track_sequence(
                seq))
        # the JAX runners stay under the interpret patch while tests reuse
        # them
        yield sd, seq, runs, runners


def port_runner(sd, chunk, batched=False, quant=False):
    pcfg = port_mot_config(device_warp=True, chunk_batched=batched,
                           sims_quant=quant, **SIZE)
    return PipelinedRunner(Detector(pcfg, sd, device="cpu"), depth=3,
                           chunk=chunk)


def _ids(seq):
    return [[t.track_id for t in fr] for fr in seq]


def check_runner_matches_jax(setup, case):
    j_seq, p_seq = setup[2][case]
    assert len(j_seq) == len(p_seq) == FRAMES
    assert _ids(p_seq) == _ids(j_seq)
    for f, (jf, pf) in enumerate(zip(j_seq, p_seq)):
        for a, b in zip(pf, jf):
            np.testing.assert_allclose(a.tlbr, b.tlbr, rtol=0, atol=BOX_TOL,
                                       err_msg=f"{case} frame {f}")
    # a real scene: tracks are kept across frames
    assert sum(len(fr) for fr in p_seq) >= 2 * FRAMES
    assert len({t.track_id for t in p_seq[-1]}
               & {t.track_id for t in p_seq[-5]}) >= 2


def check_port_modes_agree(setup):
    """On the CPU, chunk=4 ``frame_chunk`` repeats chunk=1 ``frame_step``
    exactly, and the batched ``detect`` of ``frame_chunk_batched`` gives the
    same track ids with boxes within BOX_TOL (a batched convolution sums in
    another order)."""
    sd, seq, runs, _ = setup
    step, batched = runs["step"][1], runs["batched"][1]
    chunk = port_runner(sd, chunk=4).track_sequence(seq)
    assert _ids(step) == _ids(chunk) == _ids(batched)
    for a_fr, b_fr, c_fr in zip(step, chunk, batched):
        for a, b, c in zip(a_fr, b_fr, c_fr):
            np.testing.assert_array_equal(a.tlbr, b.tlbr)
            np.testing.assert_allclose(a.tlbr, c.tlbr, rtol=0, atol=BOX_TOL)


def check_ring_and_flags(setup):
    """The device ring after a run holds the frames' counts in order; the
    padded partial chunk marks it dirty until ``reset``; the JAX runner's
    options that the port has not ported refuse to run."""
    sd, seq, _, _ = setup
    run = port_runner(sd, chunk=4)
    run.track_sequence(seq)
    # 18 frames + 2 pad frames, all non-empty
    assert int(run.state["ptr"]) == 20
    assert run.state["counts"][:20].min() > 0
    with pytest.raises(RuntimeError):
        run.submit(seq[0])
    run.reset()
    assert int(run.state["ptr"]) == 0
    assert run.submit(seq[0]) is None
    with pytest.raises(NotImplementedError):
        run.auto_tune(seq)
    with pytest.raises(NotImplementedError):
        run.upload_parallel = True
    for flag in ("yuv_upload", "delta_upload"):
        pcfg = port_mot_config(**{flag: True}, **SIZE)
        with pytest.raises(NotImplementedError):
            PipelinedRunner(Detector(pcfg, sd, device="cpu"))


def check_submit_after_submit_warped(setup):
    """A chunk begun with ``submit_warped()`` and continued with
    ``submit()``: the JAX runner indexes a None slab there (runner.py:546,
    ROADMAP.md C); the port copies those frames into a slab at dispatch and
    tracks exactly as ``track_sequence`` does."""
    sd, seq, _, _ = setup
    want = port_runner(sd, chunk=4).track_sequence(seq[:8])
    run = port_runner(sd, chunk=4)
    got = []
    for i, frame in enumerate(seq[:8]):
        if i % 4 == 0:
            done = run.submit_warped(*run.warp(frame))
        else:
            done = run.submit(frame)
        got.extend(done or [])
    got.extend(run.flush())
    assert _ids(got) == _ids(want)
    for a_fr, b_fr in zip(got, want):
        for a, b in zip(a_fr, b_fr):
            np.testing.assert_array_equal(a.tlbr, b.tlbr)


def check_cascade_worker_under_thread_switching(setup):
    """The main thread and the cascade worker share the buffer pools and
    the timing buckets (under locks): with the interpreter switching
    threads every microsecond, a run still counts each frame once and
    tracks as test.py's run does."""
    sd, seq, runs, _ = setup
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run = port_runner(sd, chunk=1)
        got = run.track_sequence(seq[:10])
        done = run._frames_done
    finally:
        sys.setswitchinterval(interval)
    assert done == 10
    assert _ids(got) == _ids(runs["step"][1][:10])


def _jax_tracks_to_results():
    spec = importlib.util.spec_from_file_location(
        "deft_test_entry", os.path.join(ROOT, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tracks_to_results


def check_mot_txt_and_scores_match_jax(setup, tmp_path):
    """test.py's sequence loop on two videos: the JAX runner with test.py's
    ``tracks_to_results`` and ``MOTDataset.save_results``, the port's
    ``track_videos`` and ``save_mot_results``.  The MOT txt files are
    identical, and tools/eval_mot.py scores them alike."""
    sd, seq, _, runners = setup
    # the JAX runner of test.py, reused (compiled)
    jrun = runners["step"]
    videos = [{"id": 1, "file_name": "SYN-01"}, {"id": 2, "file_name": "SYN-02"}]
    clips = {1: seq[:10], 2: seq[6:]}
    video_to_images, image_frames = {}, {}
    for vid, clip in clips.items():
        infos = [{"id": 100 * vid + i, "frame_id": i + 1}
                 for i in range(len(clip))]
        video_to_images[vid] = infos
        image_frames[vid] = [(info["id"], fr) for info, fr in zip(infos, clip)]

    tracks_to_results = _jax_tracks_to_results()
    j_results = {}
    for vid in clips:                 # test.py:172-210
        jrun.reset()
        pending = []
        for image_id, image in image_frames[vid]:
            pending.append(image_id)
            done = jrun.submit(image, {})
            if done is not None:
                j_results[pending.pop(0)] = tracks_to_results(done)
        for done in jrun.flush():
            j_results[pending.pop(0)] = tracks_to_results(done)

    p_results = track_videos(port_runner(sd, chunk=1),
                             [(vid, image_frames[vid]) for vid in clips])
    assert sorted(p_results) == sorted(j_results)

    class Stub:                       # what MOTDataset.save_results reads
        dataset_version = "17halfval"

        class coco:
            dataset = {"videos": videos}

    Stub.video_to_images = video_to_images
    j_dir = MOTDataset.save_results(Stub, j_results, str(tmp_path / "jax"))
    p_dir = save_mot_results(p_results, videos, video_to_images,
                             str(tmp_path / "port"))
    for video in videos:
        name = f"{video['file_name']}.txt"
        with open(os.path.join(j_dir, name)) as f:
            j_txt = f.read()
        with open(os.path.join(p_dir, name)) as f:
            assert f.read() == j_txt
        assert j_txt.count("\n") >= 10

    gt_root = tmp_path / "gt"
    for video in videos:
        path = gt_root / video["file_name"] / "gt"
        path.mkdir(parents=True)
        start = 0 if video["id"] == 1 else 6
        lines = [f"{i + 1},{oid},{x},{y},{w},{h},1,1,1\n"
                 for i in range(len(clips[video["id"]]))
                 for oid, (x, y, w, h) in gt_boxes(start + i)]
        (path / "gt.txt").write_text("".join(lines))
    j_m = evaluate_mot_dir(str(gt_root), j_dir)["overall"]
    p_m = evaluate_mot_dir(str(gt_root), p_dir)["overall"]
    assert (p_m["mota"], p_m["idf1"]) == (j_m["mota"], j_m["idf1"])
    assert p_m["num_objects"] > 0
