"""The frame programs as CUDA graphs (``PipelinedRunner.run_program``).

On the CPU, with a seeded 96x160 DLA-34 (conv nodes, K 16, ``track_thresh``
1e-3, the device warp), and a stand-in for the captured graph that runs
the program it was handed on its static input at each replay:

* the rule: graphs engage on a card, and not under delta uploads or public
  detections (nor on the CPU);
* the key: each thing the program bakes in gives a new one;
* the lifecycle: eager on a key's first dispatch, a capture on its first
  since a reset, replays after it; the outputs and the ring those of an
  eager run; the counters and spans in ``timings()``; the device warp's
  matrices held by the graph that reads them.

On the card (marked ``cuda``; no JAX, so it runs where only PyTorch is):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_graphs.py

eager dispatches against captured and replayed ones, bit for bit: the
outputs, the ring after every chunk and the DCN launch counters, at the
benchmark's 544x960 bf16 (chunk 4 batched, and chunk 1), again after a
reset, with a method rebound after the reset, with the model's cache of
the warp's matrices dropped under a live graph, and at a small size under
``flip_test``, YUV uploads, KITTI's class filter and the unbatched chunk.
"""

import numpy as np
import pytest
import torch

import deft_tpu_torch.inference.runner as runner_mod
from deft_tpu_torch.bench import make_synthetic_frame
from deft_tpu_torch.config import kitti_config, mot_config
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import PipelinedRunner
from deft_tpu_torch.ops import cuda_dcn

SIZE = dict(input_h=96, input_w=160, max_object=8, K=16, dla_node="conv",
            track_thresh=1e-3, device_warp=True)
GRAPH_COUNTERS = ("eager_programs", "graph_captures", "graph_replays")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def det():
    torch.manual_seed(0)
    return Detector(mot_config(**SIZE), device="cpu")


def frames(n, h=120, w=200):
    return [make_synthetic_frame(t, h, w) for t in range(n)]


def make_runner(det, chunk, batched=True, stacked=True):
    run = PipelinedRunner(det, depth=2, chunk=chunk)
    run.cfg = run.cfg.replace(chunk_batched=batched)
    run.stacked = stacked and chunk > 1
    return run


class FakeGraph:
    """The CPU's stand-in for ``runner._FrameGraph``: a capture keeps the
    program and a copy of its images as the static input; a replay copies
    its images there and runs the program on them."""

    def __init__(self, call, images):
        self.call = call
        self.images = images.clone()
        self.held = ()
        self.replays = 0

    def replay(self, images):
        self.images.copy_(images)
        self.replays += 1
        return self.call(self.images)


def record(run):
    """Per dispatch, the program's outputs and the ring after it, as the
    runner's ``_fetch`` receives them (in place of an earlier record)."""
    rows = []
    run.__dict__.pop("_fetch", None)
    inner = run._fetch

    def fetch(sims, packed=None):
        rows.append((packed.clone(), sims.clone(),
                     {k: v.clone() for k, v in run.state.items()}))
        return inner(sims, packed)

    run._fetch = fetch
    return rows


def same_bits(a, b):
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def assert_same_rows(got, want):
    assert len(got) == len(want)
    for (p, s, ring), (p0, s0, ring0) in zip(got, want):
        assert same_bits(p, p0) and same_bits(s, s0)
        assert set(ring) == set(ring0)
        assert all(same_bits(ring[k], ring0[k]) for k in ring)


@pytest.mark.parametrize("mode,engage", [("plain", True), ("delta", False),
                                         ("public", False)])
def test_graphs_engage_on_a_card_where_state_is_in_place(det, monkeypatch,
                                                         mode, engage):
    flags = {"plain": {}, "delta": dict(device_warp=False, delta_upload=True),
             "public": dict(public_det=True)}[mode]
    monkeypatch.setattr(det, "cfg", det.cfg.replace(**flags))
    run = PipelinedRunner(det, depth=2, chunk=4)
    assert run._graphs_on is False
    run.track_sequence(frames(4))
    assert run.timings()["n.eager_programs"] > 0
    assert not {"n.graph_captures", "n.graph_replays"} & set(run.timings())
    # the same runner's rule on a card
    run.device = torch.device("cuda")
    assert run._graphs_engage() is engage


@pytest.mark.parametrize("change", ["warp_tf", "chunk", "dtype", "out_thresh",
                                    "parity_tf", "flip_test"])
def test_graph_key_changes_with_what_the_program_bakes_in(det, change):
    run = make_runner(det, 4)
    _, meta = run.warp(frames(1)[0])
    kw = run._program_kw(meta)
    shape, dtype = (4, 120, 200, 3), torch.uint8
    key = run._graph_key(shape, dtype, kw)
    assert run._graph_key(shape, dtype, run._program_kw(dict(meta))) == key
    if change == "warp_tf":
        tf = np.array(meta["warp_tf"], np.float32)
        tf[0] += 1e-3
        kw = dict(kw, warp_tf=tf)
    elif change == "chunk":
        shape = (1,) + shape[1:]
    elif change == "dtype":
        dtype = torch.float32
    elif change == "out_thresh":
        run.cfg = run.cfg.replace(out_thresh=0.5)
    elif change == "parity_tf":
        kw = dict(kw, parity_tf=np.arange(8, dtype=np.float32))
    else:
        kw = dict(kw, flip_test=True)
    other = run._graph_key(shape, dtype, kw)
    assert other != key
    assert (other[0] == "frame_step") is (change == "chunk")


@pytest.mark.parametrize("chunk,batched,stacked", [(1, False, False),
                                                   (4, True, True),
                                                   (4, False, False)])
def test_graph_lifecycle_matches_eager(det, monkeypatch, chunk, batched,
                                       stacked):
    """Three sequences of 3 dispatches (chunk 4: 12 frames, the last
    sequence 10, a padded chunk): eager, then graphs in a new runner (an
    eager dispatch, a capture, a replay), then after a reset (a capture,
    two replays)."""
    n = 3 * chunk
    eager = make_runner(det, chunk, batched, stacked)
    want = []
    for seq in (frames(n), frames(n), frames(n - 2 if chunk > 1 else n)):
        eager.reset()
        rows = record(eager)
        eager.track_sequence(seq)
        want.append(rows)
        assert eager.spans.counters["eager_programs"] == 3
        assert not set(GRAPH_COUNTERS[1:]) & set(eager.spans.counters)

    monkeypatch.setattr(runner_mod, "_FrameGraph", FakeGraph)
    run = make_runner(det, chunk, batched, stacked)
    run._graphs_on = True
    counts = [(1, 1, 1), (0, 1, 2), (0, 1, 2)]
    for i, seq in enumerate((frames(n), frames(n),
                             frames(n - 2 if chunk > 1 else n))):
        if i:
            run.reset()
            assert run._graphs == {}
        rows = record(run)
        run.track_sequence(seq)
        assert_same_rows(rows, want[i])
        c = run.spans.counters
        assert tuple(c.get(k, 0) for k in GRAPH_COUNTERS) == counts[i]
        t = run.timings()
        assert {f"n.{k}" for k in GRAPH_COUNTERS if c.get(k)} <= set(t)
        assert {"program.capture", "program.replay"} <= set(t)
        assert t["program.capture"] + t["program.replay"] <= t["dispatch"]
        (graph,) = run._graphs.values()
        assert graph.replays == 1 + counts[i][2]
    assert len(run._warm) == 1


def test_graph_holds_the_warp_matrices_it_reads(det, monkeypatch):
    """The model's cache of the device warp's matrices may drop them (at
    its ninth geometry): the captured graph, which reads them, holds them
    until a reset drops it."""
    monkeypatch.setattr(runner_mod, "_FrameGraph", FakeGraph)
    run = make_runner(det, 4)
    run._graphs_on = True
    run.track_sequence(frames(8))
    (graph,) = run._graphs.values()
    hats = [t for pair in det.model._hats.values() for t in pair]
    assert hats
    det.model._hats.clear()
    held = [t for pair in graph.held for t in pair]
    assert all(any(t is h for h in held) for t in hats)
    run.reset()
    assert run._graphs == {}


def test_rebound_method_after_reset_is_in_the_capture(det, monkeypatch):
    """A ring write rebound after the reset, as the benchmark's
    ``stale_ring`` fault does, leaves the ring as it was in the sequence
    that captures it."""
    monkeypatch.setattr(runner_mod, "_FrameGraph", FakeGraph)
    run = make_runner(det, 4)
    run._graphs_on = True
    run.track_sequence(frames(12))
    assert int(run.state["ptr"]) == 12
    run.reset()
    model = run.det.model
    inner = model._sim_and_record

    def stale(emb, n_valid, state, *args, **kw):
        kept = {k: v.clone() for k, v in state.items()}
        out = inner(emb, n_valid, state, *args, **kw)
        for k, v in kept.items():
            state[k].copy_(v)
        return out

    model._sim_and_record = stale
    try:
        run.track_sequence(frames(12))
    finally:
        del model._sim_and_record
    assert run.spans.counters["graph_captures"] == 1
    assert int(run.state["ptr"]) == 0
    assert not run.state["embeds"].any()


def test_launch_counters_take_a_replays_launches():
    before = cuda_dcn.launch_counts()
    assert set(before) == set(cuda_dcn.COUNTERS)
    cuda_dcn.add_launches({"LAUNCHES_ONEHOT": 16, "LAUNCHES": 0})
    after = cuda_dcn.launch_counts()
    assert after["LAUNCHES_ONEHOT"] == before["LAUNCHES_ONEHOT"] + 16
    assert all(after[k] == before[k] for k in after if k != "LAUNCHES_ONEHOT")
    cuda_dcn.add_launches({"LAUNCHES_ONEHOT": -16})
    assert cuda_dcn.launch_counts() == before


# ---- on the card ------------------------------------------------------------

CELL = dict(input_h=544, input_w=960, compute_dtype="bfloat16",
            track_thresh=1e-3, device_warp=True)
SMALL = dict(input_h=256, input_w=448, compute_dtype="bfloat16",
             track_thresh=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def launches_per_chunk(run):
    """Wraps ``_fetch`` too: per dispatch, the launch counters' change
    since the dispatch before."""
    counts = [cuda_dcn.launch_counts()]
    inner = run._fetch          # record()'s, which comes first

    def fetch(sims, packed=None):
        counts.append(cuda_dcn.launch_counts())
        return inner(sims, packed)

    run._fetch = fetch
    return counts


def deltas(counts):
    return [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]


def eager_and_graphs(run, seq):
    """Rows and per-dispatch launches of an eager sequence, a sequence
    with graphs in a runner that has not dispatched the key, and one more
    after a reset; the counters of the last two."""
    out = []
    for graphs in (False, True, True):
        run.reset()
        run._graphs_on = graphs
        rows = record(run)
        counts = launches_per_chunk(run)
        run.track_sequence(seq)
        torch.cuda.synchronize()
        out.append((rows, deltas(counts), dict(run.spans.counters)))
    return out


def check_against_eager(out, n_chunks):
    (want, want_n, _), *graphed = out
    assert len(want) == n_chunks
    # the program found detections and wrote the ring
    assert int(want[-1][2]["counts"].sum()) > 0
    assert all(torch.isfinite(r[2]["embeds"]).all() for r in want)
    for (rows, n, counters), (captures, replays) in zip(
            graphed, [(1, n_chunks - 2), (1, n_chunks - 1)]):
        assert counters.get("graph_captures", 0) == captures
        assert counters.get("graph_replays", 0) == replays
        assert_same_rows(rows, want)
        assert n == want_n


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4, 1])
def test_cell_graphs_match_eager_bit_for_bit(cuda_device, chunk):
    torch.manual_seed(0)
    det = Detector(mot_config(chunk_batched=True, **CELL), device=cuda_device)
    run = PipelinedRunner(det, depth=2, chunk=chunk)
    seq = [make_synthetic_frame(t, 1080, 1920) for t in range(8 * chunk)]
    out = eager_and_graphs(run, seq)
    check_against_eager(out, 8)
    assert any(n["LAUNCHES_ONEHOT"] + n["LAUNCHES"] > 0 for n in out[2][1])

    # a ring write rebound after the reset is in the capture (the
    # benchmark's stale_ring fault)
    run.reset()
    model = det.model
    inner = model._sim_and_record

    def stale(emb, n_valid, state, *args, **kw):
        kept = {k: v.clone() for k, v in state.items()}
        result = inner(emb, n_valid, state, *args, **kw)
        for k, v in kept.items():
            state[k].copy_(v)
        return result

    model._sim_and_record = stale
    try:
        run.track_sequence(seq)
        torch.cuda.synchronize()
        assert run.spans.counters["graph_captures"] == 1
        assert run.spans.counters["graph_replays"] == 7
        assert int(run.state["ptr"]) == 0
        assert not run.state["embeds"].any()
    finally:
        del model._sim_and_record
    run.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flip_test", "yuv", "kitti",
                                     "unbatched"])
def test_program_variants_graph_bit_for_bit(cuda_device, variant):
    torch.manual_seed(0)
    chunk, make = 2, mot_config
    flags = dict(SMALL, device_warp=True, chunk_batched=True)
    if variant == "flip_test":
        flags["flip_test"] = True
    elif variant == "yuv":
        flags.update(device_warp=False, yuv_upload=True)
    elif variant == "kitti":
        make = kitti_config
    else:
        flags["chunk_batched"] = False
    det = Detector(make(**flags), device=cuda_device)
    run = PipelinedRunner(det, depth=2, chunk=chunk)
    if variant == "kitti":
        # seeded heads score every class alike: raise the filtered class's
        # (cars, channel 1) so that the class filter keeps detections
        with torch.no_grad():
            det.model.hm[-1].bias[run.class_filter] += 3.0
    seq = [make_synthetic_frame(t, 300, 500) for t in range(4 * chunk)]
    check_against_eager(eager_and_graphs(run, seq), 4)


@pytest.mark.cuda
def test_graph_reads_its_warp_matrices_after_the_cache_drops_them(
        cuda_device):
    """The model's cache of the device warp's matrices cleared under a
    live graph, and memory of their sizes taken and filled with NaN: the
    replays after it still match eager, bit for bit."""
    torch.manual_seed(0)
    det = Detector(mot_config(**dict(SMALL, device_warp=True,
                                     chunk_batched=True)), device=cuda_device)
    run = PipelinedRunner(det, depth=2, chunk=2)
    seq = [make_synthetic_frame(t, 300, 500) for t in range(12)]
    run._graphs_on = False
    want = record(run)
    run.track_sequence(seq)
    run.reset()
    run._graphs_on = True
    got = record(run)
    inner, junk = run._fetch, []

    def fetch(sims, packed=None):
        if run.spans.counters.get("graph_captures") and not junk:
            sizes = [(t.shape, t.dtype) for pair in det.model._hats.values()
                     for t in pair]
            det.model._hats.clear()
            junk.extend(torch.full(shape, float("nan"), dtype=dtype,
                                   device=cuda_device)
                        for shape, dtype in sizes)
        return inner(sims, packed)

    run._fetch = fetch
    run.track_sequence(seq)
    torch.cuda.synchronize()
    assert junk
    assert run.spans.counters["graph_captures"] == 1
    assert run.spans.counters["graph_replays"] == 4
    assert_same_rows(got, want)
    run.reset()
