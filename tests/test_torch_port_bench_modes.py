"""The runner's delta uploads, staging modes, ``cap`` and ``lookahead``
(``tests/torch_port_bench_setup.py`` says what the scene, the weights and
the checks are):

* ``delta_upload`` at chunk 4, with and without ``chunk_batched``, bit for
  bit against the port's host-warp run without it (the same programs on the
  same warped frames: any difference is a fault of the rebuild), and at
  chunk 1 against the JAX runner;
* each of ``auto_tune``'s four staging modes gives the tracks of
  ``stacked+lazy`` bit for bit (the ids as they first appear: a reset
  tracker takes the next ids), and ``auto_tune`` keeps one of them;
* ``cap`` against the JAX runner under the same cap;
* ``track_sequence(lookahead=2)`` against the JAX runner's at chunk 1, and
  against the port's own run without lookahead at chunk 4 (the JAX runner
  appends each chunk's list of frames as one frame there, runner.py:811);
* the mode checks' ``ValueError``s (runner.py:143-153).
"""

import numpy as np
import pytest
import torch

import torch_port_bench_setup as B
from torch_port_bench_setup import few_threads  # noqa: F401

from deft_tpu_torch.config import mot_config
from deft_tpu_torch.inference.detector import Detector
from deft_tpu_torch.inference.runner import STAGING_MODES, PipelinedRunner


@pytest.fixture(scope="module")
def weights():
    return B.build_weights(B.frames()[0])


@pytest.fixture(scope="module")
def plain(weights):
    """The port's chunk-4 run on host-warped frames, and the chunk-1 JAX
    run."""
    seq = B.frames()
    run = B.port_runner(weights, 4)
    run.host_warp = True
    return run.track_sequence(seq), B.jax_runner(weights, 1).track_sequence(
        seq)


@pytest.mark.parametrize("batched", [False, True])
def test_delta_bit_exact(weights, plain, batched):
    seq = B.frames()
    run = B.port_runner(weights, 4, delta_upload=True, chunk_batched=batched)
    assert run._delta_mode and run.host_warp
    got = run.track_sequence(seq)
    B.check_tracks(got, plain[0], f"delta batched={batched}", exact=True)
    # a reset zeroes the ring's previous frame; after a whole chunk it
    # holds that chunk's last frame, rebuilt
    run.reset()
    assert int(run.state["prev_frame"].sum()) == 0
    run.track_sequence(seq[:4])
    np.testing.assert_array_equal(run.state["prev_frame"][0].numpy(),
                                  run.warp(seq[3])[0])
    assert B.n_tracks(got) >= 2 * len(seq)


def test_delta_matches_jax(weights, plain):
    seq = B.frames()
    jrun = B.jax_runner(weights, 1, delta_upload=True)
    got = B.port_runner(weights, 1, delta_upload=True).track_sequence(seq)
    B.check_tracks(got, jrun.track_sequence(seq), "delta chunk 1")
    B.check_tracks(got, plain[1], "delta chunk 1 against plain")


def test_delta_rebuild_cumsum_is_frame_by_frame():
    """The batched rebuild (one int32 cumulative sum) equals frame-by-frame
    uint8 adds, on deltas that wrap many times."""
    from deft_tpu_torch.models.deft import DEFTNet

    rng = np.random.RandomState(3)
    prev = torch.from_numpy(rng.randint(0, 256, (1, 5, 7, 3)).astype(np.uint8))
    deltas = torch.from_numpy(rng.randint(0, 256, (6, 5, 7, 3)
                                          ).astype(np.uint8))
    state = {"prev_frame": prev.clone()}
    got = DEFTNet._rebuild_delta(deltas, state)
    want, cur = [], prev[0]
    for d in deltas:
        cur = cur + d                       # uint8 wraps mod 256
        want.append(cur)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), torch.stack(want).numpy())
    np.testing.assert_array_equal(state["prev_frame"][0].numpy(),
                                  want[-1].numpy())


def test_staging_modes_agree(weights):
    seq = B.frames()
    run = B.port_runner(weights, 4)
    assert run.stacked and not run.force_resident and not run.upload_parallel
    want = None
    for name, stacked, forced, parallel in STAGING_MODES:
        run.reset()
        run.stacked, run.force_resident = stacked, forced
        run.upload_parallel = parallel
        got = run.track_sequence(seq)
        if want is None:
            want = got
        B.check_tracks(got, want, name, exact=True, relabel=True)
        assert run.timings()["upload"] > 0
    scores = run.auto_tune(seq)
    assert list(scores) == [m[0] for m in STAGING_MODES]
    assert all(v > 0 for v in scores.values())
    best = max(scores, key=scores.get)
    assert next(m[1:] for m in STAGING_MODES if m[0] == best) == (
        run.stacked, run.force_resident, run.upload_parallel)
    assert int(run.state["ptr"]) == 0           # reset after the sweep
    B.check_tracks(run.track_sequence(seq), want, "after auto_tune",
                   exact=True, relabel=True)
    assert B.port_runner(weights, 1).auto_tune(seq) == {}
    assert B.port_runner(weights, 4, public_det=True).auto_tune(seq) == {}


@pytest.mark.parametrize("chunk", [1, 4])
def test_cap_matches_jax(weights, chunk):
    seq = B.frames()
    jrun, prun = B.jax_runner(weights, chunk), B.port_runner(weights, chunk)
    jrun.cap = prun.cap = 2
    want, got = jrun.track_sequence(seq), prun.track_sequence(seq)
    B.check_tracks(got, want, f"cap chunk {chunk}")
    assert 0 < max(len(fr) for fr in got) <= 2
    uncapped = B.port_runner(weights, chunk).track_sequence(seq)
    assert max(len(fr) for fr in uncapped) > 2


def test_lookahead(weights, plain):
    seq = B.frames()
    jrun = B.jax_runner(weights, 1)
    got = B.port_runner(weights, 1).track_sequence(seq, lookahead=2)
    B.check_tracks(got, jrun.track_sequence(seq, lookahead=2), "lookahead 1")
    B.check_tracks(got, plain[1], "lookahead 1 against plain")
    want = B.port_runner(weights, 4).track_sequence(seq)
    got = B.port_runner(weights, 4).track_sequence(seq, lookahead=3)
    B.check_tracks(got, want, "lookahead chunk 4", exact=True)


@pytest.mark.parametrize("flags", [
    dict(yuv_upload=True, delta_upload=True),
    dict(device_warp=True, yuv_upload=True),
    dict(device_warp=True, delta_upload=True),
])
def test_mode_checks_raise(flags):
    cfg = mot_config(**B.SIZE, **flags)
    with pytest.raises(ValueError):
        PipelinedRunner(Detector(cfg, device="cpu"))


def test_device_warp_refuses_wire_encodings_in_the_programs(weights):
    """The frame programs refuse a device warp of packed or delta frames
    (deft.py:437-439)."""
    model = B.port_runner(weights, 1).det.model
    run = B.port_runner(weights, 1)
    frame, meta = run.warp(B.frames()[0])
    image = torch.from_numpy(np.array(frame))[None]
    with pytest.raises(ValueError):
        model.frame_step(image, run.state, 0.4, warp_tf=meta["warp_tf"],
                         warp_out=(96, 160), yuv_in=True)
