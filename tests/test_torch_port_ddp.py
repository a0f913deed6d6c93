"""Data-parallel training of the port on the CPU: two gloo ranks through
``train_rank`` against the one-process step on the same global batch
(``tests/torch_port_ddp_setup.py`` says what the data, the runs and the
criteria are).

* the loader: every rank draws the same order and keeps rows ``rank::2``
  of each global batch, so the ranks' batches together are the
  one-process batches; a global batch that the world does not divide is
  refused, as the JAX mesh's ``shard_batch`` refuses it;
* the step: the loss statistics of rank 0 and of rank 1 (global values,
  the sums of the ranks' parts) within 1e-4 relative of the one-process
  step's; both ranks end with the same weights, bit for bit (the summed
  gradients and the Adam update are the same on each); those weights
  against the one-process step's by ``check_adam_step``; the BatchNorm
  running statistics within 1e-5 x max(1, max|value|): the ranks take
  E[x] and E[x^2] as two partial sums added, the one process as one sum,
  and E[x^2] - E[x]^2 loses digits where the mean is large against the
  spread (flax's variance, ``layers.train_batch_norm``);
* only rank 0 writes: one ``model_last.pth`` (rank 1's save returns
  None), and ``log.txt`` holds one run's lines.
"""

import numpy as np
import pytest
import torch

from torch_port_ddp_setup import (WORLD, check_adam_step,  # noqa: F401
                                  check_losses, data, few_threads, gloo_run,
                                  loader, one_process, seeded_batches)


def test_ranks_together_are_the_global_batches(data):
    want = seeded_batches(data, n=2)
    parts = [seeded_batches(data, rank=r, world=WORLD, n=2)
             for r in range(WORLD)]
    for step, batch in enumerate(want):
        for key, value in batch.items():
            got = np.empty_like(value)
            for r in range(WORLD):
                got[r::WORLD] = parts[r][step][key]
                assert len(parts[r][step][key]) == len(value) // WORLD
            np.testing.assert_array_equal(got, value, err_msg=key)


def test_indivisible_global_batch_is_refused(data):
    with pytest.raises(ValueError, match="does not split"):
        loader(data, rank=0, world=WORLD, batch_size=3)


def test_gloo_step_matches_one_process(gloo_run, one_process):
    ranks, _ = gloo_run
    stats, _, grads, trainer = one_process
    for r in range(WORLD):
        check_losses(ranks[r]["stats"]["first"], stats)
    for key, value in ranks[0]["state_dict"].items():
        assert torch.equal(value, ranks[1]["state_dict"][key]), key
    assert ranks[0]["s_det"] == ranks[1]["s_det"]
    params = dict(trainer.model.named_parameters())
    flips, total = check_adam_step(
        ranks[0]["state_dict"], trainer.model.state_dict(), grads, params,
        trainer.cfg.lr, 1e-5)
    assert abs(ranks[0]["s_det"] - float(trainer.s_det.detach())) <= 1e-7
    assert abs(ranks[0]["s_id"] - float(trainer.s_id.detach())) <= 1e-7


def test_only_rank_0_writes(gloo_run):
    ranks, save_dir = gloo_run
    assert ranks[0]["stats"]["checkpoint"].endswith("model_last.pth")
    assert ranks[1]["stats"]["checkpoint"] is None
    blob = torch.load(save_dir / "model_last.pth", weights_only=True)
    for key, value in ranks[0]["state_dict"].items():
        assert torch.equal(blob["state_dict"][key], value), key
    log = (save_dir / "log.txt").read_text()
    assert log.count("training done") == 1
    assert log.count("epoch 1 ") == 1 and "rank 0 of 2" in log
