"""Learned LSTM motion model, the counterpart of
``deft_tpu/tracking/motion_lstm.py``.

``DecoderRNN``: an LSTM cell (11-d 2-D features or 18-d nuScenes 3-D
features -> 128 hidden), then Linear(128 -> 64) and Linear(64 -> 4 * future),
predicting per-future-frame box deltas (5 futures for 2-D, 4 for nuScenes).
Parameter names are the reference module's (``lstm.{weight,bias}_{ih,hh}_l0``
of its one-layer ``nn.LSTM``, ``out1.*``, ``out2.*``), so a reference motion
``.pth`` loads strictly.

``LSTMMotion`` holds the module on its device and steps every track the
tracker updated in a frame as one batch (``predict_batch``).  Rows are
independent, so the batch is not padded to a power of two as the JAX package
pads it to bound recompiles.  Plain PyTorch ops: the JAX package has no
Pallas kernel here.

``BATCHES`` and ``ROWS`` count the batched steps and the rows they carried.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from deft_tpu_torch.models.factory import resolve_device

HIDDEN = 128

# batched steps run through ``LSTMMotion.predict_batch`` and their rows
BATCHES = 0
ROWS = 0


def motion_feature_dim(dataset: str) -> int:
    return 18 if dataset == "nuscenes" else 11


def max_future(dataset: str) -> int:
    return 4 if dataset == "nuscenes" else 5


class DecoderRNN(nn.Module):
    def __init__(self, dataset: str = "mot", hidden: int = HIDDEN):
        super().__init__()
        self.future = max_future(dataset)
        # the reference's one-layer nn.LSTM holds the parameters; ``step``
        # runs its single cell update (nn.LSTMCell's arithmetic) on them
        self.lstm = nn.LSTM(motion_feature_dim(dataset), hidden)
        self.out1 = nn.Linear(hidden, 64)
        self.out2 = nn.Linear(64, 4 * self.future)

    def step(self, h: torch.Tensor, c: torch.Tensor, feat: torch.Tensor):
        """One cell update.  h, c: [B, H]; feat: [B, F] ->
        (h', c', deltas [B, future, 4])."""
        lstm = self.lstm
        h2, c2 = torch.lstm_cell(feat, (h, c), lstm.weight_ih_l0,
                                 lstm.weight_hh_l0, lstm.bias_ih_l0,
                                 lstm.bias_hh_l0)
        x = self.out2(self.out1(h2))
        return h2, c2, x.reshape(feat.shape[0], self.future, 4)


class LSTMMotion:
    """The motion model the tracker steps (the reference's KalmanFilterLSTM
    role): seeded weights, or a ``state_dict`` of ``DecoderRNN``."""

    def __init__(self, dataset: str, state_dict=None, seed: int = 0,
                 device="cuda"):
        self.dataset = dataset
        self.max_dis_fut = max_future(dataset)
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = DecoderRNN(dataset)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def _step(self, h, c, feats):
        dev = self.device
        h2, c2, deltas = self.model.step(
            torch.as_tensor(np.asarray(h, np.float32), device=dev),
            torch.as_tensor(np.asarray(c, np.float32), device=dev),
            torch.as_tensor(np.asarray(feats, np.float32), device=dev))
        return h2.cpu().numpy(), c2.cpu().numpy(), deltas.cpu().numpy()

    def predict(self, h, c, new_features
                ) -> Tuple[np.ndarray, np.ndarray, Dict[int, np.ndarray]]:
        """One track: h, c [1, 128], new_features [1, F] ->
        (h', c', {1..max_fut: delta [4]})."""
        h2, c2, deltas = self._step(h, c, new_features)
        preds = {i + 1: deltas[0, i].copy() for i in range(self.max_dis_fut)}
        return h2, c2, preds

    def predict_batch(self, h, c, feats):
        """Batched over tracks: [N, 128], [N, 128], [N, F] float32 ->
        (h', c', deltas [N, future, 4]) as numpy."""
        global BATCHES, ROWS
        BATCHES += 1
        ROWS += int(np.shape(h)[0])
        return self._step(h, c, feats)

    @staticmethod
    def gating_distance(mean, covariance, measurements, only_position=False,
                        metric="gaussian"):
        """LSTM-flavoured gating (kalman_filter_lstm.py:80-102): 'gaussian'
        is an L2 over dims 3:-1 of the prediction vs the measurements."""
        measurements = np.asarray(measurements)
        mean = np.asarray(mean)
        if only_position:
            mean, covariance = mean[:2], covariance[:2, :2]
            measurements = measurements[:, :2]
        if metric == "gaussian":
            d = measurements[:, 3:-1] - mean[3:-1]
            return np.sqrt(np.sum(d * d, axis=1))
        if metric == "maha":
            d = measurements - mean
            l = np.linalg.cholesky(covariance)
            z = np.linalg.solve(l, d.T)
            return np.sum(z * z, axis=0)
        raise ValueError("invalid distance metric")
