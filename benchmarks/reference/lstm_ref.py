"""Plain reference of DEFT's LSTM motion model (``DecoderRNN`` of
``train_prediction.py``): one LSTM cell of hidden size 128 on the track's
motion feature, then ``Linear(128 -> 64)`` and ``Linear(64 -> 4 * future)``,
the deltas of the next ``future`` frames.

``step(sd, h, c, x)``: a ``state_dict`` in the reference module's key names
(``lstm.{weight,bias}_{ih,hh}_l0``, ``out1.*``, ``out2.*``), h and c
[N, 128], x [N, F] -> (h', c', deltas [N, future, 4]), float32 torch with
TF32 off.  The gates are explicit products, in PyTorch's LSTM order (input,
forget, cell, output): ``c' = s(f) c + s(i) tanh(g)``, ``h' = s(o)
tanh(c')``.  ``quant`` rounds the operands and the result of every product
(the control's lower precision, ``precision.py``).

``make_state_dict(seed, feature_dim, future, device)`` draws a seeded one:
every weight and bias uniform in +-1/sqrt(fan in), as PyTorch initializes
``nn.LSTM`` and ``nn.Linear`` (the recipe loads a trained file instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HIDDEN = 128
MID = 64


def make_state_dict(seed: int, feature_dim: int, future: int,
                    device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    shapes = {"lstm.weight_ih_l0": ((4 * HIDDEN, feature_dim), HIDDEN),
              "lstm.weight_hh_l0": ((4 * HIDDEN, HIDDEN), HIDDEN),
              "lstm.bias_ih_l0": ((4 * HIDDEN,), HIDDEN),
              "lstm.bias_hh_l0": ((4 * HIDDEN,), HIDDEN),
              "out1.weight": ((MID, HIDDEN), HIDDEN),
              "out1.bias": ((MID,), HIDDEN),
              "out2.weight": ((4 * future, MID), MID),
              "out2.bias": ((4 * future,), MID)}
    sd = {}
    for key, (shape, fan_in) in shapes.items():
        bound = fan_in ** -0.5
        sd[key] = ((torch.rand(shape, generator=gen) * 2.0 - 1.0)
                   * bound).to(device)
    return sd


def step(sd: Dict[str, torch.Tensor], h: torch.Tensor, c: torch.Tensor,
         x: torch.Tensor, quant: Optional[Callable] = None):
    q = quant if quant is not None else (lambda t: t)

    def linear(v, key):
        return q(q(v) @ q(sd[key + ".weight"]).t()) + sd[key + ".bias"]

    gates = (q(q(x) @ q(sd["lstm.weight_ih_l0"]).t()) + sd["lstm.bias_ih_l0"]
             + q(q(h) @ q(sd["lstm.weight_hh_l0"]).t())
             + sd["lstm.bias_hh_l0"])
    i, f, g, o = gates.chunk(4, dim=1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    out = linear(linear(h2, "out1"), "out2")
    return h2, c2, out.reshape(x.shape[0], -1, 4)
