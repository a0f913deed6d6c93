"""Data-parallel training over ranks, the counterpart of
``deft_tpu/parallel/mesh.py``.

The JAX trainer shards every batch over a ``data`` mesh axis and jits one
program (root ``train.py:82, :116``; ``deft_tpu/train/trainer.py:144-155``),
so its loss normalizers and flax's BatchNorm moments are taken over the
*global* batch and each gradient is that of the global loss.  The port runs
one process per card instead (``torch.distributed``: NCCL on the card, gloo
on the CPU), each with its rows of the global batch, and keeps those
semantics by reducing where the JAX program reduces over the batch:

* ``global_sum``: a sum over the batch that divides a loss or picks a
  branch (a count of targets or masks), summed over the ranks before use;
  no gradient flows through it;
* ``layers.train_batch_norm`` takes its moments E[x] and E[x^2] with
  ``global_sum``, and its backward sums dy and dy * x_hat the same way;
* ``sum_gradients``: each parameter's gradient summed over the ranks, once
  per step.  Each rank's loss is its part of the global loss (its rows'
  sums over the global normalizers), so the sum is the global loss's
  gradient; nothing divides by the world size.

With no process group initialized every helper is the one-process
identity, so the one-process path runs the same code.  Nothing here falls
back: a backend that fails to start raises.
"""

from __future__ import annotations

import socket
from typing import Iterable

import torch
import torch.distributed as dist


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def backend():
    """The process group's backend, None without one."""
    return dist.get_backend() if active() else None


def free_address() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a port free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def init(rank_: int, world: int, backend: str, init_method: str,
         device: torch.device):
    """Join the process group of ``world`` ranks as ``rank_`` on
    ``device`` (``backend`` is ``"nccl"`` for a card, ``"gloo"`` for the
    CPU; a mismatch raises)."""
    if (backend == "nccl") != (device.type == "cuda"):
        raise ValueError(f"backend {backend!r} does not drive {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_)


def close():
    if active():
        dist.destroy_process_group()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, without gradient (module docstring)."""
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def sum_gradients(params: Iterable[torch.nn.Parameter]):
    """Each gradient summed over the ranks, in one flat buffer."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
