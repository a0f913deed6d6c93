"""Training checkpoints, the counterpart of ``deft_tpu/train/checkpoint.py``.

The port saves what the reference DEFT trainer saves (its ``model.py``
``save_model``): a ``.pth`` file of ``{"epoch", "state_dict", "optimizer"}``
with the reference's key names, plus ``s_det``, ``s_id`` and ``step`` (the
updates made, which place the learning-rate schedule).  The file is one that
``deft_tpu_torch.test`` loads (``cfg.load_model``), and that the reference's
own loader reads.

``load_train_state`` resumes a ``Trainer`` from such a file (every rank of
a process group reads the same file, so all start from one state): the model's
tensors tolerantly (``checkpoint.load_tolerant``: a mis-shaped or missing
key keeps its value, an unexpected key is dropped), the optimizer's state
where its parameter groups match (else fresh moments, with a message), the
uncertainty weights and the step (where the file has none, ``epoch *
steps_per_epoch``, as the JAX package derives it).  Orbax checkpoints of the
JAX package stay refused (``checkpoint.resolve_pth``).

``save_motion_checkpoint`` writes the LSTM motion model as the reference's
own motion trainer does: ``{"epoch", "state_dict"}`` under its keys
(``lstm.{weight,bias}_{ih,hh}_l0``, ``out1.*``, ``out2.*``), the file that
``cfg.load_model_traj`` loads strictly.  The JAX package writes orbax there.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from deft_tpu_torch.checkpoint import (is_imagenet_backbone_sd,
                                       load_checkpoint_blob, load_tolerant,
                                       trunk_state_dict)
from deft_tpu_torch.distributed import rank


def save_checkpoint(path: str, trainer, epoch: int) -> Optional[str]:
    """Write ``trainer``'s model, optimizer, uncertainty weights and step
    at ``epoch`` to ``path`` (``.pth`` appended if missing); returns the
    path.  Under a process group rank 0 alone writes (every rank holds the
    same state); the others return None."""
    if rank() != 0:
        return None
    return _write({
        "epoch": int(epoch),
        "state_dict": {k: v.detach().cpu()
                       for k, v in trainer.model.state_dict().items()},
        "optimizer": trainer.optimizer.state_dict(),
        "s_det": float(trainer.s_det.detach()),
        "s_id": float(trainer.s_id.detach()),
        "step": int(trainer.step),
    }, path)


def _write(blob: dict, path: str) -> str:
    path = str(path)
    if not path.endswith(".pth"):
        path += ".pth"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_motion_checkpoint(path: str, model, epoch: int) -> str:
    """Write the ``DecoderRNN`` ``model`` at ``epoch`` to ``path`` (``.pth``
    appended if missing); returns the path."""
    return _write({"epoch": int(epoch),
                   "state_dict": {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()}},
                  path)


def load_train_state(path: str, trainer) -> int:
    """Restore ``trainer`` from the checkpoint at ``path`` (module
    docstring); returns the checkpoint's epoch."""
    blob = load_checkpoint_blob(path)
    sd = blob.get("state_dict", blob)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    if is_imagenet_backbone_sd(sd):
        sd = trunk_state_dict(sd, trainer.model)
    load_tolerant(trainer.model, sd)
    epoch = int(blob.get("epoch", 0))
    with torch.no_grad():
        for name in ("s_det", "s_id"):
            if name in blob:
                getattr(trainer, name).fill_(float(blob[name]))
    step = blob.get("step")
    if step is None:
        step = epoch * trainer.steps_per_epoch
        if "optimizer" in blob:
            print("checkpoint: no step recorded; deriving LR-schedule step "
                  f"from epoch ({epoch} * {trainer.steps_per_epoch})")
    trainer.step = int(step)
    if "optimizer" in blob:
        try:
            trainer.optimizer.load_state_dict(blob["optimizer"])
        except (KeyError, ValueError, TypeError) as e:
            print(f"checkpoint: optimizer state incompatible ({e}); "
                  "keeping fresh optimizer moments")
    else:
        print("checkpoint: no optimizer state saved; fresh moments")
    return epoch
