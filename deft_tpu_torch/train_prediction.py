"""LSTM motion-model training, the counterpart of the JAX package's root
``train_prediction.py`` (``python -m deft_tpu_torch.train_prediction``):

    python -m deft_tpu_torch.train_prediction tracking,ddd \\
        --exp_id nuScenes_motion_model --dataset nuscenes --lr 2.5e-4

The flags are ``train_prediction.py``'s (``cli.py``), so each
``train_prediction.py`` line of ``experiments/*.sh`` runs as it is.  The
trajectories come from ``data/<dataset>/annotations/...`` under the working
directory (``trajectory_dataset.default_paths``; ``--data_dir`` is not read,
as in the JAX package).  ``--gpus -1`` runs on the CPU; by default the run
is on ``cuda:0``, and it raises where there is no card.  It writes
``<exp_dir>/<task>/<exp_id>/model_last.pth``, which the recipe's test line
loads with ``--load_model_traj``.
"""

from __future__ import annotations

import os
from typing import Optional


def main(argv=None, stats: Optional[dict] = None):
    """Run the ``train_prediction.py`` line ``argv``; returns the trained
    ``DecoderRNN``.  A dict passed as ``stats`` receives what
    ``train_motion_model`` records per step (``step_seconds``, ``lengths``,
    ``losses``), ``checkpoint`` (the last ``model_last.pth``) and
    ``trajectories`` (``len(dataset)``)."""
    from deft_tpu_torch.cli import parse_config
    from deft_tpu_torch.data.datasets import get_dataset
    from deft_tpu_torch.models.factory import resolve_device
    from deft_tpu_torch.train.prediction import train_motion_model
    from deft_tpu_torch.utils.logger import Logger

    cfg, extras = parse_config(argv)
    device = resolve_device(extras["device"])
    logger = Logger(cfg)
    logger.write(f"device: {device}")
    dataset = get_dataset(cfg.dataset, prediction_model=True)(cfg, "train")
    if stats is not None:
        stats["trajectories"] = len(dataset)
    os.makedirs(cfg.save_dir, exist_ok=True)
    model = train_motion_model(cfg, dataset, logger=logger,
                               save_dir=cfg.save_dir, device=device,
                               stats=stats)
    logger.close()
    return model


if __name__ == "__main__":
    main()
