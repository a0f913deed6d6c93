"""Training: losses, the trainer, checkpoints and the entry point
(``python -m deft_tpu_torch.train``, whose ``main`` is ``train/run.py``),
the counterpart of ``deft_tpu/train/`` and the JAX package's ``train.py``."""
