"""DEFT on PyTorch and CUDA: the port of ``deft_tpu`` to an NVIDIA H100.

``deft_tpu`` (JAX) stays the reference; this package reimplements its main
path -- MOT17 tracking with the model's own detections through
``inference.detector.Detector.run`` -- as ``torch.nn.Module``s, plain tensor
functions and hand-written CUDA kernels (``csrc/``).  It imports neither JAX
nor anything under ``deft_tpu``.

Numerics policy (the counterpart of ``deft_tpu/__init__.py``, which forces
true-float32 matmuls): float32 matrix products and cuDNN convolutions run in
full float32, never TF32.  TF32 keeps about three decimal digits, which moves
the trunk by ~1e-3 and is enough to reorder close detections against the
reference.  Products of bfloat16 operands (``compute_dtype="bfloat16"``)
accumulate in float32 to the end, as XLA's do: cuBLAS may not reduce split
sums in bfloat16.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
