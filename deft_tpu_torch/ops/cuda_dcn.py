"""DCNv2 sampling: the hand-written CUDA kernel, its wrapper and its plain
version.  The counterpart of ``deft_tpu/ops/pallas_dcn.py``.

``deform_sample(x, offsets, mask, radius)`` is deformable im2col: for every
output pixel and tap of the 3x3 kernel, a bilinear sample of ``x`` at the
tap's position plus its offset (clamped to +-radius; a negative radius means
no clamp), with zeros outside the image, times the tap's mask.  It returns
tap-major patches ``[H*W, 9*C]`` that ``deform_conv`` multiplies with the
``[9C, Cout]`` weight in one library GEMM, as the JAX package multiplies its
Pallas kernel's patches outside the kernel.

On a CUDA tensor the wrapper launches ``csrc/dcn_sample.cu`` (built on first
use, see ``csrc/build.py``) or raises; on a CPU tensor it computes
``deform_sample_reference``, the plain PyTorch version of the same function.
Nothing falls back from the card to the plain version.

Layouts follow the JAX functions: x ``[H, W, C]``, offsets
``[H, W, 9, 2]`` (dy, dx), mask ``[H, W, 9]``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

KK = 9                     # taps of the 3x3 kernel

# Number of kernel launches made through ``deform_sample``.  Callers reset it
# to 0 before a run and read it after to prove the run went through the kernel.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()


def _load_library():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from deft_tpu_torch.csrc.build import build

            lib = ctypes.CDLL(str(build("dcn_sample")))
            fn = lib.dcn_sample
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_inputs(x, offsets, mask):
    if x.dim() != 3:
        raise ValueError(f"x must be [H, W, C], got {tuple(x.shape)}")
    h, w, _ = x.shape
    if tuple(offsets.shape) != (h, w, KK, 2):
        raise ValueError(f"offsets must be [{h}, {w}, {KK}, 2], got "
                         f"{tuple(offsets.shape)}")
    if tuple(mask.shape) != (h, w, KK):
        raise ValueError(f"mask must be [{h}, {w}, {KK}], got "
                         f"{tuple(mask.shape)}")
    if offsets.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("offsets and mask must be float32")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == offsets.device == mask.device):
        raise ValueError("x, offsets and mask must be on one device")


def deform_sample_reference(x: torch.Tensor, offsets: torch.Tensor,
                            mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch deformable im2col: the 4-corner gather of
    ``deft_tpu/models/dcn.py::deform_sample`` plus the +-radius clamp of
    ``deform_conv_onehot`` (``deft_tpu/ops/pallas_dcn.py:167-221``).
    Float32 arithmetic; returns ``[H*W, 9*C]`` in x's dtype."""
    _check_inputs(x, offsets, mask)
    h, w, c = x.shape
    dev = x.device
    xf = x.float()
    if radius >= 0:
        offsets = offsets.clamp(-radius, radius)
    kidx = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
    ky, kx = torch.meshgrid(kidx, kidx, indexing="ij")
    base_y = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
              + ky.reshape(-1)[None, :])                      # [H, KK]
    base_x = (torch.arange(w, dtype=torch.float32, device=dev)[:, None]
              + kx.reshape(-1)[None, :])                      # [W, KK]
    yy = base_y[:, None, :] + offsets[..., 0]                 # [H, W, KK]
    xx = base_x[None, :, :] + offsets[..., 1]

    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    wx1 = xx - x0
    wy1 = yy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = xf.reshape(h * w, c)

    def tap(xi, yi, wgt):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        vals = flat[(yc * w + xc).reshape(-1)].reshape(h, w, KK, c)
        return vals * (wgt * inb.float())[..., None]

    out = (tap(x0, y0, wx0 * wy0)
           + tap(x0 + 1, y0, wx1 * wy0)
           + tap(x0, y0 + 1, wx0 * wy1)
           + tap(x0 + 1, y0 + 1, wx1 * wy1))
    out = out * mask[..., None]
    return out.reshape(h * w, KK * c).to(x.dtype)


def deform_sample(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Deformable im2col ``[H*W, 9*C]``: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor, an error for anything else."""
    global LAUNCHES
    _check_inputs(x, offsets, mask)
    if x.device.type == "cpu":
        return deform_sample_reference(x, offsets, mask, radius)
    if x.device.type != "cuda":
        raise ValueError(f"deform_sample runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("offsets", offsets), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    h, w, c = x.shape
    if h * w * KK * c >= 2 ** 31:
        raise ValueError("patch tensor too large for the kernel's indexing")
    lib = _load_library()
    out = torch.empty((h * w, KK * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcn_sample(x.data_ptr(), offsets.data_ptr(),
                             mask.data_ptr(), out.data_ptr(), h, w, c,
                             int(radius), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dcn_sample kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Modulated deformable 3x3 conv with the JAX functions' contract
    (``deform_conv_onehot``): x ``[H, W, C]``, weight ``[9*C, Cout]`` tap-major,
    bias ``[Cout]`` -> ``[H, W, Cout]``."""
    h, w, _ = x.shape
    patches = deform_sample(x, offsets, mask, radius)
    out = torch.addmm(bias.to(patches.dtype), patches,
                      weight.to(patches.dtype))
    return out.reshape(h, w, -1)
