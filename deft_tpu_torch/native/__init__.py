"""ctypes bindings for the C++ host runtime (``deft_native.cpp``), the
counterpart of ``deft_tpu/native/__init__.py``: ``lapjv``, ``iou_matrix``
and ``warp_affine``, each one call into C++ that runs without the
interpreter lock (ctypes releases it), so the cascade worker's assignment
does not hold up the main thread's launches.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use, into ``build/native/libdeft_native.so`` under the repository root
(not beside the source), and rebuilt when it is older than the source
(``csrc/build.py::is_stale``).  Nothing is built until a function here is
called.  A failed build or load raises with the compiler's output: a caller
that asked for the native route (``DEFT_USE_NATIVE=1``) gets it or an
error, never a quiet fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from deft_tpu_torch.csrc.build import is_stale

SOURCE = Path(__file__).resolve().parent / "deft_native.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
LIBRARY = BUILD_DIR / "libdeft_native.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()
LAPJV_CALLS = 0     # lapjv calls that reached the library (the bench reads)


def build() -> Path:
    """Compile the library unless it is newer than the source; return its
    path.  Raises with g++'s output if the compile fails."""
    if not is_stale(LIBRARY, [SOURCE]):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:           # no g++ on the PATH
        raise RuntimeError(
            f"native build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)   # atomic: a reader never sees a partial file
    return LIBRARY


def library():
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(lib):
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.lapjv_limit.restype = ctypes.c_int
    lib.lapjv_limit.argtypes = [ctypes.c_int, ctypes.c_int, f64,
                                ctypes.c_double, i32, i32]
    lib.iou_matrix.restype = None
    lib.iou_matrix.argtypes = [f64, ctypes.c_int, f64, ctypes.c_int, f64]
    lib.warp_affine_u8.restype = None
    lib.warp_affine_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, f64, u8, ctypes.c_int,
                                   ctypes.c_int]
    return lib


def lapjv(cost: np.ndarray, thresh: float):
    """``lap.lapjv(cost, extend_cost=True, cost_limit=thresh)`` semantics
    (``deft_tpu/native/__init__.py:70-89``): NaN and +inf cost 1e9.
    Returns (matches [K, 2], unmatched_rows, unmatched_cols)."""
    global LAPJV_CALLS
    cost = np.ascontiguousarray(
        np.nan_to_num(cost, nan=1e9, posinf=1e9), dtype=np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.empty((0, 2), int), np.arange(n), np.arange(m)
    r2c = np.empty(n, np.int32)
    c2r = np.empty(m, np.int32)
    library().lapjv_limit(n, m, cost, float(thresh), r2c, c2r)
    LAPJV_CALLS += 1
    rows = np.where(r2c >= 0)[0]
    matches = (np.stack([rows, r2c[rows]], axis=1) if len(rows)
               else np.empty((0, 2), int))
    return matches, np.where(r2c < 0)[0], np.where(c2r < 0)[0]


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of tlbr boxes with the +1-pixel areas of
    ``ops/iou.py::pairwise_iou``: [N, 4], [M, 4] -> [N, M] float64."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    out = np.empty((len(a), len(b)), np.float64)
    if out.size:
        library().iou_matrix(a, len(a), b, len(b), out)
    return out


def warp_affine(src: np.ndarray, M: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR)`` on uint8 with
    a zero border; ``dsize`` is (width, height)."""
    dw, dh = dsize
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim == 2:
        src = src[:, :, None]
    dst = np.empty((dh, dw, src.shape[2]), np.uint8)
    library().warp_affine_u8(src, src.shape[0], src.shape[1], src.shape[2],
                             np.ascontiguousarray(M, np.float64), dst, dh, dw)
    return dst[..., 0] if dst.shape[2] == 1 else dst
