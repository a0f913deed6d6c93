"""Build the port's CUDA kernels from the sources in this directory.

Each ``<name>.cu`` here is compiled by ``nvcc`` into its own shared library
with a plain C interface, ``build/kernels/lib<name>.so`` under the repository
root, and loaded with ``ctypes`` (no PyTorch headers: seconds per build
instead of minutes).  The sources include the shared headers here
(``*.cuh``, found through ``-I`` this directory).  A library is rebuilt when
it is missing or older than its source or any header, so the first call on
a fresh checkout builds everything and a header edit rebuilds every kernel.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC)]


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are built on the machine with the card")
    return str(path)


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def is_stale(lib: Path, sources: Iterable[Path]) -> bool:
    """True if ``lib`` is missing or older than any of ``sources``."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources)


def build(name: str) -> Path:
    """Compile ``<name>.cu`` unless its library is newer than the source and
    every shared header; return the library's path.  Raises with nvcc's
    output if the compile fails."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if not is_stale(lib, [src, *CSRC.glob("*.cuh")]):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)       # atomic: a reader never sees a partial file
    return lib


def build_all() -> Dict[str, float]:
    """Build every kernel, one nvcc per source, all started together.
    Returns the seconds each build took."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    names = kernel_names()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(pool.map(timed, names))

