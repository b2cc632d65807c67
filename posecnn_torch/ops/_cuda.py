"""Build and load the port's CUDA kernels (`posecnn_torch/csrc/*.cu`).

The sources have a plain C interface. At first use they are compiled
with `nvcc` for sm_90a into `posecnn_torch/_build/` (gitignored) and
loaded with ctypes; the library name carries a hash of the source, so
an edited kernel is rebuilt. `ptxas -v` reports each kernel's registers,
shared memory and spills; the report is kept beside the library and
`build_report()` returns it. Nothing here runs at import time, and
there is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hough_vote.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhough_vote_{digest}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            run = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{run.stdout}{run.stderr}")
            so.with_suffix(".ptxas.txt").write_text(run.stdout + run.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hough_tile_votes.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.hough_tile_votes.restype = i
        lib.hough_flat_votes.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        lib.hough_flat_votes.restype = i
        lib.hough_window_votes.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p]
        lib.hough_window_votes.restype = i
        _lib = lib
        return lib


def build_report() -> str:
    """What `nvcc -Xptxas -v` printed when the loaded library was built."""
    library()
    return _library_path().with_suffix(".ptxas.txt").read_text()


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
