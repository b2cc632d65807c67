"""Build and load the port's CUDA kernels (`posecnn_torch/csrc/*.cu`), and
count their launches.

Each source has a plain C interface. At first use it is compiled with
`nvcc` for sm_90a into its own library under `posecnn_torch/_build/`
(gitignored) and loaded with ctypes; the library's name carries a hash of
its source and the flags, so an edited kernel rebuilds its own library
and no other. `build_all` starts one `nvcc` a source, all together.
`ptxas -v` reports each kernel's registers, shared memory and spills; the
report is kept beside the library and `build_report(name)` returns it.
Nothing here runs at import time, and there is no fallback: a failed
build raises.

The launch counts: each wrapper adds one to `LAUNCHES[kernel]` where it
launches its kernel, or to `CAPTURED[kernel]` when its stream is being
captured into a CUDA graph (the capture launches nothing; `utils/graph`
reads what a captured body recorded). A graph's replays call no wrapper,
so every kernel also counts its own launches on the device, one atomic
add a launch into a counter the wrapper passes (`device_counter`);
`device_launches` reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each library (csrc/<name>.cu): its entry points' ctypes argument types;
# every entry point returns a cudaError_t as int
LIBRARIES = {
    "hough_vote": {
        "hough_tile_votes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
        "hough_flat_votes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
        "hough_window_votes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "nms_scan": {"nms_scan": [_P, _P, _P, _P, _I, _I, _P, _P]},
    "kabsch": {
        "kabsch_rotations": [_P, _P, _P, _I, _P, _P],
        "pose_hypotheses": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P],
        "pose_refine": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P],
    },
}

_locks = {name: threading.Lock() for name in LIBRARIES}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = _library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            run = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{run.stdout}{run.stderr}")
            so.with_suffix(".ptxas.txt").write_text(run.stdout + run.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in LIBRARIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _libs[name] = lib
        return lib


def build_all() -> None:
    """Build and load every library, one `nvcc` a source, started together."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for future in [pool.submit(library, name) for name in LIBRARIES]:
            future.result()  # raises what the build raised


def build_report(name: str) -> str:
    """What `nvcc -Xptxas -v` printed when library `name` was built."""
    library(name)
    return _library_path(name).with_suffix(".ptxas.txt").read_text()


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")


# the kernels by the names the counts use, each with its slot in a
# device's counters: the three vote kernels (ops/hough_kernels.py), the
# NMS scan (ops/nms.py), the Kabsch rotation and RANSAC's two pose kernels
# (refine/ransac.py)
KERNELS = ("tile", "flat", "window", "scan", "kabsch", "pose_hyp", "pose_refine")
# launches since the last reset, by kernel; chip_smoke.py reads them to
# show that each path went through its kernels
LAUNCHES = dict.fromkeys(KERNELS, 0)
CAPTURED = dict.fromkeys(KERNELS, 0)
# each device's int32 launch counters, one per kernel, made outside any capture
_DEVICE_COUNTS: dict[int, torch.Tensor] = {}


def count(kernel: str) -> None:
    """One launch of `kernel`, or one kernel recorded into a graph when
    the current stream is capturing."""
    (CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES)[kernel] += 1


def device_counter(device: torch.device, kernel: str) -> int:
    """The address of `kernel`'s launch counter on `device`."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    counts = _DEVICE_COUNTS.get(index)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            # zeros made under capture would be zeroed again by every replay
            raise RuntimeError(f"the {kernel} kernel: its first call on cuda:{index} is under "
                               "graph capture; call it eagerly first")
        with torch.inference_mode(False):  # a normal tensor: resettable outside inference
            counts = _DEVICE_COUNTS[index] = torch.zeros(len(KERNELS), dtype=torch.int32,
                                                         device=f"cuda:{index}")
    return counts.data_ptr() + counts.element_size() * KERNELS.index(kernel)


def reset_device_launches() -> None:
    """Set every device's launch counters to 0 and wait for it."""
    for index, counts in _DEVICE_COUNTS.items():
        counts.zero_()
        torch.cuda.synchronize(index)


def device_launches() -> dict:
    """Each kernel's launches since the last `reset_device_launches`, as
    the kernels counted them on the device, summed over devices: the
    wrappers' eager launches and every graph replay's. Synchronises."""
    total = dict.fromkeys(KERNELS, 0)
    for counts in _DEVICE_COUNTS.values():
        for kernel, n in zip(KERNELS, counts.tolist()):
            total[kernel] += n
    return total
