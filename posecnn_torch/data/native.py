"""The C++ data-path loops (`posecnn_torch/csrc/blobops.cpp`) through ctypes.

Counterpart of `posecnn_tpu/data/native.py`, over the port's carried copy
of `native/blobops.cpp`: the z-buffered point splat of the synthetic
render (`splat_points`, and the textured two-pass `splat_points_rgb`) and
the per-pixel vertex-target writer (`vertex_targets`). A ctypes call
releases the interpreter lock, so the feed's render threads run these
loops side by side with the training step.

At first use the source is compiled with `g++ -O3 -march=native -shared
-fPIC` into `posecnn_torch/_build/` (gitignored), never beside the JAX
package's copy. The library's name carries a hash of the source, the
flags and the host CPU, so an edited source or another machine gets its
own build. The compiler writes a temporary file that `os.replace` puts in
place, under an exclusive `flock` on a lock file beside it: test workers
and feed threads that start together build once and never load a file
half written. Nothing is built at import.

There is no fallback: a build that fails raises with the compiler's
output. The numpy loops the JAX package falls back to stay in
`data/synthetic.py` and `data/minibatch.py` as the plain version, reached
only when a caller asks for it (`native=False`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "blobops.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _host_cpu() -> bytes:
    """The first CPU's model and feature flags: what `-march=native` reads."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().split(b"\n\n")[0].splitlines()
                     if ln.startswith((b"model name", b"flags", b"Features"))]
        return b"\n".join(lines)
    except OSError:
        return os.uname().machine.encode()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 compiler: str = "g++") -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join([compiler, *CXX_FLAGS]).encode()
                            + _host_cpu()).hexdigest()[:16]
    return build_dir / f"lib{source.stem}_{digest}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR, compiler: str = "g++") -> Path:
    """The shared library of `source`, compiled first if it is not there.
    Atomic across processes; raises when the compiler is missing or fails."""
    so = library_path(source, build_dir, compiler)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            run = subprocess.run([compiler, *CXX_FLAGS, str(source), "-o", str(tmp)],
                                 capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"{compiler} not found; {source.name} cannot be built") from e
        if run.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed on {source.name} (exit {run.returncode}):\n"
                               f"{run.stdout}{run.stderr}")
        os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded data-path library, built first if needed; the same three
    functions and signatures as the JAX package's `get_lib`."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        lib.splat_points.argtypes = [i32p, i32p, f32p, i64, i32, i32, f32p, f32, i32, i32,
                                     f32p, i32p, f32p]
        lib.splat_points.restype = None
        lib.splat_points_rgb.argtypes = [i32p, i32p, f32p, f32p, i64, i32, i32, f32, i32, i32,
                                         f32p, i32p, f32p]
        lib.splat_points_rgb.restype = None
        lib.vertex_targets.argtypes = [i32p, f32p, f32p, f32, i32, i32, i32, f32p, f32p]
        lib.vertex_targets.restype = None
        _lib = lib
        return lib


def _check_buffers(n: int, arrays, depth_buf, label_buf, image_buf) -> None:
    """The sizes the C loops index by, checked before any pointer is passed."""
    if any(len(a) != n for a in arrays):
        raise ValueError(f"point arrays of unequal lengths {[len(a) for a in arrays]}")
    h, w = depth_buf.shape
    if label_buf.shape != (h, w) or image_buf.shape != (h, w, 3):
        raise ValueError(f"buffers {depth_buf.shape}, {label_buf.shape}, {image_buf.shape} do "
                         "not form one (H, W) frame")


def splat_points_native(u, v, z, cls: int, radius: int, color, t_far: float,
                        depth_buf: np.ndarray, label_buf: np.ndarray,
                        image_buf: np.ndarray) -> None:
    """In-place z-buffered splat of one object's projected points in the
    class colour × a depth shade (`blobops.cpp` `splat_points`)."""
    _check_buffers(len(u), (v, z), depth_buf, label_buf, image_buf)
    library().splat_points(
        np.ascontiguousarray(u, np.int32), np.ascontiguousarray(v, np.int32),
        np.ascontiguousarray(z, np.float32), len(u), cls, radius,
        np.ascontiguousarray(color, np.float32), t_far,
        depth_buf.shape[0], depth_buf.shape[1], depth_buf, label_buf, image_buf,
    )


def splat_points_rgb_native(u, v, z, rgb, cls: int, radius: int,
                            depth_buf: np.ndarray, label_buf: np.ndarray, image_buf: np.ndarray,
                            eps: float = 0.01) -> None:
    """In-place two-pass visibility splat with per-point colours
    (`blobops.cpp` `splat_points_rgb`)."""
    _check_buffers(len(u), (v, z, rgb), depth_buf, label_buf, image_buf)
    library().splat_points_rgb(
        np.ascontiguousarray(u, np.int32), np.ascontiguousarray(v, np.int32),
        np.ascontiguousarray(z, np.float32), np.ascontiguousarray(rgb, np.float32),
        len(u), cls, radius, eps,
        depth_buf.shape[0], depth_buf.shape[1], depth_buf, label_buf, image_buf,
    )


def vertex_targets_native(label, centers, log_z, weight_inside: float, num_classes: int,
                          targets: np.ndarray, weights: np.ndarray) -> None:
    """Write one image's vertex targets and weights in place
    (`blobops.cpp` `vertex_targets`): centers (C, 2), NaN where a class is
    absent; log_z (C,); targets and weights (H, W, 3C), zeroed by the caller."""
    h, w = label.shape
    if np.shape(centers) != (num_classes, 2) or np.shape(log_z) != (num_classes,):
        raise ValueError(f"centers {np.shape(centers)} and log_z {np.shape(log_z)} do not "
                         f"match {num_classes} classes")
    if targets.shape != (h, w, 3 * num_classes) or weights.shape != targets.shape:
        raise ValueError(f"targets {targets.shape} / weights {weights.shape} are not "
                         f"({h}, {w}, {3 * num_classes})")
    library().vertex_targets(
        np.ascontiguousarray(label, np.int32), np.ascontiguousarray(centers, np.float32),
        np.ascontiguousarray(log_z, np.float32), weight_inside, h, w, num_classes,
        targets, weights,
    )
