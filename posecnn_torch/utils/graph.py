"""CUDA graphs: the port's counterpart of `jax.jit`.

`compile_static(fn)` is `jax.jit` for a fixed-shape device program: one
captured CUDA graph per input signature (each tensor argument's shape,
dtype and device, and the value of every other argument, which plays
JAX's static arguments). The first call of a signature runs `fn` once
eagerly, outside the capture, so that the vote kernels' library loads,
cuDNN picks its algorithms and the caching allocator fills; then it
synchronises and captures one call of `fn` on static copies of the
arguments. Every call copies its arguments into those buffers, replays
the graph and returns the graph's static outputs. All graphs of one
compiled call share one memory pool, so the next call, of any signature,
may overwrite what the last returned. On a CPU device `fn` runs as it is (the caller asked for
the CPU; `jit` computes the same there); on a CUDA device a capture that
fails raises with its cause, and nothing falls back to the eager call.

The benches' loop, `capture_loop`, captures n data-dependent forwards in
one graph, the counterpart of `jax.jit` over a `lax.fori_loop` as
`bench.py:56-69` and `experiments/bench_graph_phases.py:71-82` use them.
Body i reads `data + acc·1e-20`, where acc is body i−1's checksum (0 for
the first), so no body can be hoisted or dropped, and writes its own
checksum into acc: JAX's `sum(rois)·1e-6 + sum(label_2d)·1e-9 +
sum(poses_pred)·1e-6`, a head the model does not build left out. The
perturbation is far below half an ulp of the inputs, so every body
computes the forward of `data` itself.

Both share `_capture`. A replay calls no Python, so the vote kernels'
wrappers never see it: they count the kernels they record into a graph
under capture in `hough_kernels.CAPTURED`, not in `LAUNCHES`, and each
captured program keeps its body's count (`launches`). The launches that
replays make show only on the device, where the kernels count them
(`hough_kernels.device_launches`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from posecnn_torch.ops import hough_kernels


def _capture(warm: Callable, body: Callable, device, pool=None):
    """Run `warm()` eagerly, synchronise, and capture `body()` into one
    CUDA graph (in `pool` when given). Returns (graph, what body returned,
    each vote kernel's launches recorded into the graph)."""
    warm()
    torch.cuda.synchronize(device)
    before = dict(hough_kernels.CAPTURED)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    return graph, out, {k: hough_kernels.CAPTURED[k] - before[k] for k in before}


def signature(args, kwargs):
    """A call's key: each tensor argument's shape, dtype and device, and
    every other argument's value (JAX's static arguments)."""

    def key(a):
        if isinstance(a, torch.Tensor):
            return ("tensor", tuple(a.shape), a.dtype, str(a.device))
        return ("static", a)

    return (tuple(key(a) for a in args),
            tuple((name, key(kwargs[name])) for name in sorted(kwargs)))


class _Program:
    """One signature's graph: static input buffers, outputs, launches."""

    def __init__(self, fn, args, kwargs, device, pool):
        with torch.inference_mode(False), torch.no_grad():
            self.args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            self.kwargs = {k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in kwargs.items()}
        self.graph, self.outputs, self.launches = _capture(
            lambda: fn(*args, **kwargs), lambda: fn(*self.args, **self.kwargs), device, pool)

    def load(self, args, kwargs):
        with torch.inference_mode(False), torch.no_grad():
            for buf, a in zip(self.args, args):
                if isinstance(a, torch.Tensor):
                    buf.copy_(a)
            for k, a in kwargs.items():
                if isinstance(a, torch.Tensor):
                    self.kwargs[k].copy_(a)


class compile_static:  # noqa: N801 — named and used as a function, as `jax.jit`
    """`compile_static(fn)(*args, **kwargs)`: `fn` on those arguments,
    through one CUDA graph per signature (see the module's docstring).

    The outputs are the graph's static tensors: the next call, of any
    signature, may overwrite them, so a caller that keeps an output past
    that call clones it, and callers that share one compiled call from
    several threads hold one lock around each call and the reads of its
    outputs. Every tensor argument lies on one device: a call that mixes
    devices raises ValueError.
    `programs` maps each signature to its program; a program's `launches`
    are the vote kernels' launches in one replay. `fn` is the eager body."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.programs: dict = {}
        self._pool = None

    def __call__(self, *args, **kwargs):
        devices = {a.device for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)}
        if not devices:
            raise ValueError("compile_static: the call has no tensor argument")
        if len(devices) > 1:
            raise ValueError("compile_static: the tensor arguments lie on more than one "
                             f"device: {', '.join(sorted(map(str, devices)))}")
        (device,) = devices
        if device.type != "cuda":
            return self.fn(*args, **kwargs)
        sig = signature(args, kwargs)
        program = self.programs.get(sig)
        if program is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            program = self.programs[sig] = _Program(self.fn, args, kwargs, device, self._pool)
        else:
            program.load(args, kwargs)
        program.graph.replay()
        return program.outputs


def checksum(outputs) -> torch.Tensor:
    """The fp32 scalar a bench body sums from (label_2d, rois,
    poses_pred), in JAX's order; None entries are left out."""
    label_2d, rois, poses_pred = outputs
    total = label_2d.sum() * 1e-9
    if rois is not None:
        total = rois.sum() * 1e-6 + total
    if poses_pred is not None:
        total = total + poses_pred.sum() * 1e-6
    return total.float()


def eager_loop(fn: Callable, args: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """The same n bodies called eagerly, back to back; returns the last
    checksum without waiting for it."""
    data, rest = args[0], tuple(args[1:])
    acc = torch.zeros((), dtype=torch.float32, device=data.device)
    for _ in range(n):
        acc = checksum(fn(data + acc * 1e-20, *rest))
    return acc


def capture_loop(fn: Callable, args: Sequence[torch.Tensor], n: int,
                 reduce: Callable = checksum):
    """Capture n bodies of `fn(data + acc·1e-20, *args[1:])` into one CUDA
    graph; args[0] is data, and every arg must be a CUDA tensor. `reduce`
    turns a body's outputs into its fp32 scalar (the forward's `checksum`
    by default; a bench of one component passes the sum its JAX loop
    body returns).

    Returns (replay, outputs, launches): replay() runs the graph and
    returns acc (no synchronise); outputs are the last body's outputs,
    static tensors that each replay rewrites; launches maps each vote
    kernel to its launches per body."""
    if n < 1:
        raise ValueError(f"capture_loop needs n >= 1, got {n}")
    for a in args:
        if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
            where = a.device if isinstance(a, torch.Tensor) else type(a).__name__
            raise ValueError(f"capture_loop: every argument must be a CUDA tensor, got {where}")
    data, rest = args[0], tuple(args[1:])
    acc = torch.zeros((), dtype=torch.float32, device=data.device)

    def bodies():
        acc.zero_()
        for _ in range(n):
            outputs = fn(data + acc * 1e-20, *rest)
            acc.copy_(reduce(outputs))
        return outputs

    graph, outputs, launches = _capture(lambda: fn(*args), bodies, data.device)

    def replay() -> torch.Tensor:
        graph.replay()
        return acc

    return replay, outputs, {k: v / n for k, v in launches.items()}
