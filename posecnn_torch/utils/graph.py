"""The benches' compiled loop: n data-dependent forwards in one CUDA graph.

Counterpart of `jax.jit` over a `lax.fori_loop` as `bench.py:56-69` and
`experiments/bench_graph_phases.py:71-82` use them. Body i reads
`data + acc·1e-20`, where acc is body i−1's checksum (0 for the first),
so no body can be hoisted or dropped, and writes its own checksum into
acc: JAX's `sum(rois)·1e-6 + sum(label_2d)·1e-9 + sum(poses_pred)·1e-6`,
a head the model does not build left out. The perturbation is far below
half an ulp of the inputs, so every body computes the forward of `data`
itself.

`capture_loop` runs the function once eagerly, which loads the vote
kernels' library, lets cuDNN choose its algorithms and fills the caching
allocator, then captures acc's reset and the n bodies into one
`torch.cuda.CUDAGraph`. Replaying it does the whole loop with no host
work between the launches. The vote kernels' wrappers count their
launches when they are captured (`hough_kernels.LAUNCHES`), not when the
graph replays; `capture_loop` returns those counts per body. There is no
fallback: a CPU tensor raises, and so does whatever fails in the capture.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from posecnn_torch.ops import hough_kernels


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


def capture_loop(fn: Callable, args: Sequence[torch.Tensor], n: int):
    """Capture n bodies of `fn(data + acc·1e-20, *args[1:])` into one CUDA
    graph; args[0] is data, and every arg must be a CUDA tensor.

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
    fn(*args)  # warm-up, outside the capture
    torch.cuda.synchronize(data.device)
    acc = torch.zeros((), dtype=torch.float32, device=data.device)
    before = dict(hough_kernels.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc.zero_()
        for _ in range(n):
            outputs = fn(data + acc * 1e-20, *rest)
            acc.copy_(checksum(outputs))
    launches = {k: (hough_kernels.LAUNCHES[k] - before[k]) / n for k in before}

    def replay() -> torch.Tensor:
        graph.replay()
        return acc

    return replay, outputs, launches
