"""CUDA graphs: the port's counterpart of `jax.jit`.

`compile_static(fn)` is `jax.jit` for a fixed-shape device program: one
captured CUDA graph per input signature (each tensor argument's shape,
dtype and device, and the value of every other argument, which plays
JAX's static arguments). The first call of a signature runs `fn` once
eagerly, outside the capture, so that the kernels' libraries load,
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

Both share `_capture`. A replay calls no Python, so the CUDA kernels'
wrappers (the vote kernels, the NMS scan) never see it: they count the
kernels they record into a graph under capture in `_cuda.CAPTURED`, not
in `_cuda.LAUNCHES`, and each captured program keeps its body's count
(`launches`). The launches that replays make show only on the device,
where the kernels count them (`_cuda.device_launches`).

`compile_step(fn)` is `jax.jit(step_fn, donate_argnums=(0,))` for a
program that moves state in place: the training step, whose parameters
and optimizer state live outside it at fixed addresses and whose metrics
are its outputs (see its docstring). `device_constant` keeps a host
constant on the device once, so that no program copies it from the host
on every call: a capture refuses a pageable host-to-device copy.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from posecnn_torch.ops import _cuda


def _capture(warm: Callable, body: Callable, device, pool=None):
    """Run `warm()` eagerly, synchronise, and capture `body()` into one
    CUDA graph (in `pool` when given). Returns (graph, what body returned,
    each CUDA kernel's launches recorded into the graph)."""
    warm()
    torch.cuda.synchronize(device)
    before = dict(_cuda.CAPTURED)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    return graph, out, {k: _cuda.CAPTURED[k] - before[k] for k in before}


def _key(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype, str(a.device))
    return ("static", a)


def signature(args, kwargs):
    """A call's key: each tensor argument's shape, dtype and device, and
    every other argument's value (JAX's static arguments)."""
    return (tuple(_key(a) for a in args),
            tuple((name, _key(kwargs[name])) for name in sorted(kwargs)))


def _one_device(tensors, what: str) -> torch.device:
    """The one device of `tensors`; raises ValueError on none or several."""
    devices = {a.device for a in tensors}
    if not devices:
        raise ValueError(f"{what}: the call has no tensor argument")
    if len(devices) > 1:
        raise ValueError(f"{what}: the tensor arguments lie on more than one "
                         f"device: {', '.join(sorted(map(str, devices)))}")
    return devices.pop()


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
    are the CUDA kernels' launches in one replay. `fn` is the eager body."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.programs: dict = {}
        self._pool = None

    def __call__(self, *args, **kwargs):
        device = _one_device([a for a in (*args, *kwargs.values())
                              if isinstance(a, torch.Tensor)], "compile_static")
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


class _StepProgram:
    """One batch signature's graph: the static batch it reads, the metric
    names and the stacked metrics it writes, its CUDA kernels' launches."""

    def __init__(self, graph, batch, keys, stacked, launches):
        self.graph, self.batch, self.keys = graph, batch, keys
        self.stacked, self.launches = stacked, launches

    def replay(self, batch: dict) -> dict:
        with torch.no_grad():
            for k, buf in self.batch.items():
                if isinstance(buf, torch.Tensor):
                    buf.copy_(batch[k])
        self.graph.replay()
        return dict(zip(self.keys, self.stacked.clone().unbind()))


class compile_step:  # noqa: N801 — named and used as a function, as `jax.jit`
    """`jax.jit(step_fn, donate_argnums=(0,))` for a step that moves its
    state in place: `compile_step(fn, ...)(batch, *static)` is
    `fn(batch, *static)`, one CUDA graph per signature.

    `fn` takes a dict of tensors (the batch) and `static` (hashable
    values: JAX's static arguments) and returns a dict of fp32 scalar
    tensors (the metrics); everything else it does is in place on tensors
    that outlive it (parameters, gradients, optimizer state). Whatever it
    reads from the host (a learning rate, the dropout seeds) the caller
    writes into device tensors or `generators` before each call.

    The signature is the batch's keys with each value's shape, dtype and
    device (any other value by itself), and `static`. The first call of a
    signature is the real step of its batch, as JAX's first `jit` call is:
    `fn` runs eagerly on a side stream (the warm-up of the PyTorch
    documentation's whole-network capture), then `before_capture()` runs
    (the training step drops its gradients there, so that the graph's
    backward allocates its own), then one call of `fn` on static copies of
    the batch is captured into a graph in this compiled step's private
    pool, with each of `generators` registered. The capture runs nothing,
    so the state moves once. A later call copies the batch into those
    copies and replays: each generator draws from the state it has when
    the replay starts (the caller seeds it), as the eager call would.

    Returns the eager call's metrics, or the replay's as fresh tensors
    (one clone of the stacked metrics, unbound), which a later call does
    not overwrite. On a CPU device `fn` runs as it is (the caller asked
    for the CPU). A capture that fails raises with its cause; nothing falls
    back to the eager call. The batch's tensors lie on one device.
    `programs` maps each signature to its program (`launches`: the CUDA
    kernels' launches in one replay); `last` is the program of the last
    call on a card (the one it captured or replayed)."""

    def __init__(self, fn: Callable[..., dict], *, before_capture: Callable[[], None] = lambda: None,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.before_capture = before_capture
        self.generators = list(generators)
        self.programs: dict = {}
        self.last = None
        self._pool = None

    def __call__(self, batch: dict, *static) -> dict:
        device = _one_device([v for v in batch.values() if isinstance(v, torch.Tensor)],
                             "compile_step")
        if device.type != "cuda":
            return self.fn(batch, *static)
        sig = (tuple((k, _key(batch[k])) for k in sorted(batch)), static)
        program = self.programs.get(sig)
        if program is not None:
            self.last = program
            return program.replay(batch)
        # the real step of this batch, on a side stream
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self.fn(batch, *static)
        current.wait_stream(side)
        self.programs[sig] = self.last = self._capture(batch, static, device)
        return metrics

    def _capture(self, batch: dict, static: tuple, device) -> _StepProgram:
        self.before_capture()
        with torch.no_grad():
            copies = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        torch.cuda.synchronize(device)
        before = dict(_cuda.CAPTURED)
        # thread-local: a feed's threads may run beside the capture
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            metrics = self.fn(copies, *static)
            bad = {k: (v.dtype, tuple(v.shape)) for k, v in metrics.items()
                   if v.dtype != torch.float32 or v.ndim != 0}
            if bad:
                raise ValueError(f"compile_step: the metrics must be fp32 scalars: {bad}")
            stacked = torch.stack(list(metrics.values()))
        launches = {k: _cuda.CAPTURED[k] - before[k] for k in before}
        return _StepProgram(graph, copies, list(metrics), stacked, launches)


_CONSTANTS: dict = {}


def _frozen(values):
    return tuple(map(_frozen, values)) if isinstance(values, (list, tuple)) else values


def device_constant(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype)` on `device`, made once per
    (values, dtype, device) and kept for every later call: built per call
    it is a pageable host-to-device copy, which a CUDA graph capture
    refuses. Its first use on a card must come outside a capture (it
    copies then). It is a normal tensor (not an inference tensor), shared
    by every caller, who must not write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (_frozen(values), dtype, device)
    constant = _CONSTANTS.get(key)
    if constant is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device_constant: first use on {device} under graph capture; "
                               "make it eagerly first")
        with torch.inference_mode(False):
            constant = _CONSTANTS[key] = torch.tensor(values, dtype=dtype).to(device)
    return constant


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
    static tensors that each replay rewrites; launches maps each CUDA
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
