"""Profiling and numeric-debug utilities (counterpart of
`posecnn_tpu/utils/debug.py`).

  profile_trace — a `torch.profiler` trace of the enclosed region (host
                  and, on the card, CUDA activity) written as a Chrome
                  trace (`chrome://tracing`, Perfetto), where the JAX one
                  writes a `jax.profiler` trace; `train_net --profile DIR`
                  wraps a whole run in it.
  finite_check  — instruments a train step so that it raises at the first
                  non-finite loss or gradient, where the JAX one wraps a
                  jitted function in `checkify`'s float checks.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "output/torch-trace"):
    """Profile the enclosed region; on exit the trace is written to
    `<log_dir>/trace.json`, whose path the context yields:

        with profile_trace("output/trace") as path:
            step(state, batch)
    """
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def require_finite(values: dict) -> None:
    """Raise FloatingPointError naming the first entry of `values` (tensors
    or numbers) that holds a NaN or an infinity."""
    for name, v in values.items():
        finite = bool(torch.isfinite(v).all()) if torch.is_tensor(v) else math.isfinite(v)
        if not finite:
            raise FloatingPointError(f"non-finite {name}")


def _gradients(*modules) -> dict:
    return {f"gradient of {name}": p.grad for m in modules if m is not None
            for name, p in m.named_parameters() if p.grad is not None}


def finite_check(step):
    """Instrument a `engine/train` step in place and return it: its
    forward raises on a non-finite loss or metric, its backward on a
    non-finite gradient, before the update; a GAN step's discriminator
    update raises on a non-finite loss or gradient of its own."""
    forward, backward = step.forward, step.backward

    def checked_forward(state, batch):
        total, metrics, *aux = forward(state, batch)  # the GAN's also its vertex map
        require_finite({"loss": total, **metrics})
        return total, metrics, *aux

    def checked_backward(total):
        backward(total)
        require_finite(_gradients(step.model))

    step.forward, step.backward = checked_forward, checked_backward
    if hasattr(step, "discriminator"):
        discriminator = step.discriminator

        def checked_discriminator(state, batch, fake):
            d_loss = discriminator(state, batch, fake)
            require_finite({"discriminator loss": d_loss, **_gradients(step.disc)})
            return d_loss

        step.discriminator = checked_discriminator
    return step
