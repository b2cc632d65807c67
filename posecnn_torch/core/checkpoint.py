"""Training snapshots in the JAX package's `.npz` layout.

Counterpart of `posecnn_tpu/core/checkpoint.py:25-117`. `save_params`
writes what that module's `save_params` writes: one flat `.npz` of
`params/<module>[/<name>]/<kernel|bias>` arrays in flax layout (conv HWIO,
dense (in, out)), `__step__`, and `__meta_<flag>__` for the forward-pass
flags that do not change parameter shapes. So a port snapshot restores in
the JAX package (`posecnn_tpu.core.checkpoint.restore_params`) and a JAX
one here, both ways.

`restore_params` is strict where the JAX one keeps its template for a
missing or reshaped entry: every parameter must be in the file with its
shape (`core/weights.load_jax_checkpoint`). Training's `--ckpt` and
`--resume` use it.

`restore_for_eval` is what `test_net`, `serve` and `demo` use: they build
every head, as the JAX CLIs do, and a checkpoint of a switched model (seg
only, seg + vertex) lacks whole head groups. Where the file lacks every
parameter of one of `HEAD_GROUPS`, that group keeps the model's seeded
initial values, as the JAX restore keeps its template, and a line names
the groups kept. Any other missing key, an extra key or a reshaped one
raises.

`import_vgg16_npy` loads a Caffe-exported ImageNet `vgg16.npy` (the
reference's `Network.load` layout) into a model, as `train_net
--pretrained` does (`posecnn_tpu/core/checkpoint.py:120-160`).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from posecnn_torch.core.weights import (
    FLAGSHIP_TRUNK,
    load_jax_checkpoint,
    load_npz,
    params_from_jax,
    params_to_jax,
)

# the head groups a switched PoseCNN does not build (models/posecnn.py)
HEAD_GROUPS = ("vertex_head", "pose_head", "domain_head")


def save_params(path: str, model: torch.nn.Module, step: int = 0,
                meta: Optional[dict] = None) -> None:
    flat = params_to_jax(model.state_dict(), getattr(model, "JAX_TRUNK", FLAGSHIP_TRUNK))
    flat["__step__"] = np.asarray(step)
    for k, v in (meta or {}).items():
        flat[f"__meta_{k}__"] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def restore_params(path: str, model: torch.nn.Module) -> int:
    """Load a snapshot into `model` in place; returns its step."""
    load_jax_checkpoint(model, path)
    return _step(path)


def _step(path: str) -> int:
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return int(data["__step__"]) if "__step__" in data.files else 0


def restore_for_eval(path: str, model: torch.nn.Module) -> int:
    """Load a snapshot into an evaluation model in place, keeping the
    model's values for each head group the file lacks whole; returns the
    snapshot's step. Raises on any other missing key, on an extra one and
    on a shape that differs."""
    state = params_from_jax(load_npz(path))
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    in_file = {k.split(".")[0] for k in state}
    missing = sorted(set(own) - set(state))
    kept = sorted({k.split(".")[0] for k in missing
                   if k.split(".")[0] in HEAD_GROUPS and k.split(".")[0] not in in_file})
    rest = [k for k in missing if k.split(".")[0] not in kept]
    if extra or rest:
        raise KeyError(f"{path} does not fit the model: missing {rest[:8]}, "
                       f"unexpected {extra[:8]}")
    model.load_state_dict(state, strict=False)  # raises on a shape that differs
    if kept:
        print(f"restore: {path} has no {', '.join(kept)}; kept the model's initial values")
    return _step(path)


def import_vgg16_npy(npy_path: str, model: torch.nn.Module) -> int:
    """Load `vgg16.npy` weights into `model` in place; returns the number
    of kernels loaded.

    The file is a pickled dict {layer: {'weights': array, 'biases': (O,)}}
    with conv kernels in HWIO and fc kernels as (in, out): the flax
    layout. So the match runs as the JAX package's does, on the model's
    flat flax-layout dict (`params_to_jax`): every entry whose key ends in
    `<layer>/kernel` (or `/bias`) with the file's shape takes its values,
    and the dict maps back through `params_from_jax` (HWIO → OIHW,
    (in, out) → (out, in)). The 13 convs load into the trunk, fc6
    (25088 × 4096: the 7 × 7 × 512 pool, flattened in the same order) and
    fc7 into the pose head; fc8, ImageNet's 1000-way classifier, fails
    the shape check and is skipped. Prints the JAX line "loaded N kernels
    (names)"."""
    data = np.load(npy_path, allow_pickle=True, encoding="latin1").item()
    flat = params_to_jax(model.state_dict(), getattr(model, "JAX_TRUNK", FLAGSHIP_TRUNK))
    updated = dict(flat)
    n_kernels, loaded = 0, []
    for name, entry in data.items():
        if "weights" not in entry:
            continue
        w = np.asarray(entry["weights"], np.float32)
        b = np.asarray(entry.get("biases", np.zeros(0)), np.float32).reshape(-1)
        hit = False
        for key in flat:
            if key.endswith(f"{name}/kernel") and flat[key].shape == w.shape:
                updated[key] = w
                n_kernels += 1
                hit = True
            if key.endswith(f"{name}/bias") and flat[key].shape == b.shape:
                updated[key] = b
        if hit:
            loaded.append(name)
    print(f"import_vgg16_npy: loaded {n_kernels} kernels ({', '.join(sorted(loaded))})")
    model.load_state_dict(params_from_jax(updated), strict=True)
    return n_kernels


def snapshot_path(output_dir: str, prefix: str, infix: str, iteration: int) -> str:
    """<prefix>[_<infix>]_iter_N.npz, the reference's naming."""
    name = prefix + (f"_{infix}" if infix else "") + f"_iter_{iteration}.npz"
    return os.path.join(output_dir, name)


def prune_snapshots(output_dir: str, prefix: str, keep: int = 12) -> None:
    """Keep the newest `keep` snapshots of `prefix` in `output_dir`."""
    pat = re.compile(re.escape(prefix) + r".*_iter_(\d+)\.npz$")
    found = []
    for f in os.listdir(output_dir):
        m = pat.match(f)
        if m:
            found.append((int(m.group(1)), f))
    for _, f in sorted(found)[:-keep]:
        os.remove(os.path.join(output_dir, f))
