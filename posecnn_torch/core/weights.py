"""Weight bridge: JAX `.npz` checkpoints → the port's `state_dict`.

Counterpart of `posecnn_tpu/core/checkpoint.py:25-62`. `save_params`
there writes one flat `.npz` whose parameter keys are
`params/<module>/<name>` (flax layout), plus `__step__` and
`__meta_<flag>__` entries. This module reads that file with numpy
alone and maps each parameter onto the port's module names:

  params/VGG16Trunk_0/convS_I/{kernel,bias}  → trunk.convS_I.{weight,bias}
  params/seg_head/score_conv{4,5,out}/…      → seg_head.score_conv{4,5,out}.…
  params/vertex_head/vertex_conv{4,5,out}/…  → vertex_head.vertex_conv{4,5,out}.…
  params/pose_head/fc{6,7,8}/…               → pose_head.fc{6,7,8}.…

Conv kernels go from flax's HWIO to torch's OIHW; Dense kernels from
(in, out) to Linear's (out, in). fc6's rows need no permutation: the
port flattens the pooled (R, p, p, C) features in the same NHWC order
as the JAX pose head (`posecnn_tpu/models/posecnn.py:134`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

_MODULE_NAMES = {"VGG16Trunk_0": "trunk", "seg_head": "seg_head",
                 "vertex_head": "vertex_head", "pose_head": "pose_head"}
_KEY = re.compile(r"params/([^/]+)/([^/]+)/(kernel|bias)")


def load_npz(path: str) -> dict[str, np.ndarray]:
    """All parameter arrays of a `save_params` checkpoint, by flat key
    (the `__step__` / `__meta_*__` bookkeeping entries are left out)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {k: data[k] for k in data.files if not k.startswith("__")}


def read_ckpt_meta(path: str) -> dict:
    """Forward-pass flags recorded by `save_params(meta=...)`; empty for
    checkpoints that predate them (`core/checkpoint.py:52-62`)."""
    out = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            m = re.fullmatch(r"__meta_(.+)__", key)
            if m:
                v = data[key]
                out[m.group(1)] = v.item() if v.ndim == 0 else v
    return out


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map flat `params/<module>/<name>/<kernel|bias>` arrays to the port's
    PoseCNN `state_dict` keys. Raises on a key it cannot map; the
    caller's `load_state_dict(strict=True)` raises on one missing."""
    state = {}
    for key, value in flat.items():
        m = _KEY.fullmatch(key)
        if m is None or m.group(1) not in _MODULE_NAMES:
            raise KeyError(f"unmapped checkpoint key {key!r}")
        module, layer, kind = m.groups()
        arr = np.asarray(value, np.float32)
        if kind == "kernel":
            if arr.ndim == 4:  # conv HWIO → OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense (in, out) → (out, in)
                arr = arr.T
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        name = f"{_MODULE_NAMES[module]}.{layer}.{'weight' if kind == 'kernel' else 'bias'}"
        state[name] = torch.tensor(arr)  # a contiguous copy
    return state


def load_jax_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a JAX `.npz` checkpoint into `model` in place. Every
    parameter of the model must be in the file and every parameter of
    the file must land in the model, with equal shapes."""
    model.load_state_dict(params_from_jax(load_npz(path)), strict=True)
