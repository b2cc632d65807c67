"""Entry points of the flagship forward: seeded inputs, the model at the
repository's published configuration, and the multi-card dry run.

Counterpart of `__graft_entry__.py`:

  make_inputs       `_make_inputs` (`:10-39`): the same numpy arrays
                    (RandomState(0), a 500 px focal length at the image
                    centre, K⁻¹ in meta[:, 9:18], optional GT rows), as
                    tensors on a device
  entry             `entry()` (`:42-67`): (fn, example_args), fn the eval
                    forward at 22 classes, 480×640, num_units 64, 128 Hough
                    samples, 8 objects an image, cell stride 4, returning
                    (label_2d, rois, poses_pred)
  dryrun_multichip  `dryrun_multichip` (`:70-190`), from `parallel/dryrun.py`

`flagship_model` builds the model both `entry()` and `bench.py` time
(`bench.py:46-53`: the same at cell stride 1), in bf16, JAX's default
`compute_dtype` (`posecnn_tpu/models/posecnn.py:60`); `forward_fn` is
the function over it that `utils/graph.capture_loop` captures. The device
defaults to `cuda`: without a card `entry` raises, it does not fall back
to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from posecnn_torch.cli.common import setup_device
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.parallel.dryrun import dryrun_multichip

__all__ = ["NUM_CLASSES", "HEIGHT", "WIDTH", "FLAGSHIP", "make_inputs", "flagship_model",
           "forward_fn", "entry", "dryrun_multichip"]

# YCB-Video: 21 objects + background, at its frame size (`__graft_entry__.py:47-48`)
NUM_CLASSES, HEIGHT, WIDTH = 22, 480, 640
# the PoseCNN of `entry()` and `bench.py` but for the cell stride
FLAGSHIP = dict(num_units=64, hough_num_samples=128, max_objects=8, vote_threshold=-1.0)


def make_inputs(batch: int, height: int, width: int, num_classes: int, with_gt: bool = False,
                max_gt: int = 8, device="cuda") -> dict:
    """The seeded flagship inputs (`__graft_entry__._make_inputs`): data
    (B, H, W, 3), extents (C, 3), meta (B, 48), and with `with_gt`
    gt_poses (max_gt, 13) and gt_valid (max_gt,), one object an image."""
    rng = np.random.RandomState(0)
    data = rng.randn(batch, height, width, 3).astype(np.float32) * 30.0
    extents = np.abs(rng.randn(num_classes, 3)).astype(np.float32) * 0.1 + 0.05
    extents[0] = 0
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    meta = np.zeros((batch, 48), np.float32)
    meta[:, :9] = k.flatten()
    meta[:, 9:18] = np.linalg.inv(k).flatten()
    out = {"data": data, "extents": extents, "meta": meta}
    if with_gt:
        gt = np.zeros((max_gt, 13), np.float32)
        gt_valid = np.zeros((max_gt,), bool)
        for i in range(batch):
            gt[i, 0] = i
            gt[i, 1] = 1 + (i % (num_classes - 1))
            gt[i, 6] = 1.0
            gt[i, 10:13] = [0.0, 0.0, 1.0]
            gt_valid[i] = True
        out["gt_poses"] = gt
        out["gt_valid"] = gt_valid
    return {key: torch.from_numpy(v).to(device) for key, v in out.items()}


def flagship_model(cell_stride: int, *, device="cuda", params: Optional[dict] = None,
                   compute_dtype: torch.dtype = torch.bfloat16, **switches) -> PoseCNN:
    """The flagship PoseCNN at `cell_stride`, on `device`, in eval mode.
    Its weights are `init_weights(model, 0)`, or JAX's flat parameters
    (`params/<module>/…` arrays, a checkpoint's layout) through
    `params_from_jax`. `switches` are the head switches (`vertex_reg`,
    `pose_reg`) that `bench.py phases` turns off."""
    model = PoseCNN(NUM_CLASSES, hough_cell_stride=cell_stride, compute_dtype=compute_dtype,
                    **FLAGSHIP, **switches)
    if params is None:
        init_weights(model, 0)
    else:
        model.load_state_dict(params_from_jax(params), strict=True)
    return model.to(device).eval()


def forward_fn(model: PoseCNN):
    """The eval forward as JAX's `entry()` returns it: fn(data, extents,
    meta) → (label_2d, rois, poses_pred); a head the model does not build
    gives None in its place."""

    def fn(data, extents, meta):
        out = model(data, extents, meta)
        rois = out.hough.rois if out.hough is not None else None
        return out.label_2d, rois, out.poses_pred

    return fn


def entry(device=None):
    """(fn, example_args): the flagship eval forward at `entry()`'s
    configuration (cell stride 4, bf16, seeded weights) and its seeded
    inputs (data, extents, meta) at batch 1. `device` defaults to `cuda`
    and raises without a card."""
    dev = setup_device(device or "cuda")
    model = flagship_model(4, device=dev)
    inp = make_inputs(1, HEIGHT, WIDTH, NUM_CLASSES, device=dev)
    return forward_fn(model), (inp["data"], inp["extents"], inp["meta"])
