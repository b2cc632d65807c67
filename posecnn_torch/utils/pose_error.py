"""Pose error metrics (counterpart of `posecnn_tpu/utils/pose_error.py:23-79`).

  add    mean ‖(R x + t) − (R̂ x + t̂)‖ over the model points
  adi    ADD-S: for each GT-posed point, the distance to the nearest
         estimate-posed point (symmetric objects)
  reproj mean 2D reprojection error
  re, te geodesic rotation error in degrees, translation error in metres

All take leading batch axes. `adi_error` keeps the JAX package's
nearest-neighbour formula, a Gram matrix ‖a‖² − 2a·b + ‖b‖² in fp32: its
cancellation is part of the number (about 5e-4 m at zero error). Run it
with TF32 off (`cli/common.setup_device`), or the card's product drops
to a 10-bit mantissa.
"""

from __future__ import annotations

import torch

from posecnn_torch.utils.quaternion import rotation_geodesic_deg
from posecnn_torch.utils.se3 import transform_points


def _posed(r_est, t_est, r_gt, t_gt, pts):
    rt_est = torch.cat([r_est, t_est[..., None]], -1)
    rt_gt = torch.cat([r_gt, t_gt[..., None]], -1)
    return transform_points(rt_est, pts), transform_points(rt_gt, pts)


def add_error(r_est, t_est, r_gt, t_gt, pts):
    """ADD. pts: (…, P, 3)."""
    pe, pg = _posed(r_est, t_est, r_gt, t_gt, pts)
    return torch.linalg.vector_norm(pe - pg, dim=-1).mean(-1)


def adi_error(r_est, t_est, r_gt, t_gt, pts):
    """ADD-S through a (…, P, P) Gram matrix."""
    pe, pg = _posed(r_est, t_est, r_gt, t_gt, pts)
    gram = pg @ pe.transpose(-1, -2)
    sq = (pg * pg).sum(-1, keepdim=True) - 2.0 * gram + (pe * pe).sum(-1)[..., None, :]
    return torch.sqrt(torch.clamp(sq.amin(-1), min=0.0)).mean(-1)


def reproj_error(k, r_est, t_est, r_gt, t_gt, pts):
    """Mean 2D reprojection error in pixels under intrinsics k (…, 3, 3)."""
    pe, pg = _posed(r_est, t_est, r_gt, t_gt, pts)
    pe = pe @ k.transpose(-1, -2)
    pg = pg @ k.transpose(-1, -2)
    uv_e = pe[..., :2] / torch.clamp(pe[..., 2:3], min=1e-10)
    uv_g = pg[..., :2] / torch.clamp(pg[..., 2:3], min=1e-10)
    return torch.linalg.vector_norm(uv_e - uv_g, dim=-1).mean(-1)


def re(r_est, r_gt):
    """Rotation error in degrees."""
    return rotation_geodesic_deg(r_est, r_gt)


def te(t_est, t_gt):
    """Translation error in metres."""
    return torch.linalg.vector_norm(t_gt - t_est, dim=-1)


def auc_thresholds(max_threshold: float, num_steps: int) -> torch.Tensor:
    """`jnp.linspace(0, max_threshold, num_steps)` as XLA:CPU computes it,
    bit for bit in fp32: i · (max_threshold / (num_steps − 1)), then the
    end point (XLA rewrites the stop·(i / div) of the formula so).
    `torch.linspace` rounds differently: at (0, 0.1, 1000) it differs in
    the last ulp of 125 values, and an error that sits on a threshold
    would count on the other side."""
    stop = torch.tensor(max_threshold, dtype=torch.float32)
    step = stop / torch.tensor(num_steps - 1, dtype=torch.float32)
    return torch.cat([torch.arange(num_steps - 1, dtype=torch.float32) * step, stop[None]])


def auc_of_errors(errors: torch.Tensor, max_threshold: float = 0.1,
                  num_steps: int = 1000) -> torch.Tensor:
    """Area under the accuracy-vs-threshold curve on [0, max_threshold],
    normalised to [0, 1]. errors: 1-D fp32, inf for a missed detection."""
    thresholds = auc_thresholds(max_threshold, num_steps).to(errors.device)
    acc = (errors.float()[None, :] < thresholds[:, None]).float().mean(-1)
    return torch.trapezoid(acc, thresholds) / max_threshold
