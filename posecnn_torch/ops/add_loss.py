"""Average-distance (ADD / ADD-S) pose loss.

Counterpart of `posecnn_tpu/ops/add_loss.py:51-122` (the reference's
`Averagedistance` CUDA op), batched by hand over the RoIs as the JAX
version is:

  * per RoI the active class is the first class slot with weight > 0;
  * the rotations are expanded from the raw, unnormalised quaternions;
  * for a symmetric class each predicted-rotated point is matched to its
    nearest GT-rotated point, found through an fp32 Gram matrix, with the
    match index carrying no gradient (first index on ties);
  * hinge: a squared distance under `margin` adds nothing;
  * loss = Σ (d² − margin)⁺ / (2 · max(num_valid, 1) · P).

Autograd gives the backward, as `jax.grad` does for the JAX version; the
Gram matrix is a batched matrix product (cuBLAS on the card, fp32 with
TF32 off, see `cli/common.setup_device`).
"""

from __future__ import annotations

from typing import Optional

import torch

from posecnn_torch.utils.quaternion import quat_to_mat

POSE_CHANNELS = 4


def average_distance_loss(pose_pred: torch.Tensor, pose_target: torch.Tensor,
                          pose_weight: torch.Tensor, points: torch.Tensor,
                          symmetry: torch.Tensor, margin: float = 0.01,
                          num_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pose_pred, pose_target, pose_weight: (N, 4C); points: (C, P, 3);
    symmetry: (C,) > 0 for symmetric classes; num_valid: the number of
    real RoIs (default N). Returns the scalar loss."""
    n = pose_pred.shape[0]
    c, p = points.shape[0], points.shape[1]
    if num_valid is None:
        num_valid = torch.tensor(float(n), device=pose_pred.device)

    pred = pose_pred.float().reshape(n, c, POSE_CHANNELS)
    tgt = pose_target.float().reshape(n, c, POSE_CHANNELS)
    w4 = pose_weight.float().reshape(n, c, POSE_CHANNELS)

    active = w4[:, :, 0] > 0
    has_cls = active.any(dim=1)
    cls = torch.argmax(active.to(torch.uint8), dim=1)  # first active class

    pick = cls[:, None, None].expand(n, 1, POSE_CHANNELS)
    q_gt = tgt.gather(1, pick)[:, 0].detach()
    q_pred = pred.gather(1, pick)[:, 0]
    pts = points.float()[cls]  # (N, P, 3)

    r_pred = quat_to_mat(q_pred)
    r_gt = quat_to_mat(q_gt)
    x1 = torch.einsum("npk,njk->npj", pts, r_pred)
    x2 = torch.einsum("npk,njk->npj", pts, r_gt)

    gram = torch.einsum("npk,nqk->npq", x1, x2)  # (N, P, P)
    pair_sq = (x1 * x1).sum(-1)[:, :, None] - 2.0 * gram + (x2 * x2).sum(-1)[:, None, :]
    idx_min = torch.argmin(pair_sq, dim=2).detach()  # first index on ties
    x2_sym = x2.gather(1, idx_min[:, :, None].expand(n, p, 3))

    is_sym = symmetry.float()[cls] > 0
    x2_sel = torch.where(is_sym[:, None, None], x2_sym, x2)

    d2 = ((x1 - x2_sel) ** 2).sum(-1)  # (N, P)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    hinged = torch.maximum(d2 - margin, torch.zeros_like(d2))
    per_roi = torch.where(has_cls, hinged.sum(1), 0.0)
    denom = 2.0 * torch.clamp(num_valid.float(), min=1.0) * p
    return per_roi.sum() / denom
