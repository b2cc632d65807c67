"""Render-and-compare pose matching loss, batched over RoIs.

Counterpart of `posecnn_tpu/ops/matching_loss.py:29-75` and of the
per-RoI matching term of `posecnn_tpu/engine/train.py:264-291`. Each
RoI's model points, posed at its predicted quaternion and translation,
are projected with the intrinsics and splatted as Gaussians (σ = 1.5
px) onto a low-resolution map; the silhouette is the max over points,
and the loss the soft-IoU mismatch 1 − Σmin(s, m) / Σmax(s, m) against
the target mask. It is differentiable in the pose by construction.

The JAX step vmaps one RoI at a time; here every RoI's (P, h, w)
Gaussians are one (R, P, h, w) tensor and one max over P, with P the
points subsampled to about 64 and h×w 60×80 at 480×640. Plain PyTorch:
the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from posecnn_torch.utils.quaternion import quat_to_mat


def soft_silhouette(quat: torch.Tensor, trans: torch.Tensor, points: torch.Tensor,
                    k: torch.Tensor, out_h: int = 60, out_w: int = 80,
                    sigma: float = 1.5) -> torch.Tensor:
    """Silhouettes of R posed models: quat (R, 4), trans (R, 3), points
    (R, P, 3), k (R, 3, 3) scaled to the output resolution → (R, out_h,
    out_w) in [0, 1]."""
    cam = torch.einsum("rpj,rij->rpi", points, quat_to_mat(quat)) + trans[:, None, :]
    z = torch.clamp(cam[..., 2], min=1e-4)
    u = k[:, 0, 0, None] * cam[..., 0] / z + k[:, 0, 2, None]
    v = k[:, 1, 1, None] * cam[..., 1] / z + k[:, 1, 2, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=quat.device)
    ys = torch.arange(out_h, dtype=torch.float32, device=quat.device)
    du = (xs[None, None, None, :] - u[..., None, None]) ** 2
    dv = (ys[None, None, :, None] - v[..., None, None]) ** 2
    g = torch.exp(-(du + dv) / (2.0 * sigma * sigma))
    return g.amax(dim=1)


def matching_loss(quat: torch.Tensor, trans: torch.Tensor, target_mask: torch.Tensor,
                  points: torch.Tensor, k: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """(R,) soft-IoU mismatch between each RoI's rendered silhouette and
    its target mask (R, h, w); arguments as `soft_silhouette`."""
    h, w = target_mask.shape[-2:]
    sil = soft_silhouette(quat, trans, points, k, out_h=h, out_w=w, sigma=sigma)
    inter = torch.minimum(sil, target_mask).sum(dim=(1, 2))
    union = torch.maximum(sil, target_mask).sum(dim=(1, 2))
    return 1.0 - inter / torch.clamp(union, min=1e-10)


def roi_matching_loss(rois: torch.Tensor, poses_pred: torch.Tensor, poses_init: torch.Tensor,
                      poses_weight: torch.Tensor, valid: torch.Tensor, label: torch.Tensor,
                      meta: torch.Tensor, points: torch.Tensor, stride: int = 8,
                      reduce: Optional[Callable] = None):
    """The training step's matching term (`posecnn_tpu/engine/train.py:264-291`):
    for each RoI with a weighted class row, its class's quaternion of
    `poses_pred` (R, 4C) and the translation of `poses_init` (R, 7)
    against the GT label mask of its class at 1/`stride` resolution,
    with the intrinsics of its image divided by `stride` and every
    `P // 64`-th point of `points` (C, P, 3). Returns (the mean over the
    matched RoIs, the number matched); `reduce` sums that number over a
    data-parallel group (the global batch's count; None: local)."""
    lab_small = label[:, ::stride, ::stride]
    k_small = meta[:, :9].reshape(-1, 3, 3) / stride
    n_cls = points.shape[0]
    p_sub = points[:, :: max(points.shape[1] // 64, 1)]
    b = rois[:, 0].long().clamp(0, lab_small.shape[0] - 1)
    cls = rois[:, 1].long().clamp(0, n_cls - 1)
    cols = 4 * cls[:, None] + torch.arange(4, device=rois.device)
    q = poses_pred.gather(1, cols)
    has = poses_weight.gather(1, cols).sum(dim=1) > 0
    mask = (lab_small[b] == cls[:, None, None]).float()
    losses = matching_loss(q, poses_init[:, 4:7], mask, p_sub[cls], k_small[b])
    matched = valid & has
    num = matched.float().sum()
    if reduce is not None:
        num = reduce(num)
    return torch.where(matched, losses, 0.0).sum() / torch.clamp(num, min=1.0), num
