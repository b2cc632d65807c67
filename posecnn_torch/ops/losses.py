"""Training losses (counterpart of `posecnn_tpu/ops/losses.py:19-46, 76-136`).

  loss_cross_entropy_single_frame — normalised CE on hard-label weights
  smooth_l1_loss                  — Fast-RCNN box smooth-L1 (the RPN's and
                                    the RoI head's box terms)
  smooth_l1_loss_vertex           — weighted smooth-L1 of the vertex map
  build_vertex_targets            — dense vertex targets from per-class
                                    centres, on the device
  softmax_cross_entropy_with_logits — sparse CE
  loss_quaternion                 — weighted 1 − (q·q̂)² (`:67`; no training
                                    step of the JAX package calls it)

Plain tensor code: elementwise work and reductions, with no product a
kernel would do better. The two count-normalised terms take `reduce`,
the sum of their normaliser over a data-parallel group
(`parallel/mesh.loss_reduce`): a rank's term is then its share of the
global batch's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _reduced(norm: torch.Tensor, reduce: Optional[Callable]) -> torch.Tensor:
    """A loss normaliser, or its sum over a data-parallel group."""
    return norm if reduce is None else reduce(norm)


def loss_cross_entropy_single_frame(log_prob: torch.Tensor, labels: torch.Tensor,
                                    reduce: Optional[Callable] = None) -> torch.Tensor:
    """log_prob: (B, H, W, C) log-softmax scores; labels: (B, H, W, C)
    one-hot weights from hard_label. `reduce` sums the normaliser over a
    data-parallel group (the global batch's Σ labels; None: local)."""
    ce = -torch.sum(labels * log_prob, dim=-1)
    return torch.sum(ce) / (_reduced(torch.sum(labels), reduce) + 1e-10)


def loss_quaternion(pose_pred: torch.Tensor, pose_targets: torch.Tensor,
                    pose_weights: torch.Tensor) -> torch.Tensor:
    """1 − (q·q̂)² quaternion distance of (R, 4C) rows, weighted by the
    rows' mean weight (ref: train.py:468-475)."""
    distances = 1.0 - torch.square(torch.sum(pose_pred * pose_targets, dim=1))
    weights = torch.mean(pose_weights, dim=1)
    return torch.sum(weights * distances) / (torch.sum(weights) + 1e-10)


def smooth_l1_loss(bbox_pred, bbox_targets, bbox_inside_weights, bbox_outside_weights,
                   sigma: float = 1.0):
    """Fast-RCNN box smooth-L1 summed over dim 1, mean over dim 0
    (`posecnn_tpu/ops/losses.py:49`)."""
    sigma_2 = sigma**2
    diff = bbox_inside_weights * (bbox_pred - bbox_targets)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    return torch.mean(torch.sum(bbox_outside_weights * in_loss, dim=1))


def smooth_l1_loss_vertex(vertex_pred: torch.Tensor, vertex_targets: torch.Tensor,
                          vertex_weights: torch.Tensor, sigma: float = 1.0,
                          reduce: Optional[Callable] = None) -> torch.Tensor:
    """Weighted smooth-L1 over the vertex map. As in the reference, the
    weight multiplies inside the huber (diff = w·(pred − target)), and
    the sum is normalised by sum(w) (summed over a data-parallel group by
    `reduce`)."""
    sigma_2 = sigma**2
    diff = vertex_weights * (vertex_pred - vertex_targets)
    abs_diff = diff.abs()
    sign = (abs_diff < 1.0 / sigma_2).to(diff.dtype).detach()
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    return torch.sum(in_loss) / (_reduced(torch.sum(vertex_weights), reduce) + 1e-10)


@torch.no_grad()
def build_vertex_targets(label: torch.Tensor, centers: torch.Tensor, log_z: torch.Tensor,
                         center_valid: torch.Tensor, weight_inside: float = 10.0):
    """Dense (B, H, W, 3C) vertex targets and weights from per-class
    scalars: label (B, H, W) int; centers (B, C, 2) projected centre
    (x, y); log_z (B, C); center_valid (B, C) bool.

    The JAX version reads each pixel's class features through a one-hot
    product at HIGHEST precision, which picks them exactly; here a gather
    on the clamped label, zeroed where the label is out of [0, C), gives
    the same values without any product (centres reach ~600 px, where a
    reduced-precision product would move them)."""
    b, h, w = label.shape
    c = centers.shape[1]
    feats = torch.stack([centers[..., 0], centers[..., 1], log_z, center_valid.float()],
                        dim=-1)  # (B, C, 4)
    lab = label.long()
    in_range = (lab >= 0) & (lab < c)
    idx = lab.clamp(0, c - 1).reshape(b, h * w)
    pix = feats.gather(1, idx[..., None].expand(b, h * w, 4)).reshape(b, h, w, 4)
    pix = torch.where(in_range[..., None], pix, 0.0)
    cx, cy, lz, cvalid_f = pix.unbind(-1)

    xs = torch.arange(w, dtype=torch.float32, device=label.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=label.device)[None, :, None]
    dx = cx - xs
    dy = cy - ys
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-10
    fg = (lab > 0) & (cvalid_f > 0.5)
    dirs = torch.stack([dx / norm, dy / norm, lz], dim=-1) * fg[..., None]  # (B, H, W, 3)

    one_hot = (F.one_hot(idx.reshape(b, h, w), c) * in_range[..., None]).float()  # (B, H, W, C)
    targets = (one_hot[..., None] * dirs[..., None, :]).reshape(b, h, w, 3 * c)
    wchan = (one_hot * fg[..., None]) * weight_inside
    weights = wchan[..., None].expand(b, h, w, c, 3).reshape(b, h, w, 3 * c)
    return targets, weights


def softmax_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax CE per row: logits (…, K), labels (…) int."""
    log_p = F.log_softmax(logits, dim=-1)
    return -log_p.gather(-1, labels.long()[..., None])[..., 0]
