"""Non-maximum suppression with fixed shapes.

Counterpart of `posecnn_tpu/ops/nms.py:44-67`: greedy descending-score
suppression within each (batch, class) pair, returning a keep mask
aligned with the input rows. The greedy scan is a loop over the R rows
that stays on the device (no host synchronisation); R is the small RoI
buffer (max_objects per image).
"""

from __future__ import annotations

import torch

from posecnn_torch.utils.bbox import box_iou


def nms_per_class(rois: torch.Tensor, threshold: float, valid: torch.Tensor | None = None):
    """rois: (R, 7) Hough format; valid: (R,) bool. Returns (R,) bool."""
    n = rois.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=rois.device)
    # stable, as jnp.argsort: equal scores keep their row order
    order = torch.argsort(-torch.where(valid, rois[:, 6], float("-inf")), stable=True)
    sb = rois[order, 2:6]
    sv = valid[order]
    sbatch = rois[order, 0].long()
    scls = rois[order, 1].long()
    iou = box_iou(sb, sb)
    same = (sbatch[:, None] == sbatch[None, :]) & (scls[:, None] == scls[None, :])
    later = torch.arange(n, device=rois.device)[None, :] > torch.arange(n, device=rois.device)[:, None]
    can_kill = same & (iou > threshold) & later  # (N, N)

    suppressed = torch.zeros((n,), dtype=torch.bool, device=rois.device)
    kept = []
    for i in range(n):
        alive = ~suppressed[i] & sv[i]
        suppressed = suppressed | (alive & can_kill[i])
        kept.append(alive)
    keep = torch.zeros((n,), dtype=torch.bool, device=rois.device)
    if n:
        keep[order] = torch.stack(kept) & sv
    return keep
