"""Hard-label op: probability + GT label → one-hot training weights.

Counterpart of `posecnn_tpu/ops/hard_label.py:20-31` (the reference's
`Hardlabel` op): for a pixel with GT label g the weight at channel g is 1
iff g != -1 and (g > 0 or prob[g] < threshold), so background pixels the
net already classifies confidently drop out of the cross entropy. The
result carries no gradient, as the reference registers a zero gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def hard_label(prob: torch.Tensor, gt_label: torch.Tensor, threshold: float) -> torch.Tensor:
    """prob: (B, H, W, C) softmax probabilities; gt_label: (B, H, W) int.
    Returns (B, H, W, C) one-hot weights in prob's dtype."""
    num_classes = prob.shape[-1]
    safe_gt = gt_label.long().clamp(0, num_classes - 1)
    prob_at_gt = prob.gather(-1, safe_gt[..., None])[..., 0]
    keep = (gt_label != -1) & ((gt_label > 0) | (prob_at_gt < threshold))
    return F.one_hot(safe_gt, num_classes).to(prob.dtype) * keep[..., None].to(prob.dtype)
