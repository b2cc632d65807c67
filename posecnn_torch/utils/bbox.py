"""Box utilities (counterpart of `posecnn_tpu/utils/bbox.py`)."""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (…, N, 4) and (…, M, 4) xyxy boxes with the
    reference's +1 pixel-area convention (`posecnn_tpu/utils/bbox.py:13`)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    left = torch.maximum(a[..., 0], b[..., 0])
    top = torch.maximum(a[..., 1], b[..., 1])
    right = torch.minimum(a[..., 2], b[..., 2])
    bottom = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(right - left + 1.0, min=0.0)
    ih = torch.clamp(bottom - top + 1.0, min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)
