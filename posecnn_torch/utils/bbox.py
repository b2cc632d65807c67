"""Box utilities: IoU, regression transforms, clipping (counterpart of
`posecnn_tpu/utils/bbox.py`)."""

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


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Box → regression targets (dx, dy, log dw, log dh)
    (`posecnn_tpu/utils/bbox.py:31`)."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h
    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)], dim=-1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply regression deltas (…, N, 4k) to (…, N, 4) boxes; returns
    (…, N, 4k) (`posecnn_tpu/utils/bbox.py:52`)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[..., i::4] for i in range(4))
    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Clip (…, 4k) xyxy boxes to the image (`posecnn_tpu/utils/bbox.py:82`)."""
    x1 = torch.clamp(boxes[..., 0::4], 0.0, width - 1.0)
    y1 = torch.clamp(boxes[..., 1::4], 0.0, height - 1.0)
    x2 = torch.clamp(boxes[..., 2::4], 0.0, width - 1.0)
    y2 = torch.clamp(boxes[..., 3::4], 0.0, height - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)
