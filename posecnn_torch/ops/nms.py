"""Non-maximum suppression with fixed shapes.

Counterpart of `posecnn_tpu/ops/nms.py`: greedy descending-score
suppression with the reference's +1 area convention, returning a keep
mask aligned with the input rows. `nms` is class-agnostic (the RPN's
proposals, the detection head's per-class boxes); `nms_per_class`
suppresses only within each (batch, class) pair of Hough RoIs.

The (N, N) suppression matrix is built on the device in one pass; the
greedy scan over the score-sorted rows, which JAX runs as a `lax.scan`,
runs on the host over that matrix, fetched once: a row that is still
alive suppresses the later rows it overlaps. Equal scores keep their
input order (a stable sort, as `jnp.argsort`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from posecnn_torch.utils.bbox import box_iou


def _greedy_keep(order: torch.Tensor, kill: torch.Tensor, sorted_valid: torch.Tensor):
    """The greedy scan over (…, N) rows: `kill[…, i, j]` says that sorted
    row i, if kept, suppresses sorted row j (j > i). Returns the keep mask
    in the input order, on the device of `order`."""
    n = order.shape[-1]
    kill_np = kill.cpu().numpy().reshape(-1, n, n)
    valid_np = sorted_valid.cpu().numpy().reshape(-1, n)
    kept = np.zeros(valid_np.shape, bool)
    for b in range(kept.shape[0]):
        suppressed = ~valid_np[b]
        for i in range(n):
            if not suppressed[i]:
                kept[b, i] = True
                suppressed |= kill_np[b, i]
    kept_t = torch.from_numpy(kept.reshape(order.shape)).to(order.device)
    return torch.zeros_like(kept_t).scatter(-1, order, kept_t)


def _sorted(scores: torch.Tensor, valid: torch.Tensor):
    """Descending-score order with invalid rows last; stable on ties."""
    return torch.argsort(-torch.where(valid, scores, float("-inf")), dim=-1, stable=True)


def _later(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(diagonal=1)


@torch.no_grad()
def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes (…, N, 4) xyxy, scores (…, N), valid (…, N) bool. Returns the
    (…, N) bool keep mask, each leading index an independent NMS
    (`posecnn_tpu/ops/nms.py:20`; the detection head runs one per class)."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    valid = valid.expand(scores.shape)
    order = _sorted(scores, valid)
    sb = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    kill = (box_iou(sb, sb) > threshold) & _later(n, boxes.device)
    return _greedy_keep(order, kill, valid.gather(-1, order))


@torch.no_grad()
def nms_per_class(rois: torch.Tensor, threshold: float, valid: Optional[torch.Tensor] = None):
    """rois: (R, 7) Hough format; valid: (R,) bool. Returns (R,) bool
    (`posecnn_tpu/ops/nms.py:44`)."""
    n = rois.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=rois.device)
    order = _sorted(rois[:, 6], valid)
    sr = rois[order]
    key = sr[:, :2].long()
    same = (key[:, None, :] == key[None, :, :]).all(-1)
    kill = same & (box_iou(sr[:, 2:6], sr[:, 2:6]) > threshold) & _later(n, rois.device)
    return _greedy_keep(order, kill, valid[order])
