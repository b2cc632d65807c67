"""RoI pooling on fixed-size RoI buffers.

Counterpart of `posecnn_tpu/ops/roi_align.py:98-179`: RoI-Align-style
bilinear sampling on an s×s grid per bin, max-reduced per bin, written
as two dense interpolation products S = Wy · F · Wxᵀ with the batch
one-hot folded into Wy. The products are plain matrix products, so
they go to `torch.matmul` / `einsum` (cuBLAS on the card).

RoIs are the Hough format (R, 7) [batch, cls, x1, y1, x2, y2, score];
features and the result are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _interp_matrix(pos: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """W[r, p, i] = max(0, 1 - |pos[r, p] - i|): clamped bilinear taps as
    a matrix (positions are pre-clipped to [0, n-1])."""
    idx = torch.arange(n, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - (pos[..., None] - idx).abs(), min=0.0).to(dtype)


def roi_align_mxu(
    features: torch.Tensor,
    rois: torch.Tensor,
    *,
    pooled_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    samples_per_bin: int = 2,
) -> torch.Tensor:
    """features: (B, H, W, C); rois: (R, 7). Returns (R, p, p, C) in the
    features' dtype."""
    b, h, w, c = features.shape
    r = rois.shape[0]
    p = pooled_size
    s = samples_per_bin
    dtype = features.dtype

    batch = rois[:, 0].long().clamp(0, b - 1)
    x1 = rois[:, 2] * spatial_scale
    y1 = rois[:, 3] * spatial_scale
    x2 = rois[:, 4] * spatial_scale
    y2 = rois[:, 5] * spatial_scale
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    ii = (torch.arange(p * s, device=rois.device) + 0.5) / s
    sx = torch.clamp(x1[:, None] + ii[None, :] * (roi_w / p)[:, None], 0.0, w - 1.0)
    sy = torch.clamp(y1[:, None] + ii[None, :] * (roi_h / p)[:, None], 0.0, h - 1.0)

    wy = _interp_matrix(sy, h, dtype)  # (R, p·s, H)
    wx = _interp_matrix(sx, w, dtype)  # (R, p·s, W)
    onehot = F.one_hot(batch, b).to(dtype)  # (R, B)
    wyb = (onehot[:, None, :, None] * wy[:, :, None, :]).reshape(r, p * s, b * h)

    f2 = features.reshape(b * h, w * c)
    t = (wyb.reshape(r * p * s, b * h) @ f2).reshape(r, p * s, w, c)
    pooled = torch.einsum("rywc,rxw->ryxc", t, wx)
    return pooled.reshape(r, p, s, p, s, c).amax(dim=(2, 4))


def roi_pool_fused(
    conv4: torch.Tensor,
    conv5: torch.Tensor,
    rois: torch.Tensor,
    *,
    pooled_size: int = 7,
) -> torch.Tensor:
    """The PoseCNN dual-scale pooled feature: pool of conv5 (1/16) plus
    pool of conv4 (1/8), (R, p, p, C)."""
    p5 = roi_align_mxu(conv5, rois, pooled_size=pooled_size, spatial_scale=1.0 / 16.0)
    p4 = roi_align_mxu(conv4, rois, pooled_size=pooled_size, spatial_scale=1.0 / 8.0)
    return p5 + p4
