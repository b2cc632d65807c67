"""SE(3) helpers on (…, 3, 4) [R|t] tensors (counterpart of
`posecnn_tpu/utils/se3.py:8-27`), batchable."""

from __future__ import annotations

import torch


def se3_mul(rt1: torch.Tensor, rt2: torch.Tensor) -> torch.Tensor:
    """rt1 ∘ rt2."""
    r = rt1[..., :3, :3] @ rt2[..., :3, :3]
    t = (rt1[..., :3, :3] @ rt2[..., :3, 3:4]) + rt1[..., :3, 3:4]
    return torch.cat([r, t], dim=-1)


def se3_inverse(rt: torch.Tensor) -> torch.Tensor:
    r_t = rt[..., :3, :3].transpose(-1, -2)
    t = -r_t @ rt[..., :3, 3:4]
    return torch.cat([r_t, t], dim=-1)


def transform_points(rt: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (…, 3, 4) [R|t] to (…, N, 3) points → (…, N, 3)."""
    return pts @ rt[..., :3, :3].transpose(-1, -2) + rt[..., None, :3, 3]
