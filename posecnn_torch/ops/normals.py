"""Depth → point and normal maps (counterpart of `posecnn_tpu/ops/normals.py:17-45`)."""

from __future__ import annotations

import torch


def backproject_depth(depth: torch.Tensor, fx, fy, px, py) -> torch.Tensor:
    """depth (…, H, W) metres → point map (…, H, W, 3) in the camera frame.
    The intrinsics are floats or 0-d tensors."""
    h, w = depth.shape[-2], depth.shape[-1]
    x = (torch.arange(w, dtype=torch.float32, device=depth.device)[None, :] - px) / fx
    y = (torch.arange(h, dtype=torch.float32, device=depth.device)[:, None] - py) / fy
    return torch.stack([depth * x, depth * y, depth], dim=-1)


def depth_to_normals(depth: torch.Tensor, fx, fy, px, py, *,
                     depth_eps: float = 1e-6) -> torch.Tensor:
    """depth (H, W) → unit normal map (H, W, 3) facing the camera (n_z ≤ 0),
    zero where the depth is not above `depth_eps`. Tangents are central
    differences of the point map, one-sided at the borders (as
    `jnp.gradient`)."""
    pts = backproject_depth(depth, fx, fy, px, py)
    dx = torch.gradient(pts, dim=1, edge_order=1)[0]
    dy = torch.gradient(pts, dim=0, edge_order=1)[0]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-10)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    return torch.where((depth > depth_eps)[..., None], n, 0.0)
