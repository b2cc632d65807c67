"""Voxel-grid ops: 2D ↔ 3D feature lifting for the 3D and video
experiments (counterpart of `posecnn_tpu/ops/voxel.py`, the reference's
`Backproject`, `Project` and `Computelabel` ops).

  backproject — each voxel of a G³ grid placed in world coordinates
    (voxel step and origin meta[42:48], axis order (d, h, w) → (X, Y, Z)),
    moved by pose_world2live (meta[18:30]) and projected with K
    (meta[0:9]); the pixels of the (2k+1)² window around the rounded
    projection whose depth lies within `threshold` of the voxel's camera
    depth are averaged into its features and labels; a voxel no pixel
    hits keeps its previous label and gets flag 0.
  project — each pixel backprojected with K⁻¹ (meta[9:18]) and its depth,
    moved by pose_live2world (meta[30:42]), reads the voxel it falls in
    (0 outside the grid or without depth).
  compute_label — the argmax class of the projected label volume.

As in `ops/flow.py`, the window average is a set of shifted gathers of
the flattened maps by one int64 index a shift, over the whole batch at
once. Rounding is half to even in both packages. A projection is clamped
to ±(max(H, W) + k + 1) pixels (a voxel index to ±(G + 1)) before the
integer cast: out of bounds for every shift, as JAX's saturating cast
leaves it, where torch's cast of a huge float is undefined.
"""

from __future__ import annotations

import torch


def _voxel_centers(meta: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B, G³, 3) world coordinates of the voxel centres, flat index
    d·G² + h·G + w (`voxel.py:33-44`)."""
    g = grid_size
    idx = torch.arange(g, dtype=torch.float32, device=meta.device)
    d, h, w = (a.reshape(-1) for a in torch.meshgrid(idx, idx, idx, indexing="ij"))
    x = d[None] * meta[:, 42, None] + meta[:, 45, None]
    y = h[None] * meta[:, 43, None] + meta[:, 46, None]
    z = w[None] * meta[:, 44, None] + meta[:, 47, None]
    return torch.stack([x, y, z], -1)


def backproject(features: torch.Tensor, labels: torch.Tensor, labels_3d: torch.Tensor,
                depth: torch.Tensor, meta_data: torch.Tensor, *, grid_size: int = 32,
                kernel_size: int = 1, threshold: float = 0.02):
    """features (B, H, W, C), labels (B, H, W, L), labels_3d (B, G, G, G, L),
    depth (B, H, W), meta_data (B, 48) → (voxel_data (B, G, G, G, C),
    voxel_label (B, G, G, G, L), voxel_flag (B, G, G, G, 1))."""
    b, height, width, c = features.shape
    n_lab = labels.shape[-1]
    g = grid_size
    dev = features.device
    centers = _voxel_centers(meta_data, g)
    w2l = meta_data[:, 18:30].reshape(b, 3, 4)
    k = meta_data[:, 0:9].reshape(b, 3, 3)
    cam = centers @ w2l[:, :, :3].transpose(1, 2) + w2l[:, None, :, 3]
    proj = cam @ k.transpose(1, 2)
    z = torch.clamp(proj[..., 2], min=1e-10)
    lim = float(max(height, width) + kernel_size + 1)
    px = torch.round(torch.clamp(proj[..., 0] / z, -lim, lim)).long()
    py = torch.round(torch.clamp(proj[..., 1] / z, -lim, lim)).long()
    zvox = cam[..., 2]

    feat_flat = features.reshape(-1, c)
    lab_flat = labels.reshape(-1, n_lab)
    dep_flat = depth.reshape(-1)
    base = torch.arange(b, device=dev)[:, None] * (height * width)
    acc_f = torch.zeros((b, g ** 3, c), dtype=features.dtype, device=dev)
    acc_l = torch.zeros((b, g ** 3, n_lab), dtype=labels.dtype, device=dev)
    count = torch.zeros((b, g ** 3, 1), dtype=features.dtype, device=dev)
    for dy in range(-kernel_size, kernel_size + 1):
        for dx in range(-kernel_size, kernel_size + 1):
            uu, vv = px + dx, py + dy
            inb = (uu >= 0) & (uu < width) & (vv >= 0) & (vv < height)
            lin = base + vv.clamp(0, height - 1) * width + uu.clamp(0, width - 1)
            ok = (inb & ((dep_flat[lin] - zvox).abs() < threshold))[..., None]
            okf = ok.to(features.dtype)
            acc_f = acc_f + feat_flat[lin] * okf
            acc_l = acc_l + lab_flat[lin] * ok.to(labels.dtype)
            count = count + okf
    hit = count > 0
    denom = torch.clamp(count, min=1.0)
    data = torch.where(hit, acc_f / denom, 0.0)
    label = torch.where(hit, acc_l / denom, labels_3d.reshape(b, -1, n_lab))
    return (data.reshape(b, g, g, g, c), label.reshape(b, g, g, g, n_lab),
            hit.to(features.dtype).reshape(b, g, g, g, 1))


def _pixel_voxel_indices(depth: torch.Tensor, meta: torch.Tensor, grid_size: int):
    """(B, H, W) flat voxel index of each pixel and its validity
    (`voxel.py:110-137`)."""
    b, h, w = depth.shape
    g = grid_size
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[None, :, None]
    kinv = meta[:, 9:18].reshape(b, 3, 3)
    l2w = meta[:, 30:42].reshape(b, 3, 4)

    def row(i):
        return (kinv[:, i, 0, None, None] * xs + kinv[:, i, 1, None, None] * ys
                + kinv[:, i, 2, None, None])

    cam = torch.stack([depth * row(0), depth * row(1), depth * row(2)], -1)
    world = torch.einsum("bij,bhwj->bhwi", l2w[:, :, :3], cam) + l2w[:, None, None, :, 3]
    idx = []
    for axis in range(3):
        step = torch.clamp(meta[:, 42 + axis], min=1e-10)[:, None, None]
        pos = (world[..., axis] - meta[:, 45 + axis, None, None]) / step
        idx.append(torch.round(torch.clamp(pos, -g - 1.0, g + 1.0)).long())
    valid = depth > 1e-6
    for i in idx:
        valid = valid & (i >= 0) & (i < g)
    d_idx, h_idx, w_idx = (i.clamp(0, g - 1) for i in idx)
    return d_idx * g * g + h_idx * g + w_idx, valid


def project(voxel_data: torch.Tensor, depth: torch.Tensor,
            meta_data: torch.Tensor) -> torch.Tensor:
    """voxel_data (B, G, G, G, C) sampled at each pixel's voxel → (B, H, W, C)."""
    b, g, c = voxel_data.shape[0], voxel_data.shape[1], voxel_data.shape[-1]
    flat, valid = _pixel_voxel_indices(depth, meta_data, g)
    sampled = voxel_data.reshape(b, -1, c)[torch.arange(b, device=flat.device)[:, None, None],
                                           flat]
    return torch.where(valid[..., None], sampled, 0.0)


def compute_label(voxel_labels: torch.Tensor, depth: torch.Tensor,
                  meta_data: torch.Tensor) -> torch.Tensor:
    """The per-pixel argmax class (B, H, W) of the voxel label volume."""
    return torch.argmax(project(voxel_labels, depth, meta_data), dim=-1)
