"""Quaternion helpers, wxyz order.

The torch half (`quat_to_mat`, `quat_normalize`, `mat_to_quat`,
`quat_mul`, `axis_angle_to_quat`, `rotation_geodesic_deg`) is the
counterpart of `posecnn_tpu/utils/quaternion.py:15-106`, for the ADD
loss, the GT box projection, the pose errors and ICP. The numpy half is
the port's copy of `:111-164` (`mat_to_quat_np` is
`posecnn_tpu/data/minibatch.py:148-176`) for the host-side data path.
Carried, not imported, because that module imports jax.
`tests/test_torch_synthetic.py`, `tests/test_torch_add_loss.py` and
`tests/test_torch_pose_error.py` hold each equal to its original.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz quaternion → (…, 3, 3) matrix, expanded from the raw,
    unnormalised quaternion, as the reference ADD loss kernel does, so
    gradients flow through the raw components."""
    s, u, v, w = q.unbind(-1)
    rows = (
        (s * s + u * u - v * v - w * w, 2 * (u * v - s * w), 2 * (u * w + s * v)),
        (2 * (u * v + s * w), s * s - u * u + v * v - w * w, 2 * (v * w - s * u)),
        (2 * (u * w - s * v), 2 * (v * w + s * u), s * s - u * u - v * v + w * w),
    )
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_normalize(q: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) rotation matrix → (…, 4) wxyz quaternion with w ≥ 0.

    Branch-free Shepperd: all four candidates, the one of the largest
    4·q_i² kept; ties go to the first maximum, as `jnp.argmax` breaks
    them (`torch.argmax` does too)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], -1),
    ], -2)  # (…, 4 candidates, 4)
    mags = torch.stack([qw2, qx2, qy2, qz2], -1)
    idx = torch.argmax(mags, dim=-1, keepdim=True)
    best = torch.take_along_dim(cands, idx[..., None], dim=-2)[..., 0, :]
    denom = 2.0 * torch.sqrt(torch.clamp(torch.take_along_dim(mags, idx, dim=-1), min=1e-12))
    q = best / denom
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b of wxyz quaternions, broadcastable."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation by `angle` radians (…) about `axis` (…, 3) as (…, 4) wxyz."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-10)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], -1)


def rotation_geodesic_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between (…, 3, 3) rotations in degrees: the angle of
    R_est·R_gtᵀ, from its trace."""
    rel = r_est @ r_gt.transpose(-1, -2)
    cos = 0.5 * (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def quat_to_mat_np(q) -> np.ndarray:
    """(4,) wxyz quaternion → (3, 3) rotation matrix (normalising)."""
    q = np.asarray(q, np.float64)
    q = q / max(np.linalg.norm(q), 1e-12)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def mat_to_quat_np(m) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z) with w ≥ 0
    (Shepperd's method, largest-diagonal branch)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )
    if q[0] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)


def axis_angle_to_quat_np(axis, angle) -> np.ndarray:
    """Rotation by `angle` radians about `axis` as a unit quaternion."""
    a = np.asarray(axis, np.float64)
    a = a / (np.linalg.norm(a) + 1e-12)
    half = 0.5 * float(angle)
    return np.concatenate([[np.cos(half)], np.sin(half) * a]).astype(np.float32)


def quat_mul_np(a, b) -> np.ndarray:
    """Hamilton product a ⊗ b."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        np.float32,
    )
