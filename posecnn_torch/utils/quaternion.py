"""Quaternion helpers, wxyz order.

The torch half (`quat_to_mat`, `quat_normalize`) is the counterpart of
`posecnn_tpu/utils/quaternion.py:15-33, 90-91`, differentiable, for the
ADD loss and the GT box projection. The numpy half is the port's copy of
`:111-164` (`mat_to_quat_np` is `posecnn_tpu/data/minibatch.py:148-176`)
for the host-side data path. Carried, not imported, because that module
imports jax. `tests/test_torch_synthetic.py` and
`tests/test_torch_add_loss.py` hold each equal to its original.
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
