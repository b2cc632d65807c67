"""Minibatch blob construction for the synthetic scene generator.

The port's numpy copy of `posecnn_tpu/data/minibatch.py:26-131`
(`generate_vertex_targets`, `build_meta_blob`, `build_pose_blob`),
carried because `posecnn_tpu.data` imports jax. The vertex targets take
the original's numpy path (the JAX package may also run a C++ loop
there, `native/blobops.cpp`, with the same semantics in fp32).

  vertex targets — per labelled pixel of class c, channels
    [3c, 3c+1] = unit direction (centre − pixel), 3c+2 = log z
  vertex weights — `vertex_w_inside` on the 3 channels of labelled pixels
  meta blob — 48 floats [K(9), K⁻¹(9), pose_world2live(12),
    pose_live2world(12), voxel step(3), voxel min(3)]
  pose blob — (N, 13) rows [batch, cls, centre(2:4), …, quat(6:10), t(10:13)]
"""

from __future__ import annotations

import numpy as np


def generate_vertex_targets(im_label, cls_indexes, centers, zs, num_classes: int,
                            vertex_w_inside: float = 10.0):
    """Vertex targets and weights of one image, (H, W, 3C) each. The
    first instance of a class claims the pixels labelled with it."""
    h, w = im_label.shape
    targets = np.zeros((h, w, 3 * num_classes), np.float32)
    weights = np.zeros((h, w, 3 * num_classes), np.float32)
    ys, xs = np.nonzero(im_label > 0)
    if len(ys) == 0:
        return targets, weights
    labels_at = im_label[ys, xs]
    # class id -> instance row (first instance of that class)
    cls_to_inst = -np.ones(num_classes, np.int64)
    for i, c in enumerate(cls_indexes):
        if cls_to_inst[int(c)] == -1:
            cls_to_inst[int(c)] = i
    inst = cls_to_inst[labels_at]
    ok = inst >= 0
    ys, xs, labels_at, inst = ys[ok], xs[ok], labels_at[ok], inst[ok]
    dx = centers[inst, 0] - xs
    dy = centers[inst, 1] - ys
    norm = np.sqrt(dx * dx + dy * dy) + 1e-10
    base = 3 * labels_at
    targets[ys, xs, base + 0] = dx / norm
    targets[ys, xs, base + 1] = dy / norm
    targets[ys, xs, base + 2] = np.log(zs[inst])
    for off in range(3):
        weights[ys, xs, base + off] = vertex_w_inside
    return targets, weights


def build_meta_blob(k, pose_world2live=None, pose_live2world=None,
                    voxel_step=(0.0, 0.0, 0.0), voxel_min=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The 48-float meta blob of one frame."""
    meta = np.zeros(48, np.float32)
    meta[0:9] = np.asarray(k, np.float32).flatten()
    meta[9:18] = np.linalg.pinv(np.asarray(k, np.float64)).astype(np.float32).flatten()
    if pose_world2live is not None:
        meta[18:30] = np.asarray(pose_world2live, np.float32).flatten()
    if pose_live2world is not None:
        meta[30:42] = np.asarray(pose_live2world, np.float32).flatten()
    meta[42:45] = voxel_step
    meta[45:48] = voxel_min
    return meta


def build_pose_blob(batch_index: int, cls_indexes, quats, translations,
                    centers=None) -> np.ndarray:
    """(N, 13) ground-truth pose rows."""
    n = len(cls_indexes)
    blob = np.zeros((n, 13), np.float32)
    blob[:, 0] = batch_index
    blob[:, 1] = cls_indexes
    if centers is not None:
        blob[:, 2:4] = centers
    blob[:, 6:10] = quats
    blob[:, 10:13] = translations
    return blob
