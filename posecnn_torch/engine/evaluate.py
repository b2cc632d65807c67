"""Host-side decoding of model outputs (`posecnn_tpu/engine/evaluate.py:300-332`)."""

from __future__ import annotations

import numpy as np


def extract_detections(
    hough_rois, poses_init, poses_pred, valid, num_classes: int, *, with_indices=False
):
    """Fixed-shape outputs (numpy arrays) → (cls, quat, t) detections:
    translation from the Hough initial pose, rotation from the RoI's own
    class quaternion (or the initial one where that is ~0). Ordered by
    vote score, descending. With `with_indices` each row also carries
    its RoI index: (cls, quat, t, i)."""
    rois = np.asarray(hough_rois)
    init = np.asarray(poses_init)
    quats = np.asarray(poses_pred)
    valid = np.asarray(valid)
    dets = []
    for i in range(rois.shape[0]):
        if not valid[i]:
            continue
        cls = int(rois[i, 1])
        q = quats[i, 4 * cls : 4 * cls + 4]
        n = np.linalg.norm(q)
        q = q / n if n > 1e-6 else init[i, :4]
        dets.append((cls, q, init[i, 4:7], i))
    dets.sort(key=lambda d: -float(rois[d[3], 6]))
    if with_indices:
        return dets
    return [(c, q, t) for c, q, t, _ in dets]
