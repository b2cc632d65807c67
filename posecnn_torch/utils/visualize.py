"""Result images: label overlays and projected 3D boxes, drawn with PIL.

Counterpart of `posecnn_tpu/utils/visualize.py:21-90` (headless, no GL
and no display): `label_to_color`, `overlay_label`, `project_box_corners`,
`draw_detections` and `save_image`. Host numpy; the rotation of a box is
expanded from the raw fp32 quaternion, as the JAX version's `quat_to_mat`
does, so both packages project the same corners.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from posecnn_torch.utils.quaternion import quat_to_mat


def label_to_color(label: np.ndarray, class_colors: np.ndarray) -> np.ndarray:
    """(H, W) int labels → (H, W, 3) uint8 colours."""
    return class_colors[np.clip(label, 0, len(class_colors) - 1)].astype(np.uint8)


def overlay_label(image_rgb: np.ndarray, label: np.ndarray, class_colors: np.ndarray,
                  alpha: float = 0.5) -> np.ndarray:
    """The image with each foreground pixel blended `alpha` toward its
    class colour; uint8."""
    color = label_to_color(label, class_colors).astype(np.float32)
    out = image_rgb.astype(np.float32).copy()
    mask = (label > 0)[..., None]
    out = np.where(mask, (1 - alpha) * out + alpha * color, out)
    return np.clip(out, 0, 255).astype(np.uint8)


def project_box_corners(quat: np.ndarray, trans: np.ndarray, extent: np.ndarray,
                        k: np.ndarray) -> np.ndarray:
    """(8, 2) image-plane corners of the pose's 3D extent box."""
    xh, yh, zh = np.asarray(extent, np.float64) * 0.5
    corners = np.array([[sx * xh, sy * yh, sz * zh]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    r = quat_to_mat(torch.from_numpy(np.array(quat, np.float32))).numpy()
    cam = corners @ r.T + np.asarray(trans)
    z = np.maximum(cam[:, 2], 1e-6)
    u = k[0, 0] * cam[:, 0] / z + k[0, 2]
    v = k[1, 1] * cam[:, 1] / z + k[1, 2]
    return np.stack([u, v], 1)


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),  # z− face
    (4, 5), (4, 6), (5, 7), (6, 7),  # z+ face
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_detections(image_rgb: np.ndarray, detections: Sequence, extents: np.ndarray,
                    k: np.ndarray, class_colors: Optional[np.ndarray] = None,
                    class_names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Each (cls, quat, trans) detection's projected 3D box (2 px lines in
    its class colour, red without colours) and, with names, its label;
    returns uint8 RGB."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(image_rgb, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for cls, quat, trans in detections:
        cls = int(cls)
        color = tuple(int(c) for c in class_colors[cls]) if class_colors is not None else (
            255, 0, 0)
        uv = project_box_corners(quat, trans, extents[cls], k)
        for a, b in _BOX_EDGES:
            draw.line([tuple(uv[a]), tuple(uv[b])], fill=color, width=2)
        if class_names is not None:
            draw.text((float(uv[:, 0].min()), float(uv[:, 1].min()) - 10), class_names[cls],
                      fill=color)
    return np.asarray(img)


def save_image(path: str, image_rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(image_rgb, 0, 255).astype(np.uint8)).save(path)
