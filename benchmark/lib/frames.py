"""Seeded planted scenes: the frames and the class geometry every cell uses.

A frozen generator of its own (numpy only), after the planted scenes the
port's chip checks use: 480x640 RGB frames of a blocky background with sensor
noise and 3 to 8 planted objects of distinct classes, each a shaded ellipse or box in
its class's colour at a depth of 0.5-1.5 m, sized by its extent through the
camera. The class extents are 5-25 cm a side (the background's are zero).
The same seed gives the same frames, extents and order; every seed gives
the same number of frames at the same size.
"""

from __future__ import annotations

import numpy as np

# YCB-Video's camera (the dataset's published intrinsics)
YCB_K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]],
                 np.float32)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, stream)."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def class_extents(seed: int, num_classes: int, lo: float, hi: float) -> np.ndarray:
    """(C, 3) extents in metres, uniform in [lo, hi]; class 0 (background) zero."""
    ext = rng_for(seed, 1).uniform(lo, hi, (num_classes, 3)).astype(np.float32)
    ext[0] = 0.0
    return ext


def planted_frames(seed: int, count: int, height: int, width: int, num_classes: int,
                   extents: np.ndarray, objects=(3, 8), k: np.ndarray = YCB_K):
    """`count` uint8 RGB frames (H, W, 3) and, per frame, the planted objects
    as (class, cx, cy, depth) tuples."""
    rng = rng_for(seed, 2)
    palette = rng.uniform(30, 225, (num_classes, 3))
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    # one sensor-noise field, cropped at a new offset for each frame
    noise = rng.normal(0, 12, (height + 64, width + 64, 3)).astype(np.float32)
    frames, planted = [], []
    for _ in range(count):
        coarse = rng.uniform(40, 200, (height // 40 + 2, width // 40 + 2, 3)).astype(np.float32)
        oy, ox = (int(v) for v in rng.integers(0, 64, 2))
        img = (np.repeat(np.repeat(coarse, 40, 0), 40, 1)[:height, :width]
               + noise[oy:oy + height, ox:ox + width])
        n_obj = min(int(rng.integers(objects[0], objects[1] + 1)), num_classes - 1)
        classes = rng.choice(np.arange(1, num_classes), n_obj, replace=False)
        objs = []
        for cls in classes:
            depth = float(rng.uniform(0.5, 1.5))
            hw = 0.5 * float(k[0, 0]) * float(extents[cls, 0]) / depth
            hh = 0.5 * float(k[1, 1]) * float(extents[cls, 1]) / depth
            # the centre keeps the object inside the frame where it fits
            cx = float(rng.uniform(min(hw, width / 2), max(width - hw, width / 2)))
            cy = float(rng.uniform(min(hh, height / 2), max(height - hh, height / 2)))
            ellipse = rng.random() < 0.5
            angle = float(rng.uniform(0, np.pi))
            # the object's bounding box, where all its pixels lie
            y0, y1 = max(int(cy - hh), 0), min(int(cy + hh) + 2, height)
            x0, x1 = max(int(cx - hw), 0), min(int(cx + hw) + 2, width)
            by, bx = ys[y0:y1, x0:x1], xs[y0:y1, x0:x1]
            if ellipse:
                inside = ((bx - cx) / hw) ** 2 + ((by - cy) / hh) ** 2 <= 1.0
            else:
                inside = (np.abs(bx - cx) <= hw) & (np.abs(by - cy) <= hh)
            stripes = 0.75 + 0.25 * np.sin((np.cos(angle) * bx + np.sin(angle) * by) / 6.0)
            shade = palette[cls][None, None, :] * stripes[:, :, None]
            box = img[y0:y1, x0:x1]
            box[inside] = shade[inside] + rng.normal(0, 6, (int(inside.sum()), 3))
            objs.append((int(cls), cx, cy, depth))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        planted.append(objs)
    return frames, planted
