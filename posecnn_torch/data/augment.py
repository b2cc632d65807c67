"""Image augmentation (host-side numpy): the port's copy of
`posecnn_tpu/data/augment.py:18-109`, carried because `posecnn_tpu.data`
imports jax.

Chromatic jitter in OpenCV-convention HLS on BGR images (hue ±0.01·180
H-units, lightness and saturation ±0.1·256 on the 0-255 scale) and the
reference's noise model (90%: Gaussian noise shared across channels with
variance uniform(0, 0.3·256); 10%: an axis-aligned motion blur with a
random odd kernel). Each function draws from the caller's
`np.random.RandomState` in the original's order, so the same seed gives
the same image bit for bit (`tests/test_torch_augment.py`).
"""

from __future__ import annotations

import numpy as np


def bgr_to_hls(bgr: np.ndarray) -> np.ndarray:
    """Vectorized BGR→HLS matching OpenCV float conventions:
    H in [0,180), L and S in [0,255] (for 8-bit-scaled inputs)."""
    x = bgr.astype(np.float32) / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    delta = maxc - minc
    l = 0.5 * (maxc + minc)
    denom = np.where(l <= 0.5, maxc + minc, 2.0 - maxc - minc)
    s = np.where(delta > 0, delta / np.maximum(denom, 1e-10), 0.0)
    safe = np.maximum(delta, 1e-10)
    h = np.where(
        maxc == r,
        ((g - b) / safe) % 6.0,
        np.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(delta > 0, h * 30.0, 0.0)  # OpenCV: degrees/2 ∈ [0,180)
    return np.stack([h, l * 255.0, s * 255.0], -1)


def hls_to_bgr(hls: np.ndarray) -> np.ndarray:
    """Inverse of bgr_to_hls (OpenCV conventions), output 0-255 BGR."""
    h = (hls[..., 0] * 2.0) % 360.0  # degrees
    l = hls[..., 1] / 255.0
    s = hls[..., 2] / 255.0
    c = (1.0 - np.abs(2.0 * l - 1.0)) * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    z = np.zeros_like(c)
    conds = [
        (hp < 1, (c, x, z)),
        ((hp >= 1) & (hp < 2), (x, c, z)),
        ((hp >= 2) & (hp < 3), (z, c, x)),
        ((hp >= 3) & (hp < 4), (z, x, c)),
        ((hp >= 4) & (hp < 5), (x, z, c)),
        (hp >= 5, (c, z, x)),
    ]
    r = np.zeros_like(c)
    g = np.zeros_like(c)
    b = np.zeros_like(c)
    for cond, (rv, gv, bv) in conds:
        r = np.where(cond, rv, r)
        g = np.where(cond, gv, g)
        b = np.where(cond, bv, b)
    m = l - 0.5 * c
    return np.stack([b + m, g + m, r + m], -1) * 255.0


def chromatic_transform(
    im: np.ndarray,
    rng: np.random.RandomState,
    d_h: float | None = None,
    d_s: float | None = None,
    d_l: float | None = None,
) -> np.ndarray:
    """Random hue/lightness/saturation jitter in OpenCV HLS on BGR
    images, reference magnitudes (ref: chromatic_transform
    lib/utils/blob.py:74-100): H += ±0.01·180 (mod 180),
    L/S += ±0.1·256 (clipped)."""
    if d_h is None:
        d_h = float((rng.rand() - 0.5) * 0.02 * 180.0)
    if d_l is None:
        d_l = float((rng.rand() - 0.5) * 0.2 * 256.0)
    if d_s is None:
        d_s = float((rng.rand() - 0.5) * 0.2 * 256.0)
    hls = bgr_to_hls(im.astype(np.float32))
    hls[..., 0] = (hls[..., 0] + d_h) % 180.0
    hls[..., 1] = np.clip(hls[..., 1] + d_l, 0.0, 255.0)
    hls[..., 2] = np.clip(hls[..., 2] + d_s, 0.0, 255.0)
    return np.clip(hls_to_bgr(hls), 0.0, 255.0)


def add_noise(im: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Reference noise model (ref: add_noise blob.py:109-131): with
    probability 0.9 additive Gaussian noise shared across channels,
    sigma = sqrt(uniform(0, 0.3·256)); else an axis-aligned motion
    blur with a random odd kernel length."""
    im = im.astype(np.float32)
    if rng.rand() < 0.9:
        var = rng.rand() * 0.3 * 256.0
        sigma = np.sqrt(var)
        gauss = sigma * rng.randn(im.shape[0], im.shape[1])
        noisy = im + gauss[:, :, None]
        return np.clip(noisy, 0.0, 255.0)
    sizes = (3, 5, 7, 9, 11, 15)
    size = int(sizes[rng.randint(len(sizes))])
    from scipy.ndimage import convolve1d

    axis = 1 if rng.rand() < 0.5 else 0
    kernel = np.full((size,), 1.0 / size, np.float32)
    return convolve1d(im, kernel, axis=axis, mode="nearest")
