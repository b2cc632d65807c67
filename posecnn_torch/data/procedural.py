"""Procedural class library for the server's synthetic stand-in geometry.

The port's copy of `posecnn_tpu/data/procedural.py:42-247, 483-504`
(numpy only): `make_procedural_objects` and `synthetic_class_library`,
which `cli/serve.py` uses for the class extents when no dataset root is
given. It is carried here because `posecnn_tpu.data` imports jax. Same
seed, same numbers: `tests/test_torch_posecnn.py` holds the two equal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ProceduralObjects(NamedTuple):
    points: np.ndarray  # (C, P, 3) float32 surface points, object frame
    colors: np.ndarray  # (C, P, 3) float32 RGB in [0, 255]
    normals: np.ndarray  # (C, P, 3) float32 unit outward normals
    extents: np.ndarray  # (C, 3) float32 axis-aligned full extents
    symmetry: np.ndarray  # (C,) float32, >0 for symmetric classes


# ---------------------------------------------------------------------------
# primitive surface samplers — each returns (points, normals, uv)
# where uv are 2D texture coordinates on the surface (used for checker
# patterns). All sampling is area-weighted.
# ---------------------------------------------------------------------------


def _sample_box(rng, n, hx, hy, hz):
    """Uniform-by-area sampling on a box surface."""
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    a = rng.uniform(-1, 1, n)
    b = rng.uniform(-1, 1, n)
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    uv = np.zeros((n, 2), np.float32)
    for f in range(6):
        m = face == f
        ax = f // 2  # 0:x, 1:y, 2:z
        sign = 1.0 if f % 2 == 0 else -1.0
        h = (hx, hy, hz)[ax]
        o1, o2 = [i for i in range(3) if i != ax]
        h1, h2 = (hx, hy, hz)[o1], (hx, hy, hz)[o2]
        pts[m, ax] = sign * h
        pts[m, o1] = a[m] * h1
        pts[m, o2] = b[m] * h2
        nrm[m, ax] = sign
        uv[m, 0] = a[m] * h1
        uv[m, 1] = b[m] * h2
    # face id rides along so the texture can paint faces differently
    return pts, nrm, uv, face


def _sample_cylinder(rng, n, radius, half_h, caps=True):
    """Uniform-by-area sampling on a cylinder (axis = z)."""
    lat = 2 * np.pi * radius * (2 * half_h)
    cap = np.pi * radius * radius
    areas = np.array([lat, cap, cap]) if caps else np.array([lat, 0.0, 0.0])
    part = rng.choice(3, size=n, p=areas / areas.sum())
    theta = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    uv = np.zeros((n, 2), np.float32)
    m = part == 0
    z = rng.uniform(-half_h, half_h, n)
    pts[m, 0] = radius * np.cos(theta[m])
    pts[m, 1] = radius * np.sin(theta[m])
    pts[m, 2] = z[m]
    nrm[m, 0] = np.cos(theta[m])
    nrm[m, 1] = np.sin(theta[m])
    uv[m, 0] = radius * theta[m]
    uv[m, 1] = z[m]
    for p, sign in ((1, 1.0), (2, -1.0)):
        m = part == p
        r = radius * np.sqrt(rng.uniform(0, 1, int(m.sum())))
        pts[m, 0] = r * np.cos(theta[m])
        pts[m, 1] = r * np.sin(theta[m])
        pts[m, 2] = sign * half_h
        nrm[m, 2] = sign
        uv[m, 0] = pts[m, 0]
        uv[m, 1] = pts[m, 1]
    return pts, nrm, uv, part + 6  # part ids distinct from box faces


# distinct, saturated part palette (RGB 0-255); indexed per part so
# every face/part of an object has its own base color — like the
# distinctly-printed faces of YCB boxes (cracker box, sugar box, …)
_PALETTE = np.array(
    [
        [219, 68, 55], [66, 133, 244], [244, 180, 0], [15, 157, 88],
        [171, 71, 188], [255, 112, 67], [0, 172, 193], [124, 179, 66],
        [255, 202, 40], [92, 107, 192], [240, 98, 146], [38, 198, 218],
    ],
    np.float32,
)


def _texture(uv, part_ids, color_offset, checker, rotsym_theta=None):
    """Per-point RGB from part base color + checker modulation.

    rotsym_theta: if given (surface-of-revolution classes), the checker
    uses ONLY the axial coordinate so the texture is invariant to
    rotation about z — keeping the symmetry flag honest."""
    base = _PALETTE[(part_ids + color_offset) % len(_PALETTE)]
    # SMOOTH modulation (sinusoidal, not binary stripes) with a period
    # well above the ~5.5 mm point spacing: neighboring surface points
    # get close colors, so sparse-splat z-fighting does not flicker
    # pixel colors between nearby renders — binary stripes (and fine
    # periods) measurably drowned the rotation signal in noise
    tau = 2.0 * np.pi / checker
    if rotsym_theta is not None:
        mod = 0.7 + 0.3 * np.sin(tau * uv[:, 1])  # axial bands only
    else:
        mod = 0.7 + 0.15 * np.sin(tau * uv[:, 0]) + 0.15 * np.sin(tau * uv[:, 1])
    return np.clip(base * mod[:, None], 0, 255).astype(np.float32)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def make_procedural_objects(
    num_classes: int,
    points_per_class: int = 2620,
    seed: int = 0,
    symmetric_every: int = 5,
) -> ProceduralObjects:
    """Build the class library. Class 0 is background (all zeros).

    Classes with ``c % symmetric_every == 0`` (c>0) are plain textured
    cylinders with z-rotation-symmetric texture → symmetry flag 1
    (exercises ADD-S; ref symmetric YCB classes 024_bowl/036_wood_block
    etc., lib/datasets/lov.py symmetry list). All other classes are
    asymmetric two/three-part compositions.
    """
    rng = np.random.RandomState(seed)
    c_, p_ = num_classes, points_per_class
    points = np.zeros((c_, p_, 3), np.float32)
    colors = np.zeros((c_, p_, 3), np.float32)
    normals = np.zeros((c_, p_, 3), np.float32)
    symmetry = np.zeros((c_,), np.float32)

    for c in range(1, c_):
        if symmetric_every > 0 and c % symmetric_every == 0:
            # surface of revolution: cylinder (can/bowl-like)
            radius = rng.uniform(0.03, 0.055)
            half_h = rng.uniform(0.04, 0.1)
            pts, nrm, uv, part = _sample_cylinder(rng, p_, radius, half_h)
            checker = rng.uniform(0.05, 0.09)
            # rotation-invariant texture coordinate: axial position on
            # the lateral surface, RADIUS on the caps (the cap uv from
            # the sampler is (x, y), which would break z-symmetry)
            rcoord = np.linalg.norm(pts[:, :2], axis=1)
            axial = np.where(np.abs(nrm[:, 2]) > 0.5, rcoord + 2.0 * half_h, pts[:, 2])
            sym_uv = np.stack([np.zeros_like(axial), axial], 1)
            col = _texture(sym_uv, part, c, checker, rotsym_theta=True)
            symmetry[c] = 1.0
        else:
            # asymmetric composition: main box + offset second part
            # (+ small knob) — a crude "mug/drill/clamp" family
            n_main = int(p_ * 0.62)
            n_sec = int(p_ * 0.28)
            n_knob = p_ - n_main - n_sec
            hx = rng.uniform(0.025, 0.08)
            hy = rng.uniform(0.025, 0.08)
            hz = rng.uniform(0.04, 0.11)
            if rng.rand() < 0.5:
                m_pts, m_nrm, m_uv, m_part = _sample_box(rng, n_main, hx, hy, hz)
            else:
                m_pts, m_nrm, m_uv, m_part = _sample_cylinder(
                    rng, n_main, min(hx, hy), hz
                )
            # secondary part: a slab/handle attached off-axis (the
            # asymmetry that makes orientation decidable)
            s_hx = rng.uniform(0.01, 0.03)
            s_hy = rng.uniform(0.01, 0.03)
            s_hz = rng.uniform(0.03, 0.07)
            s_pts, s_nrm, s_uv, s_part = _sample_box(rng, n_sec, s_hx, s_hy, s_hz)
            rot = _rot_y(rng.uniform(0.3, 1.2)) @ _rot_x(rng.uniform(-0.5, 0.5))
            off = np.array(
                [hx + s_hx * 0.8, rng.uniform(-hy, hy) * 0.5, rng.uniform(-hz, hz) * 0.5],
                np.float32,
            )
            s_pts = s_pts @ rot.T + off
            s_nrm = s_nrm @ rot.T
            # knob: small box on one face only (a top-vs-bottom cue)
            k_h = rng.uniform(0.008, 0.018)
            k_pts, k_nrm, k_uv, k_part = _sample_box(rng, n_knob, k_h, k_h, k_h)
            k_off = np.array([0.0, 0.0, hz + k_h], np.float32)
            k_pts = k_pts + k_off

            pts = np.concatenate([m_pts, s_pts, k_pts])
            nrm = np.concatenate([m_nrm, s_nrm, k_nrm])
            checker = rng.uniform(0.05, 0.09)
            col = np.concatenate(
                [
                    _texture(m_uv, m_part, c, checker),
                    _texture(s_uv, s_part + 3, c + 4, checker),
                    _texture(k_uv, k_part, c + 7, checker),
                ]
            )
        # center to the bounding-box center (object frame convention of
        # the reference models: origin at model center)
        center = (pts.min(0) + pts.max(0)) / 2
        pts = pts - center
        points[c] = pts
        colors[c] = col
        normals[c] = nrm
    extents = np.abs(points).max(1) * 2
    return ProceduralObjects(points, colors, normals, extents, symmetry)



def synthetic_class_library(
    num_classes: int, num_points: int = 2620, seed: int = 0
) -> ProceduralObjects:
    """The canonical procedural class library for every synthetic
    fallback path (train_net, test_net, demo, CLIs, benches).

    One seed everywhere: a model trained on these classes is evaluated
    and refined against IDENTICAL geometry — the role the on-disk YCB
    model library plays for the reference (lib/datasets/lov.py
    points_all). Subsampling uses the same linspace rule as the ADD
    loss feed so point identities line up across consumers."""
    obj = make_procedural_objects(num_classes, 2620, seed=seed)
    if num_points != obj.points.shape[1]:
        idx = np.linspace(0, obj.points.shape[1] - 1, num_points).astype(int)
        obj = ProceduralObjects(
            obj.points[:, idx], obj.colors[:, idx], obj.normals[:, idx],
            obj.extents, obj.symmetry,
        )
    return obj
