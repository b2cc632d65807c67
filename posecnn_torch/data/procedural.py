"""Procedural class library and the appearance of dataset model clouds.

The port's copy of `posecnn_tpu/data/procedural.py:42-530` (numpy and
scipy): `make_procedural_objects` and `synthetic_class_library`, which
`cli/serve.py` uses for the class extents when no dataset root is given
and `cli/train_net.py` trains on; `colorize_model_library` and
`fill_missing_points`, the deterministic paint and normals (and, for
LINEMOD, the stand-in clouds at the real extents) that the dataset
branches of `train_net` and `test_net` render their xyz-only model
clouds with, and `apply_orient_markers`, their orientation paint; and
`load_background_pool` for the training renders' backgrounds. It is
carried here because `posecnn_tpu.data` imports jax. Same seed, same
numbers: `tests/test_torch_posecnn.py` and
`tests/test_torch_procedural_colorize.py` hold the two equal.
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


def _hsv_to_rgb(h: float, s: float, v: float) -> np.ndarray:
    """Scalar HSV→RGB (h in [0,1)), returns float32 [0,255] RGB."""
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]
    return np.asarray(rgb, np.float32) * 255.0


def apply_orient_markers(
    points: np.ndarray, colors: np.ndarray, version: int = 3
) -> np.ndarray:
    """ORIENTATION-DISCRIMINATIVE paint, v3 (r5 redesign) / v4.

    v4 (r6 laggard fix, flag-gated via cfg.train.paint_version so
    in-flight v3 runs stay train/eval consistent): the r6 laggard
    diagnosis (docs/artifacts/r6/rotation_laggards.md) found classes
    whose ±axis CAPS hide for ~half of viewing directions — the v3
    markers cover only the top ~7% of each axis extreme, so a face
    seen flat-on shows mostly the 55%-weight posmap, whose gradient is
    weak over a small crop. v4 adds FULL-FACE hue coverage: every
    point is assigned to its dominant-axis face and that face's marker
    hue is BLENDED in (not replacing the posmap, which still resolves
    in-plane spin), so any visible face identifies the orientation
    octant from any viewpoint. Measured by the NN-in-pixel-space data
    bound (experiments/probe_data_nn.py --paint_version).

    The r4 octant-BRIGHTNESS ramp was provably insufficient: the
    renderer multiplies every color by a per-scene Lambertian shade
    from a RANDOM light direction with the same dynamic range as the
    ramp — brightness-coded orientation is unrecoverable without
    first solving for the light, and the pixel-space NN oracle
    measured 113 deg vs 127 deg chance (probe_data_nn.py): the
    appearance did not determine rotation, so no recipe could train
    it. Orientation must ride in HUE, which achromatic shading
    preserves exactly. Two chroma components in the OBJECT frame:

    - smooth position->RGB field (R~x, G~y, B~z): every LOCAL patch
      carries orientation-identifying chroma — the conv-friendly
      component (the r5 tiny-CNN calibration showed discrete markers
      alone generalize slowly; convs learn local texture->value maps
      far faster than global layout reasoning). Blended 55/45 with
      the incoming class paint so seg keeps a per-class color shift.
    - six fixed, maximally-separated hues on the caps of the ±X/±Y/±Z
      extremes (a colored die; the analog of the printed labels that
      make real YCB meshes orientable). Caps are disjoint (each point
      joins only its DOMINANT axis's marker) and coverage-bounded
      (top ~7% of points each — a fixed coordinate threshold painted
      100% of a cube and 2.5% of a sphere).
    """
    n = len(points)
    ctr = points.mean(axis=0, keepdims=True)
    q = points - ctr
    half = np.abs(q).max(axis=0) + 1e-9  # per-axis half-extent
    qn = q / half[None, :]  # normalized to [-1, 1] per axis
    posmap = 127.5 * (1.0 + 0.9 * qn)
    colors = 0.45 * colors + 0.55 * posmap
    marker_hues = [0.0, 0.55, 0.33, 0.83, 0.12, 0.66]
    # (+X red, -X azure, +Y green, -Y purple, +Z orange, -Z cyan)
    dom = np.argmax(np.abs(qn), axis=1)
    if version >= 4:
        # full-face blend: every point gets its dominant face's hue at
        # 45% weight (posmap + base keep 55%, preserving the local
        # gradient that disambiguates in-plane spin)
        face = 2 * dom + (np.take_along_axis(qn, dom[:, None], 1)[:, 0] < 0)
        face_rgb = np.stack(
            [_hsv_to_rgb(marker_hues[m], 0.95, 0.95) for m in range(6)]
        )[face]
        colors = 0.55 * colors + 0.45 * face_rgb
    cap_k = max(int(round(0.07 * n)), 4)
    for m, (axis, sgn) in enumerate(
        [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
    ):
        score = np.where(dom == axis, sgn * qn[:, axis], -np.inf)
        order = np.argsort(-score)
        take = order[: min(cap_k, int((score > 0).sum()))]
        colors[take] = _hsv_to_rgb(marker_hues[m], 0.95, 0.95)
    return colors


def colorize_point_cloud(
    points: np.ndarray,
    seed: int,
    base_hue: float | None = None,
    orient_detail: bool = False,
    paint_version: int = 3,
):
    """Synthesize rotation-discriminative appearance for a raw xyz
    cloud — the on-disk YCB models ship points only
    (<LOV>/models/*/points.xyz, loaded by data/datasets.py), no
    texture or normals, so flat-color rendering of them is nearly
    rotation-invariant (the round-2 rotation plateau).

      colors  — smooth two-tone procedural paint: two palette colors
                blended by a low-frequency wave field in OBJECT frame,
                shaded by a second field (≈4–9 cm periods, well above
                the ~5 mm point spacing so splat z-fighting does not
                flicker);
      normals — local-PCA surface normals (smallest-eigenvector of the
                12-NN covariance), oriented outward from the centroid —
                drives Lambertian shading at render time.

    Painting is deterministic per (class geometry, seed): training,
    eval and the demo see the same appearance.
    """
    rng = np.random.RandomState(seed)
    n = len(points)
    if base_hue is not None:
        # CLASS-IDENTITY-PRESERVING paint: both tones share the class's
        # hue (one bright/saturated, one dark), so per-pixel class
        # identity stays as color-separable as the reference's
        # distinctly colored YCB objects — a from-scratch seg head must
        # not need shape understanding just to name the class — while
        # the wave pattern + shading still carry rotation. (First
        # attempt used two RANDOM palette colors per class; measured on
        # the 40k flagship run it halved seg convergence speed.)
        c1 = _hsv_to_rgb(base_hue, 0.85, 0.95)
        c2 = _hsv_to_rgb((base_hue + rng.uniform(-0.06, 0.06)) % 1.0, 0.9, 0.45)
    else:
        i1, i2 = rng.choice(len(_PALETTE), 2, replace=False)
        c1, c2 = _PALETTE[i1], _PALETTE[i2]
    waves = []
    for _ in range(2):
        d = rng.randn(3)
        d /= np.linalg.norm(d) + 1e-12
        lam = rng.uniform(0.04, 0.09)
        waves.append((2.0 * np.pi / lam) * d)
    phase = rng.uniform(0, 2 * np.pi, 2)
    mix = 0.5 + 0.5 * np.sin(points @ waves[0] + phase[0])
    tone = 0.7 + 0.3 * np.sin(points @ waves[1] + phase[1])
    colors = (c1[None] * (1 - mix[:, None]) + c2[None] * mix[:, None]) * tone[:, None]
    if orient_detail:
        colors = apply_orient_markers(points, colors, version=paint_version)
    colors = np.clip(colors, 0, 255).astype(np.float32)

    # PCA normals over 12-NN, outward-oriented
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, nn = tree.query(points, k=min(12, n))
    nbr = points[nn]  # (N, k, 3)
    centered = nbr - nbr.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    normals = vecs[:, :, 0]
    outward = points - points.mean(axis=0)
    flip = np.sign(np.sum(normals * outward, axis=1, keepdims=True))
    flip[flip == 0] = 1.0
    normals = (normals * flip).astype(np.float32)
    return colors, normals


def colorize_model_library(
    points_all: np.ndarray, seed: int = 0, orient_detail: bool = False,
    paint_version: int = 3,
):
    """Per-class appearance for a (C, P, 3) model library (class 0 =
    background, left zero). Returns (colors, normals), both (C, P, 3).

    orient_detail=True applies the v3 hue-marker orientation paint
    (apply_orient_markers via colorize_point_cloud: fixed hues on the
    ±axis caps + a smooth position→RGB chroma field, chosen because
    chroma survives the achromatic Lambertian shading that washed out
    the v2 brightness ramp — docs/BENCH_NOTES.md r5 rotation campaign).
    Gate via cfg.train.orient_paint so training, eval and the demo all
    see the same appearance; checkpoints trained with it off evaluate
    wrong under it (and vice versa)."""
    c, p, _ = points_all.shape
    colors = np.zeros((c, p, 3), np.float32)
    normals = np.zeros((c, p, 3), np.float32)
    for cls in range(1, c):
        if not np.any(points_all[cls]):
            continue
        # evenly spaced class hues (maximal min pairwise separation —
        # measured better than golden-ratio spacing at C=22)
        colors[cls], normals[cls] = colorize_point_cloud(
            points_all[cls], seed=seed * 1000 + cls,
            base_hue=(cls - 1) / max(c - 1, 1),
            orient_detail=orient_detail,
            paint_version=paint_version,
        )
    return colors, normals


def fill_missing_points(
    points_all: np.ndarray, extents: np.ndarray, seed: int = 0,
    orient_detail: bool = False, paint_version: int = 3,
):
    """Fill all-zero class rows of a dataset model library with
    procedural surface clouds scaled to the class's REAL extents.

    The LINEMOD tree in this environment ships extents.txt but no
    models/*/points.xyz (data/datasets.py loads zeros) — training and
    the 0.1·diameter eval need actual clouds. Synthesized stand-ins
    keep the real per-axis extents, so projected box sizes, Hough
    gates and diameter thresholds stay true to the benchmark object
    sizes. Classes that DO have on-disk points are kept and only
    painted. Returns (points, colors, normals).
    """
    c, p, _ = points_all.shape
    points = points_all.astype(np.float32).copy()
    colors = np.zeros((c, p, 3), np.float32)
    normals = np.zeros((c, p, 3), np.float32)
    proc = make_procedural_objects(c, p, seed=seed, symmetric_every=0)
    for cls in range(1, c):
        if not np.any(points[cls]):
            src = proc.points[cls]
            src_ext = np.abs(src).max(0) * 2
            scale = np.where(
                src_ext > 1e-6, extents[cls] / np.maximum(src_ext, 1e-6), 1.0
            )
            points[cls] = src * scale[None, :]
            # normals transform with the inverse-transpose of the
            # per-axis scale; renormalize
            n = proc.normals[cls] / np.maximum(scale[None, :], 1e-6)
            normals[cls] = n / (
                np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
            )
            colors[cls] = proc.colors[cls]
        else:
            colors[cls], normals[cls] = colorize_point_cloud(
                points[cls], seed=seed * 1000 + cls
            )
        if orient_detail:
            colors[cls] = np.clip(
                apply_orient_markers(
                    points[cls], colors[cls], version=paint_version
                ), 0, 255,
            )
    return points, colors, normals


_LIB_CACHE: dict = {}


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


def load_background_pool(paths, size_hw=None):
    """(N, H, W, 3) float32 BGR frames in [0, 255] read from `paths`
    (resized to size_hw), for compositing behind synthetic renders. Raises
    if PIL is absent, `paths` is empty or a file cannot be read: the
    caller asked for these frames."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("reading background frames needs PIL (pillow)") from err
    if not paths:
        raise ValueError("no background frames given")
    ims = []
    for p in paths:
        try:
            im = Image.open(p).convert("RGB")
        except OSError as err:
            raise OSError(f"cannot read background frame {p!r}: {err}") from err
        if size_hw is not None:
            im = im.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
        ims.append(np.asarray(im, np.float32)[:, :, ::-1])  # RGB → BGR, the blob order
    return np.stack(ims)
