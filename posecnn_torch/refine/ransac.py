"""RANSAC centre and rigid-pose estimation (counterpart of
`posecnn_tpu/refine/ransac.py:32-189`).

A fixed number of hypotheses is scored in parallel, then the best one is
refined on its inliers:

  estimate_center   hypotheses are intersections of two pixels' centre
                    direction lines, scored by the cone-inlier count over
                    all pixels; the best refined by a weighted
                    least-squares intersection of its inliers' lines.
  estimate_pose_3d  hypotheses are Kabsch alignments of three 3D-3D
                    correspondences, scored by 3D inlier distance; the
                    best refined by Kabsch on all its inliers.

Each estimator is split into a draw and a deterministic body. The JAX
package draws its hypotheses with `jax.random`, which torch cannot
reproduce: `draw_hypotheses` draws the pixel indices from a seeded
`torch.Generator`, and the bodies take them as an argument, so a test can
feed both packages the same indices.

The bodies are what the JAX package jits (`posecnn_tpu/refine/ransac.py:50`,
`:135`), and callers compile them with `utils/graph.compile_static`, one
CUDA graph per (N, Hyp) signature; the draw stays on the host, outside the
graph. So a body reads nothing on the host: the best hypothesis is taken
with `index_select` (an index by a 0-d tensor is read on the host), and
Kabsch's rotation on a card is the CUDA kernel `kabsch_kernel`
(`csrc/kabsch.cu`, `kabsch_rotation`): `torch.linalg.svd` on a CUDA tensor
copies its solver's status to the host, which a capture refuses. Its plain
version, `kabsch_rotation_plain`, the SVD and the reflection fix in
PyTorch ops, runs on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from posecnn_torch.ops import _cuda


class CenterEstimate(NamedTuple):
    center: torch.Tensor  # (2,)
    inliers: torch.Tensor  # ()
    score: torch.Tensor  # () inlier fraction


class PoseEstimate(NamedTuple):
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)
    inliers: torch.Tensor
    score: torch.Tensor


def draw_hypotheses(valid: torch.Tensor, num_hypotheses: int, size: int,
                    generator: torch.Generator, n_valid: Optional[int] = None) -> torch.Tensor:
    """(num_hypotheses, size) indices of valid entries, each drawn
    uniformly and independently, on `valid`'s device. `generator` is a
    CPU generator: the draw is the same on every device. With no valid
    entry, index 0 throughout (the bodies then report no inliers). A
    caller that knows the count of valid entries passes it as `n_valid`,
    and the draw then reads nothing from the device."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid entries first
    n_valid = max(int(valid.sum()) if n_valid is None else n_valid, 1)
    pos = torch.randint(0, n_valid, (num_hypotheses, size), generator=generator)
    return order[pos.to(valid.device)]


def _pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] for a 0-d index tensor, without reading it on the host."""
    return torch.index_select(x, 0, index.reshape(1))[0]


def _line_intersection(p0, d0, p1, d1):
    """Intersection of the 2D lines p0 + s·d0 and p1 + s·d1 (…, 2) →
    (point (…, 2), ok (…) where the lines are not parallel)."""
    a00, a10 = d0[..., 0], d0[..., 1]
    a01, a11 = -d1[..., 0], -d1[..., 1]
    rhs = p1 - p0
    det = a00 * a11 - a01 * a10
    ok = det.abs() > 1e-8
    s = (rhs[..., 0] * a11 - rhs[..., 1] * a01) / torch.where(ok, det, 1.0)
    return p0 + s[..., None] * d0, ok


def _cone_inliers(c, pixels_xy, directions, valid, threshold):
    """Pixels whose direction points at c (…, 2) within the cone: (…, N)."""
    d = c[..., None, :] - pixels_xy
    cos = (d * directions).sum(-1) / (torch.linalg.vector_norm(d, dim=-1) + 1e-10)
    return (cos > threshold) & valid


def estimate_center(pixels_xy, directions, valid, pairs, *,
                    inlier_threshold: float = 0.9) -> CenterEstimate:
    """2D object centre from direction votes. pixels_xy, directions (N, 2)
    fp32, valid (N,) bool, pairs (Hyp, 2) pixel indices (`draw_hypotheses`)."""
    ia, ib = pairs[:, 0], pairs[:, 1]
    c, ok = _line_intersection(pixels_xy[ia], directions[ia], pixels_xy[ib], directions[ib])
    ok = ok & valid[ia] & valid[ib]
    counts = _cone_inliers(c, pixels_xy, directions, valid, inlier_threshold).sum(-1)
    scores = torch.where(ok, counts, -1)
    best = torch.argmax(scores)
    any_ok = _pick(scores, best) >= 0  # no usable hypothesis on all-invalid input
    c_best = _pick(c, best)

    # weighted least squares over the best hypothesis' inliers: each line
    # through p with direction u contributes ((c − p)·n)², n ⟂ u
    w = _cone_inliers(c_best, pixels_xy, directions, valid, inlier_threshold).float()
    nx, ny = -directions[:, 1], directions[:, 0]
    proj = nx * pixels_xy[:, 0] + ny * pixels_xy[:, 1]
    a11, a12, a22 = (w * nx * nx).sum(), (w * nx * ny).sum(), (w * ny * ny).sum()
    b = torch.stack([(w * nx * proj).sum(), (w * ny * proj).sum()])
    a = torch.stack([torch.stack([a11, a12]), torch.stack([a12, a22])])
    a = a + 1e-6 * torch.eye(2, dtype=a.dtype, device=a.device)
    c_ref = torch.linalg.solve_ex(a, b)[0]
    wsum = w.sum()
    n_valid = torch.clamp(valid.sum(), min=1)
    return CenterEstimate(
        center=torch.where(wsum >= 2, c_ref, c_best),
        inliers=torch.where(any_ok, wsum, 0.0),
        score=torch.where(any_ok, wsum / n_valid, 0.0),
    )


def kabsch_rotation_plain(cov: torch.Tensor) -> torch.Tensor:
    """`kabsch_rotation` in PyTorch ops, on any device: U S Vᵀ = svd(cov),
    R = V diag(1, 1, det(V Uᵀ)) Uᵀ (`posecnn_tpu/refine/ransac.py:119-122`).
    The SVD's signs may differ between LAPACK builds; R does not where the
    singular values are distinct."""
    u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    sgn = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    return v @ sgn @ u.transpose(-1, -2)


def kabsch_rotation(cov: torch.Tensor, sweeps: bool = False):
    """The rotation R (…, 3, 3) maximising trace(R·cov) of fp32
    cross-covariances cov (…, 3, 3) (`Σ w (s − μs)(d − μd)ᵀ`), so that
    d ≈ R s + t. On a CUDA tensor one launch of `kabsch_kernel`
    (`csrc/kabsch.cu`: one thread a matrix, one-sided Jacobi sweeps), which
    also returns each matrix's sweeps (…,) int32 with `sweeps`; on the CPU
    `kabsch_rotation_plain` (no sweeps: None)."""
    if cov.device.type == "cpu":
        r = kabsch_rotation_plain(cov)
        return (r, None) if sweeps else r
    if cov.shape[-2:] != (3, 3) or cov.dtype != torch.float32:
        raise ValueError(f"kabsch_rotation: cov must be fp32 (…, 3, 3), got {cov.dtype} "
                         f"{tuple(cov.shape)}")
    flat = cov.reshape(-1, 9).contiguous()
    rot = torch.empty_like(flat)
    ran = torch.empty(flat.shape[0], dtype=torch.int32, device=cov.device) if sweeps else None
    lib = _cuda.library("kabsch")
    with torch.cuda.device(cov.device):
        status = lib.kabsch_rotations(flat.data_ptr(), rot.data_ptr(),
                                      ran.data_ptr() if sweeps else None, flat.shape[0],
                                      _cuda.device_counter(cov.device, "kabsch"),
                                      torch.cuda.current_stream().cuda_stream)
    _cuda.check(status, "kabsch_kernel")
    _cuda.count("kabsch")
    rot = rot.reshape(cov.shape)
    return (rot, ran.reshape(cov.shape[:-2])) if sweeps else rot


def weighted_covariance(src, dst, w):
    """The weighted means and cross-covariance of src, dst (…, N, 3) under
    w (…, N): (cov (…, 3, 3), mu_s (…, 3), mu_d (…, 3))."""
    wsum = torch.clamp(w.sum(-1), min=1e-10)[..., None]
    mu_s = (src * w[..., None]).sum(-2) / wsum
    mu_d = (dst * w[..., None]).sum(-2) / wsum
    cov = ((src - mu_s[..., None, :]) * w[..., None]).transpose(-1, -2) @ (dst - mu_d[..., None, :])
    return cov, mu_s, mu_d


def _kabsch(src, dst, w):
    """Weighted rigid alignment dst ≈ R·src + t, batched: src, dst
    (…, N, 3), w (…, N) → R (…, 3, 3), t (…, 3)."""
    cov, mu_s, mu_d = weighted_covariance(src, dst, w)
    r = kabsch_rotation(cov)
    return r, mu_d - (r @ mu_s[..., None])[..., 0]


def _inliers_3d(r, t, obj_coords, cam_points, valid, threshold):
    pred = obj_coords @ r.transpose(-1, -2) + t[..., None, :]
    return (torch.linalg.vector_norm(pred - cam_points, dim=-1) < threshold) & valid


def estimate_pose_3d(obj_coords, cam_points, valid, triples, *,
                     inlier_threshold: float = 0.02, num_refine: int = 2) -> PoseEstimate:
    """Rigid pose from 3D-3D correspondences. obj_coords, cam_points
    (N, 3) fp32, valid (N,) bool, triples (Hyp, 3) indices
    (`draw_hypotheses`)."""
    w3 = valid[triples].float()  # (Hyp, 3)
    rs, ts = _kabsch(obj_coords[triples], cam_points[triples], w3)
    counts = _inliers_3d(rs, ts, obj_coords, cam_points, valid, inlier_threshold).sum(-1)
    scores = torch.where(w3.sum(-1) == 3, counts, -1)
    best = torch.argmax(scores)
    any_ok = _pick(scores, best) >= 0
    r, t = _pick(rs, best), _pick(ts, best)
    for _ in range(num_refine):
        w = _inliers_3d(r, t, obj_coords, cam_points, valid, inlier_threshold).float()
        r2, t2 = _kabsch(obj_coords, cam_points, w)
        ok = w.sum() >= 3
        r, t = torch.where(ok, r2, r), torch.where(ok, t2, t)
    inl = _inliers_3d(r, t, obj_coords, cam_points, valid, inlier_threshold).float().sum()
    n_valid = torch.clamp(valid.sum(), min=1)
    return PoseEstimate(rotation=r, translation=t,
                        inliers=torch.where(any_ok, inl, 0.0),
                        score=torch.where(any_ok, inl / n_valid, 0.0))
