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
graph. So a body reads nothing on the host: `estimate_center` takes its
best hypothesis with `index_select` (an index by a 0-d tensor is read on
the host). `estimate_pose_3d` on a card is two CUDA kernels
(`csrc/kabsch.cu`): `pose_hypotheses_kernel` fits and scores every
hypothesis, `pose_refine_kernel` picks the best and refines it; their
plain versions `pose_hypotheses_plain` and `pose_refine_plain` run on the
CPU, where they are the JAX body's steps in PyTorch ops. The rotation
inside both kernels is `kabsch_kernel`'s (`kabsch_rotation`, plain version
`kabsch_rotation_plain`: the SVD and the reflection fix), because
`torch.linalg.svd` on a CUDA tensor copies its solver's status to the
host, which a capture refuses.
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
    """Weighted rigid alignment dst ≈ R·src + t, batched, in PyTorch ops:
    src, dst (…, N, 3), w (…, N) → R (…, 3, 3), t (…, 3)."""
    cov, mu_s, mu_d = weighted_covariance(src, dst, w)
    r = kabsch_rotation_plain(cov)
    return r, mu_d - (r @ mu_s[..., None])[..., 0]


def _inliers_3d(r, t, obj_coords, cam_points, valid, threshold):
    pred = obj_coords @ r.transpose(-1, -2) + t[..., None, :]
    return (torch.linalg.vector_norm(pred - cam_points, dim=-1) < threshold) & valid


def pose_hypotheses_plain(obj_coords, cam_points, valid, triples, inlier_threshold):
    """`pose_hypotheses` in PyTorch ops, on any device (the vmapped `hyp`
    of `posecnn_tpu/refine/ransac.py:155-163`)."""
    w3 = valid[triples].float()  # (Hyp, 3)
    rs, ts = _kabsch(obj_coords[triples], cam_points[triples], w3)
    counts = _inliers_3d(rs, ts, obj_coords, cam_points, valid, inlier_threshold).sum(-1)
    return rs, ts, torch.where(w3.sum(-1) == 3, counts, -1)


def pose_refine_plain(obj_coords, cam_points, valid, rs, ts, scores, inlier_threshold,
                      num_refine) -> PoseEstimate:
    """`pose_refine` in PyTorch ops, on any device
    (`posecnn_tpu/refine/ransac.py:165-189`)."""
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


def _check_points(what, obj_coords, cam_points, valid, **more):
    """Raise unless obj_coords, cam_points (N, 3) fp32, valid (N,) bool and
    `more` (name -> (tensor, dtype, shape)) are contiguous on one CUDA
    device; returns N."""
    n = obj_coords.shape[0]
    want = {"obj_coords": (obj_coords, torch.float32, (n, 3)),
            "cam_points": (cam_points, torch.float32, (n, 3)),
            "valid": (valid, torch.bool, (n,)), **more}
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != obj_coords.device):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {shape} tensor on "
                             f"{obj_coords.device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    return n


def pose_hypotheses(obj_coords, cam_points, valid, triples, inlier_threshold):
    """Each hypothesis' fit to its three correspondences and its inlier
    count: obj_coords, cam_points (N, 3) fp32, valid (N,) bool, triples
    (Hyp, 3) int64 → rs (Hyp, 3, 3) fp32, ts (Hyp, 3) fp32, scores (Hyp,)
    int64 (the count of valid points within `inlier_threshold` of R s + t,
    -1 where a triple holds an invalid entry). On a CUDA tensor one launch
    of `pose_hypotheses_kernel` (`csrc/kabsch.cu`, a block a hypothesis);
    on the CPU `pose_hypotheses_plain`."""
    if obj_coords.device.type == "cpu":
        return pose_hypotheses_plain(obj_coords, cam_points, valid, triples, inlier_threshold)
    hyp = triples.shape[0]
    n = _check_points("pose_hypotheses", obj_coords, cam_points, valid,
                      triples=(triples, torch.int64, (hyp, 3)))
    device = obj_coords.device
    rs = torch.empty((hyp, 3, 3), dtype=torch.float32, device=device)
    ts = torch.empty((hyp, 3), dtype=torch.float32, device=device)
    scores = torch.empty(hyp, dtype=torch.int64, device=device)
    lib = _cuda.library("kabsch")
    with torch.cuda.device(device):
        status = lib.pose_hypotheses(
            obj_coords.data_ptr(), cam_points.data_ptr(), valid.data_ptr(), triples.data_ptr(),
            rs.data_ptr(), ts.data_ptr(), scores.data_ptr(), n, hyp, inlier_threshold,
            _cuda.device_counter(device, "pose_hyp"), torch.cuda.current_stream().cuda_stream)
    _cuda.check(status, "pose_hypotheses_kernel")
    _cuda.count("pose_hyp")
    return rs, ts, scores


def pose_refine(obj_coords, cam_points, valid, rs, ts, scores, inlier_threshold, num_refine):
    """The best hypothesis (the first of the highest score) refined
    `num_refine` times by Kabsch on its inliers (kept where fewer than 3),
    then its inlier count and share of the valid entries (both 0 where no
    hypothesis was usable): `pose_hypotheses`' outputs → PoseEstimate. On a
    CUDA tensor one launch of `pose_refine_kernel` (`csrc/kabsch.cu`, one
    block); on the CPU `pose_refine_plain`."""
    if obj_coords.device.type == "cpu":
        return pose_refine_plain(obj_coords, cam_points, valid, rs, ts, scores, inlier_threshold,
                                 num_refine)
    hyp = scores.shape[0]
    if hyp < 1 or num_refine < 0:
        raise ValueError(f"pose_refine: needs a hypothesis and num_refine >= 0, got {hyp} and "
                         f"{num_refine}")
    n = _check_points("pose_refine", obj_coords, cam_points, valid,
                      rs=(rs, torch.float32, (hyp, 3, 3)), ts=(ts, torch.float32, (hyp, 3)),
                      scores=(scores, torch.int64, (hyp,)))
    device = obj_coords.device
    rotation = torch.empty((3, 3), dtype=torch.float32, device=device)
    translation = torch.empty(3, dtype=torch.float32, device=device)
    inliers = torch.empty((), dtype=torch.float32, device=device)
    score = torch.empty((), dtype=torch.float32, device=device)
    lib = _cuda.library("kabsch")
    with torch.cuda.device(device):
        status = lib.pose_refine(
            obj_coords.data_ptr(), cam_points.data_ptr(), valid.data_ptr(), rs.data_ptr(),
            ts.data_ptr(), scores.data_ptr(), n, hyp, inlier_threshold, num_refine,
            rotation.data_ptr(), translation.data_ptr(), inliers.data_ptr(), score.data_ptr(),
            _cuda.device_counter(device, "pose_refine"), torch.cuda.current_stream().cuda_stream)
    _cuda.check(status, "pose_refine_kernel")
    _cuda.count("pose_refine")
    return PoseEstimate(rotation, translation, inliers, score)


def estimate_pose_3d(obj_coords, cam_points, valid, triples, *,
                     inlier_threshold: float = 0.02, num_refine: int = 2) -> PoseEstimate:
    """Rigid pose from 3D-3D correspondences. obj_coords, cam_points
    (N, 3) fp32, valid (N,) bool, triples (Hyp, 3) indices
    (`draw_hypotheses`): `pose_hypotheses`, then `pose_refine`; two kernel
    launches on a CUDA tensor."""
    hyps = pose_hypotheses(obj_coords, cam_points, valid, triples, inlier_threshold)
    return pose_refine(obj_coords, cam_points, valid, *hyps, inlier_threshold, num_refine)
