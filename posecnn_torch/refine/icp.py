"""Depth-based pose refinement: point-plane Gauss-Newton ICP.

Counterpart of `posecnn_tpu/refine/icp.py:41-301`, the renderer-free
stand-in for the reference's `solveICP`: the class point cloud is posed
and projected into the depth map (projective association against the
back-projected point and normal maps, with a coarse z-buffer for the
model's own back surface), the translation is re-estimated from the
masked depth, and a sweep of depth offsets (× optional rotation
perturbations) is refined by damped Gauss-Newton with a trust region and
scored by the fraction of model points with a close observed point.

Where the JAX package vmaps the hypotheses of one object and scans the
iterations inside one jitted program (`posecnn_tpu/refine/icp.py:287`,
static in the iteration and hypothesis counts and the rotation sweep),
the port puts every (object, hypothesis) row of a frame into one batch
and loops the iterations in Python: about 70 launches an iteration
however many objects a frame holds, with no host read, so that the CLIs
capture the whole call as one CUDA graph per object count
(`utils/graph.compile_static`, its keywords static) and replay it.

Index arithmetic follows XLA's semantics, not torch's: JAX clamps gather
indices and converts NaN to integer 0, where torch raises on the CPU and
faults on the card. A detection's translation can be NaN (a degenerate
box fit), so NaN is mapped before every cast and indices are clamped:
the port returns what JAX returns (the initial rotation, a NaN
translation, score 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from posecnn_torch.ops.normals import backproject_depth, depth_to_normals
from posecnn_torch.utils.quaternion import mat_to_quat, quat_to_mat


class ICPResult(NamedTuple):
    quat: torch.Tensor  # (N, 4) refined rotation, wxyz
    trans: torch.Tensor  # (N, 3) refined translation
    score: torch.Tensor  # (N,) inlier fraction of the winning hypothesis
    hypothesis_scores: torch.Tensor  # (N, Hyp)
    hypothesis_rts: torch.Tensor  # (N, Hyp, 3, 4) each hypothesis's refined pose


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…, 3) axis-angle → (…, 3, 3) rotation, Taylor-safe."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-20)
    w0, w1, w2 = w.unbind(-1)
    zero = torch.zeros_like(w0)
    k = torch.stack([torch.stack([zero, -w2, w1], -1),
                     torch.stack([w2, zero, -w0], -1),
                     torch.stack([-w1, w0, zero], -1)], -2)
    small = theta < 1e-5
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)[..., None, None]
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * k + b * (k @ k)


def _index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """XLA's float → int32 conversion (NaN → 0, saturating), clipped to
    [0, hi], as a long index."""
    return torch.nan_to_num(x, nan=0.0).clamp(0, hi).long()


def _bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); u, v (…) pixel coordinates → (…, C). Out-of-image
    coordinates clamp to the border; NaN ones read pixel (0, 0) with NaN
    weights, as in JAX."""
    h, w, c = img.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0f = torch.nan_to_num(torch.floor(u), nan=0.0)
    v0f = torch.nan_to_num(torch.floor(v), nan=0.0)
    au = (u - u0f)[..., None]
    av = (v - v0f)[..., None]
    i00 = v0f.long() * w + u0f.long()
    flat = img.reshape(h * w, c)

    def at(idx):
        return flat[idx.reshape(-1)].reshape(*idx.shape, c)

    f00, f01, f10, f11 = at(i00), at(i00 + 1), at(i00 + w), at(i00 + w + 1)
    return (f00 * (1 - av) * (1 - au) + f01 * (1 - av) * au + f10 * av * (1 - au)
            + f11 * av * au)


def _self_visible(p_cam, u, v, res: int = 48, margin: float = 0.008):
    """Front-surface test per row: bucket the row's projected points into
    a res×res grid over their bounding box, take each bucket's minimum
    depth (a scatter-min on an inf buffer), keep points within `margin`
    of it. p_cam (R, P, 3); u, v (R, P) → (R, P) bool."""
    z = p_cam[..., 2]
    u0, u1 = u.amin(-1, keepdim=True), u.amax(-1, keepdim=True) + 1e-3
    v0, v1 = v.amin(-1, keepdim=True), v.amax(-1, keepdim=True) + 1e-3
    bu = _index((u - u0) / (u1 - u0) * res, res - 1)
    bv = _index((v - v0) / (v1 - v0) * res, res - 1)
    bucket = bv * res + bu
    zbuf = torch.full((z.shape[0], res * res), float("inf"), dtype=z.dtype, device=z.device)
    zbuf.scatter_reduce_(1, bucket, z, "amin", include_self=True)
    return z < zbuf.gather(1, bucket) + margin


def _pose_points(rt, model_pts):
    return model_pts @ rt[..., :3].transpose(-1, -2) + rt[..., None, :, 3]


def _associate(rt, model_pts, point_map, normal_map, fx, fy, px, py, max_dist,
               self_visibility: bool = True):
    """Projective data association of each row's posed model points with
    the observed point and normal maps. rt (R, 3, 4), model_pts (R, P, 3)
    → observed points (R, P, 3), normals (R, P, 3) and validity (R, P):
    in the image, with depth, near the observed surface along the ray and
    in space, on the model's front surface, with a normal."""
    p_cam = _pose_points(rt, model_pts)
    z = torch.clamp(p_cam[..., 2], min=1e-6)
    u = fx * p_cam[..., 0] / z + px
    v = fy * p_cam[..., 1] / z + py
    obs_p = _bilinear_sample(point_map, u, v)
    obs_n = _bilinear_sample(normal_map, u, v)
    obs_z = obs_p[..., 2]
    h, w = point_map.shape[:2]
    in_img = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    valid = in_img & (obs_z > 1e-4) & ((p_cam[..., 2] - obs_z).abs() < max_dist)
    if self_visibility:
        valid = valid & _self_visible(p_cam, u, v)
    valid = valid & (torch.linalg.vector_norm(obs_p - p_cam, dim=-1) < max_dist)
    valid = valid & (torch.linalg.vector_norm(obs_n, dim=-1) > 0.5)
    return obs_p, obs_n, valid


def _gn_step(rt, model_pts, obs_pts, obs_normals, obs_valid, damping, *,
             max_rot_step: float = 0.1, max_trans_step: float = 0.02):
    """One damped point-plane Gauss-Newton update per row, with the step's
    rotation and translation clamped (a trust region). Residual
    n·(q − (R p + t)), Jacobian rows [p' × n, n] for the twist [ω, v];
    the 6×6 normal equations solve batched in fp32, without a host
    synchronisation (a singular system gives non-finite values, which the
    caller's guard rejects, as in JAX)."""
    r, t = rt[..., :3], rt[..., 3]
    p_cam = _pose_points(rt, model_pts)
    res = (obs_normals * (obs_pts - p_cam)).sum(-1)  # (R, P)
    jac = torch.cat([torch.linalg.cross(p_cam, obs_normals, dim=-1), obs_normals], -1)
    jw = jac * obs_valid.to(jac.dtype)[..., None]
    jtj = jw.transpose(-1, -2) @ jac  # (R, 6, 6)
    eye6 = torch.eye(6, dtype=jac.dtype, device=jac.device)
    jtj = jtj + damping * torch.diag_embed(jtj.diagonal(dim1=-2, dim2=-1)) + 1e-4 * eye6
    jtr = (jw.transpose(-1, -2) @ res[..., None])[..., 0]
    delta = torch.linalg.solve_ex(jtj, jtr)[0]  # (R, 6)
    rot_n = torch.linalg.vector_norm(delta[:, :3], dim=-1)
    trn_n = torch.linalg.vector_norm(delta[:, 3:], dim=-1)
    scale = torch.minimum(
        torch.clamp(max_rot_step / torch.clamp(rot_n, min=1e-12), max=1.0),
        torch.clamp(max_trans_step / torch.clamp(trn_n, min=1e-12), max=1.0))
    delta = delta * scale[:, None]
    dr = _so3_exp(delta[:, :3])
    new_t = (dr @ t[..., None])[..., 0] + delta[:, 3:]
    return torch.cat([dr @ r, new_t[..., None]], -1)


def icp_refine_batch(quats, transs, model_pts, depth, masks, k, *, num_iters: int = 8,
                     num_hypotheses: int = 8, rot_perturb: float = 0.0,
                     hypothesis_spread: float = 0.04, max_assoc_dist: float = 0.02,
                     inlier_dist: float = 0.01, damping: float = 1e-2) -> ICPResult:
    """Refine the N object poses of one frame against its depth map.

    quats (N, 4) wxyz, transs (N, 3), model_pts (N, P, 3), depth (H, W)
    metres, masks (N, H, W) bool (each object's predicted mask), k (3, 3);
    all on one device. Each object gets num_hypotheses depth offsets in
    ±hypothesis_spread, crossed, when rot_perturb > 0, with the identity
    and ±rot_perturb radians about each camera axis (7 rotations); the
    winner is the best score less 1e-5·|perturbation|, ties to the first."""
    dev = depth.device
    n = quats.shape[0]
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    point_map = backproject_depth(depth, fx, fy, px, py)
    normal_map = depth_to_normals(depth, fx, fy, px, py)

    # translation re-estimated from the masked depth along the centre ray:
    # the observed surface is the near side, so add half the model's depth
    mvalid = masks & (depth > 1e-4)
    count = mvalid.sum((1, 2))
    mean_obs_z = torch.where(mvalid, depth, 0.0).sum((1, 2)) / torch.clamp(count, min=1)
    half_depth = 0.5 * (model_pts[..., 2].amax(-1) - model_pts[..., 2].amin(-1))
    est_z = mean_obs_z + half_depth
    factor = torch.where(transs[:, 2] > 1e-4, est_z / transs[:, 2], 1.0)
    t0 = torch.where((count > 10)[:, None], transs * factor[:, None], transs)
    r0 = quat_to_mat(quats)

    # torch.linspace: the last ulp of an offset may differ from jnp.linspace's
    offsets = torch.linspace(-hypothesis_spread, hypothesis_spread, num_hypotheses,
                             dtype=torch.float32, device=dev)
    ws = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    if rot_perturb > 0.0:
        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        ws = torch.cat([ws, rot_perturb * eye3, -rot_perturb * eye3])
    nw = ws.shape[0]
    hyp = num_hypotheses * nw
    dz = offsets.repeat_interleave(nw)  # hypothesis h = depth offset h // nw, rotation h % nw
    w_grid = ws.repeat(num_hypotheses, 1)

    # one row per (object, hypothesis), object-major
    t0z = t0[:, 2:3]
    scale = (t0z + dz[None, :]) / torch.clamp(t0z, min=1e-6)  # (N, Hyp)
    t_h = t0[:, None, :] * scale[..., None]
    r_h = _so3_exp(w_grid)[None] @ r0[:, None]
    rt = torch.cat([r_h, t_h[..., None]], -1).reshape(n * hyp, 3, 4)
    pts = model_pts.repeat_interleave(hyp, 0)

    for _ in range(num_iters):
        obs_p, obs_n, valid = _associate(rt, pts, point_map, normal_map, fx, fy, px, py,
                                         max_assoc_dist)
        rt_new = _gn_step(rt, pts, obs_p, obs_n, valid, damping)
        # keep a row's pose where its solve blew up
        ok = torch.isfinite(rt_new).all(-1).all(-1)
        rt = torch.where(ok[:, None, None], rt_new, rt)
    _, _, valid = _associate(rt, pts, point_map, normal_map, fx, fy, px, py, inlier_dist)
    scores = valid.to(torch.float32).mean(-1).reshape(n, hyp)
    rts = rt.reshape(n, hyp, 3, 4)

    # ties go toward the unperturbed rotation (a penalty far below 1/P)
    sel = scores - 1e-5 * torch.linalg.vector_norm(w_grid, dim=1)[None, :]
    best = torch.argmax(sel, dim=1)
    rt_best = rts[torch.arange(n, device=dev), best]
    return ICPResult(mat_to_quat(rt_best[..., :3]), rt_best[..., 3],
                     scores.gather(1, best[:, None])[:, 0], scores, rts)


def refine_pose_icp(quat, trans, model_pts, depth, mask, k, **kw) -> ICPResult:
    """One object: quat (4,), trans (3,), model_pts (P, 3), mask (H, W);
    the result's fields without the object axis."""
    out = icp_refine_batch(quat[None], trans[None], model_pts[None], depth, mask[None], k, **kw)
    return ICPResult(*(f[0] for f in out))
