"""TSDF and semantic-probability fusion with camera tracking (KinectFusion).

Counterpart of `posecnn_tpu/refine/fusion.py` (ref: lib/kinect_fusion/:
TSDF + probability voxels, depth fusion fusion.cu, projective point-plane
ICP icp.cu:24-234, raycast.cu, marchingCubes.cu):

  fuse      each voxel centre projected into the frame: the truncated SDF
            and the class probabilities as running averages over the
            frames that see the voxel (a gather per voxel, no scatter)
  raycast   a fixed-step march along each pixel's ray with trilinear TSDF
            samples: depth, world points and labels at the zero crossing
  track     frame-to-model point-plane Gauss-Newton of a depth frame
            against a model depth map, on `refine/icp`'s association and
            damped step
  surface   voxels near the zero level with their argmax labels (a surfel
            cloud), and a marching-tetrahedra triangle mesh with labels,
            written as a welded PLY by `save_mesh_ply`

Where the JAX package returns a new volume from `fuse_frame`, the port
updates the volume's tensors in place (and returns it), in slabs of x:
at grid 512 with 10 classes the probability volume alone is 5.4 GB, and a
whole-volume `torch.where` would make two or three more of it.

The JAX package jits `fuse_frame`, `raycast`, `track_camera` and
`extract_mesh` (`posecnn_tpu/refine/fusion.py:74`, `:145`, `:204`, `:304`);
the CLIs compile them with `utils/graph.compile_static`, one CUDA graph per
(G, C, H, W), (G, H, W, num_steps), (H, W, num_iters, max_points) and (G,
max_triangles), the volume bound in place where a program takes it
(`inplace=("vol",)`: captured at its address, never copied; `fuse_frame`
writes it, the others read it). So their bodies read nothing on the host:
their constants are device buffers made once (`utils/graph.device_constant`),
and `raycast`'s 192-step march unrolls into its graph. `extract_surface`
stays eager, as the JAX package leaves it.

Index casts follow XLA's results: a projection far outside the image is
clamped before the cast (JAX's cast saturates; torch's is undefined out
of range), which leaves every such voxel out of the image as in JAX.
`lax.top_k` keeps the lower index first among equal scores, and many
scores tie (at −inf and at equal |tsdf|): the port selects with a stable
descending sort, which orders ties the same way (`torch.topk` promises no
order).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from posecnn_torch.ops.normals import backproject_depth, depth_to_normals
from posecnn_torch.refine.icp import _associate, _gn_step
from posecnn_torch.utils.graph import device_constant


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor  # (G, G, G) signed distance, truncated, in units of the truncation
    weight: torch.Tensor  # (G, G, G)
    prob: torch.Tensor  # (G, G, G, C) class probabilities
    origin: torch.Tensor  # (3,) world position of voxel (0, 0, 0)
    voxel_size: torch.Tensor  # () metres


def create_volume(grid_size: int, num_classes: int, origin: Sequence[float], voxel_size,
                  device="cpu") -> TSDFVolume:
    g = grid_size
    return TSDFVolume(
        tsdf=torch.ones((g, g, g), dtype=torch.float32, device=device),
        weight=torch.zeros((g, g, g), dtype=torch.float32, device=device),
        prob=torch.zeros((g, g, g, num_classes), dtype=torch.float32, device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        voxel_size=torch.tensor(float(np.float32(voxel_size)), dtype=torch.float32,
                                device=device),
    )


def _index(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Float → int64 of values clamped to [lo, hi] first (in-range values
    cast as XLA's int32 cast does: toward zero)."""
    return torch.clamp(x, lo, hi).long()


def fuse_frame(vol: TSDFVolume, depth: torch.Tensor, label_prob: torch.Tensor, k: torch.Tensor,
               world2cam: torch.Tensor, truncation: float = 0.04, max_weight: float = 50.0,
               slab_bytes: int = 1 << 28) -> TSDFVolume:
    """Fuse one RGB-D frame: depth (H, W) metres, label_prob (H, W, C), the
    intrinsics k (3, 3) and the camera pose world2cam (3, 4). Voxels in
    the image, with depth, no more than `truncation` behind the surface
    take the running average of the clipped SDF / truncation and of the
    pixel's probabilities; their weight grows by 1 up to `max_weight`.
    Updates `vol` in place, `slab_bytes` of probabilities at a time, and
    returns it."""
    h, w = depth.shape
    g, c = vol.tsdf.shape[0], vol.prob.shape[-1]
    dev = vol.tsdf.device
    idx = torch.arange(g, dtype=torch.float32, device=dev)
    wy = (vol.origin[1] + idx * vol.voxel_size)[None, :, None]
    wz = (vol.origin[2] + idx * vol.voxel_size)[None, None, :]
    slab = max(1, slab_bytes // (g * g * max(c, 1) * 4))
    for x0 in range(0, g, slab):
        x1 = min(g, x0 + slab)
        wx = (vol.origin[0] + idx[x0:x1] * vol.voxel_size)[:, None, None]
        cam = [world2cam[i, 0] * wx + world2cam[i, 1] * wy + world2cam[i, 2] * wz
               + world2cam[i, 3] for i in range(3)]
        cam_z = cam[2]
        z_safe = torch.clamp(cam_z, min=1e-6)
        u = _index(torch.round(k[0, 0] * cam[0] / z_safe + k[0, 2]), -1, w)
        v = _index(torch.round(k[1, 1] * cam[1] / z_safe + k[1, 2]), -1, h)
        in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (cam_z > 1e-3)
        pix = v.clamp(0, h - 1) * w + u.clamp(0, w - 1)
        d_obs = depth.reshape(-1)[pix]
        sdf = d_obs - cam_z  # positive in front of the surface
        update = in_img & (d_obs > 1e-6) & (sdf > -truncation)
        tsdf_new = torch.clamp(sdf / truncation, -1.0, 1.0)
        tsdf, weight, prob = vol.tsdf[x0:x1], vol.weight[x0:x1], vol.prob[x0:x1]
        w_upd = update.float()
        denom = torch.clamp(weight + w_upd, min=1e-10)
        tsdf.copy_(torch.where(update, (tsdf * weight + tsdf_new) / denom, tsdf))
        p_obs = label_prob.reshape(-1, c)[pix]
        prob.copy_(torch.where(update[..., None],
                               (prob * weight[..., None] + p_obs) / denom[..., None], prob))
        weight.copy_(torch.clamp(weight + w_upd, max=max_weight))
    return vol


def _sample_tsdf(vol: TSDFVolume, pts_world: torch.Tensor) -> torch.Tensor:
    """Trilinear TSDF at (…, 3) world points; +1 outside the grid."""
    g = vol.tsdf.shape[0]
    f = (pts_world - vol.origin) / vol.voxel_size
    f0 = torch.floor(f)
    t = f - f0
    i0 = _index(f0, -1, g)
    inb = ((i0 >= 0) & (i0 < g - 1)).all(-1)
    i0c = i0.clamp(0, g - 2)
    flat = vol.tsdf.reshape(-1)
    base = (i0c[..., 0] * g + i0c[..., 1]) * g + i0c[..., 2]

    def at(dx, dy, dz):
        return flat[base + (dx * g + dy) * g + dz]

    tx, ty, tz = t.unbind(-1)
    val = (at(0, 0, 0) * (1 - tx) * (1 - ty) * (1 - tz)
           + at(1, 0, 0) * tx * (1 - ty) * (1 - tz)
           + at(0, 1, 0) * (1 - tx) * ty * (1 - tz)
           + at(0, 0, 1) * (1 - tx) * (1 - ty) * tz
           + at(1, 1, 0) * tx * ty * (1 - tz)
           + at(1, 0, 1) * tx * (1 - ty) * tz
           + at(0, 1, 1) * (1 - tx) * ty * tz
           + at(1, 1, 1) * tx * ty * tz)
    return torch.where(inb, val, 1.0)


def raycast(vol: TSDFVolume, k: torch.Tensor, cam2world: torch.Tensor, *, height: int,
            width: int, near: float = 0.3, far: float = 3.0, num_steps: int = 192):
    """Fixed-step ray march from the camera cam2world (3, 4) (ref:
    raycast.cu). Returns depth (H, W) (0 where no zero crossing), the hit
    points in the world (H, W, 3) (0 where none) and labels (H, W) (the
    argmax of the probability voxel at the hit, 0 where none)."""
    dev = vol.tsdf.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    ones = torch.ones((height, width), dtype=torch.float32, device=dev)
    dir_cam = torch.stack([(xs - k[0, 2]) / k[0, 0] * ones, (ys - k[1, 2]) / k[1, 1] * ones,
                           ones], -1)
    dir_world = torch.einsum("ij,hwj->hwi", cam2world[:, :3], dir_cam)
    origin = cam2world[:, 3]
    step = (far - near) / num_steps
    ts = near + torch.arange(num_steps, dtype=torch.float32, device=dev) * step
    hit_t = torch.full((height, width), -1.0, device=dev)
    prev = torch.ones((height, width), device=dev)
    for i in range(num_steps):
        t = ts[i]
        val = _sample_tsdf(vol, origin + dir_world * t)
        crossed = (prev > 0) & (val <= 0) & (hit_t < 0)
        frac = prev / torch.clamp(prev - val, min=1e-10)  # the zero crossing, linearly
        hit_t = torch.where(crossed, (t - step) + frac * step, hit_t)
        prev = val
    hit = hit_t > 0
    t_safe = torch.where(hit, hit_t, near)
    pts_world = origin + dir_world * t_safe[..., None]
    depth = torch.where(hit, t_safe * dir_cam[..., 2], 0.0)
    g = vol.tsdf.shape[0]
    vox = _index((pts_world - vol.origin) / vol.voxel_size, -1, g).clamp(0, g - 1)
    probs = vol.prob[vox[..., 0], vox[..., 1], vox[..., 2]]
    labels = torch.where(hit, probs.argmax(-1), 0)
    return depth, torch.where(hit[..., None], pts_world, 0.0), labels


def track_camera(depth_new: torch.Tensor, model_depth: torch.Tensor, k: torch.Tensor,
                 init_cam2model: torch.Tensor, *, num_iters: int = 10, max_points: int = 4096,
                 damping: float = 1e-2) -> torch.Tensor:
    """Frame-to-model tracking (ref: icp.cu:24-234): point-plane Gauss-Newton
    of an evenly strided subsample of the new frame's points against the
    model depth's point and normal maps; returns the (3, 4) pose. The
    association runs without the model z-buffer (`self_visibility=False`):
    the source is a depth frame, every pixel of which is visible, and the
    coarse buckets would cull oblique surfaces. A non-finite step keeps the
    previous pose."""
    h, w = depth_new.shape
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    model_pts = backproject_depth(model_depth, fx, fy, px, py)
    model_nrm = depth_to_normals(model_depth, fx, fy, px, py)
    stride = max(1, (h * w) // max_points)
    src = backproject_depth(depth_new, fx, fy, px, py).reshape(-1, 3)[::stride][None]
    valid_src = depth_new.reshape(-1)[::stride] > 1e-6
    rt = init_cam2model[None]
    for _ in range(num_iters):
        obs_p, obs_n, valid = _associate(rt, src, model_pts, model_nrm, fx, fy, px, py, 0.05,
                                         self_visibility=False)
        rt_new = _gn_step(rt, src, obs_p, obs_n, valid & valid_src, damping)
        rt = torch.where(torch.isfinite(rt_new).all(), rt_new, rt)
    return rt[0]


# --- marching tetrahedra ---
#
# Each grid cube is split into 6 tetrahedra around its v0–v6 diagonal; a
# tetrahedron gives 0-2 triangles on its iso-crossing edges
# (`posecnn_tpu/refine/fusion.py:240-290`).

# cube corner offsets, binary-ordered v0..v7
_CUBE_OFFS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1),
              (0, 1, 1))
_TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))
# tet edges (pairs of local tet-vertex ids), indexed 0..5
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# case (bit i set ⟺ tet vertex i inside, tsdf < iso) → up to 2 triangles
# of edge ids, −1 unused
_TET_TRI_TABLE = (
    ((-1, -1, -1), (-1, -1, -1)), ((0, 1, 2), (-1, -1, -1)), ((0, 4, 3), (-1, -1, -1)),
    ((1, 2, 4), (1, 4, 3)), ((1, 3, 5), (-1, -1, -1)), ((0, 3, 5), (0, 5, 2)),
    ((0, 1, 5), (0, 5, 4)), ((2, 4, 5), (-1, -1, -1)), ((2, 5, 4), (-1, -1, -1)),
    ((0, 4, 5), (0, 5, 1)), ((0, 2, 5), (0, 5, 3)), ((1, 5, 3), (-1, -1, -1)),
    ((1, 2, 4), (1, 4, 3)), ((0, 4, 3), (-1, -1, -1)), ((0, 1, 2), (-1, -1, -1)),
    ((-1, -1, -1), (-1, -1, -1)),
)


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties lower index
    first (as `lax.top_k`)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def _slab_triangles(vol: TSDFVolume, xs: torch.Tensor, iso: float, per_slab: int):
    """The candidate triangles of the cubes at x ∈ `xs` (S slabs): each
    slab's `per_slab` best, by −|tsdf| at the cube's v0, as (S, per_slab,
    3, 3) voxel-unit vertices and (S, per_slab) scores (−inf where none)."""
    dev = vol.tsdf.device
    n = vol.tsdf.shape[0] - 1
    offs, tets, edges, table = (device_constant(t, dev, torch.long)
                                for t in (_CUBE_OFFS, _TETS, _TET_EDGES, _TET_TRI_TABLE))
    ar = torch.arange(n, device=dev)
    s = xs.shape[0]
    shape = (s, 8, n, n)
    cx = (offs[:, 0][None, :, None, None] + xs[:, None, None, None]).expand(shape)
    cy = (offs[:, 1][None, :, None, None] + ar[None, None, :, None]).expand(shape)
    cz = (offs[:, 2][None, :, None, None] + ar[None, None, None, :]).expand(shape)
    vals = vol.tsdf[cx, cy, cz]  # (S, 8, n, n)
    observed = (vol.weight[cx, cy, cz] > 0).all(1)  # (S, n, n)
    corners = torch.stack([cx, cy, cz], -1).float()  # (S, 8, n, n, 3)
    tv = vals[:, tets]  # (S, 6, 4, n, n)
    tc = corners[:, tets]  # (S, 6, 4, n, n, 3)
    inside = (tv < iso).long()
    case = inside[:, :, 0] + 2 * inside[:, :, 1] + 4 * inside[:, :, 2] + 8 * inside[:, :, 3]
    pa, pb = tc[:, :, edges[:, 0]], tc[:, :, edges[:, 1]]  # (S, 6, 6, n, n, 3)
    sa, sb = tv[:, :, edges[:, 0]], tv[:, :, edges[:, 1]]
    # endpoints in one order (smaller TSDF first): tetrahedra sharing an
    # edge then interpolate its vertex bit for bit alike
    swap = (sa > sb)[..., None]
    pa, pb = torch.where(swap, pb, pa), torch.where(swap, pa, pb)
    sa, sb = torch.minimum(sa, sb), torch.maximum(sa, sb)
    frac = (iso - sa) / torch.where((sb - sa).abs() < 1e-10, 1e-10, sb - sa)
    everts = pa + frac.clamp(0.0, 1.0)[..., None] * (pb - pa)  # (S, 6, 6e, n, n, 3)
    tris_e = table[case]  # (S, 6, n, n, 2, 3)
    tri_ok = (tris_e[..., 0] >= 0) & observed[:, None, :, :, None]  # (S, 6, n, n, 2)
    everts_t = everts.movedim(2, -2)[:, :, :, :, None].expand(s, 6, n, n, 2, 6, 3)
    index = tris_e.clamp(min=0)[..., None].expand(s, 6, n, n, 2, 3, 3)
    tri_v = torch.gather(everts_t, 5, index)  # (S, 6, n, n, 2, 3, 3)
    score = (-tv[:, :, 0].abs())[..., None].expand(tri_ok.shape)
    flat_s = torch.where(tri_ok, score, float("-inf")).reshape(s, -1)
    top = _top(flat_s, per_slab)
    flat_v = tri_v.reshape(s, -1, 3, 3)
    return (torch.gather(flat_v, 1, top[..., None, None].expand(s, per_slab, 3, 3)),
            torch.gather(flat_s, 1, top))


def extract_mesh(vol: TSDFVolume, max_triangles: int = 16384, iso: float = 0.0,
                 chunk_cells: int = 1 << 20):
    """Marching-tetrahedra triangle mesh of the TSDF (ref:
    marchingCubes.cu). Each triangle is wound so that its normal points
    along the local TSDF gradient (outward). Returns (tri_verts (T, 3, 3)
    world coordinates, tri_labels (T,), tri_valid (T,) bool), T =
    max_triangles, chosen by the smallest |tsdf| at the cube's v0: each
    slab's best `max_triangles` first, then the best of those (the global
    best are a subset of the slabs' best). `chunk_cells` cubes' worth of
    slabs are processed at a time."""
    g = vol.tsdf.shape[0]
    n = g - 1
    per_slab = min(max_triangles, 12 * n * n)
    chunk = max(1, chunk_cells // (n * n))
    parts = [_slab_triangles(vol, torch.arange(x0, min(n, x0 + chunk), device=vol.tsdf.device),
                             iso, per_slab) for x0 in range(0, n, chunk)]
    tri_v = torch.cat([p[0] for p in parts]).reshape(-1, 3, 3)
    score = torch.cat([p[1] for p in parts]).reshape(-1)
    k_final = min(max_triangles, score.shape[0])
    idx = _top(score, k_final)
    valid = score[idx] > float("-inf")
    verts_vox = tri_v[idx]
    if k_final < max_triangles:
        pad = max_triangles - k_final
        verts_vox = torch.cat([verts_vox, verts_vox.new_zeros((pad, 3, 3))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    # orient along the TSDF's central difference at the centroid voxel
    cent = _index(verts_vox.mean(1), -1, g).clamp(1, g - 2)
    cx, cy, cz = cent.unbind(-1)
    t = vol.tsdf
    grad = torch.stack([t[cx + 1, cy, cz] - t[cx - 1, cy, cz], t[cx, cy + 1, cz] - t[cx, cy - 1, cz],
                        t[cx, cy, cz + 1] - t[cx, cy, cz - 1]], -1)
    geom_n = torch.linalg.cross(verts_vox[:, 1] - verts_vox[:, 0],
                                verts_vox[:, 2] - verts_vox[:, 0], dim=-1)
    flip = ((geom_n * grad).sum(-1) < 0)[:, None, None]
    swapped = torch.stack([verts_vox[:, 0], verts_vox[:, 2], verts_vox[:, 1]], 1)
    verts_vox = torch.where(flip, swapped, verts_vox)
    verts = vol.origin + verts_vox * vol.voxel_size
    # the label: the argmax class probability at the centroid voxel
    cent = _index(verts_vox.mean(1), -1, g).clamp(0, g - 1)
    labels = vol.prob[cent[:, 0], cent[:, 1], cent[:, 2]].argmax(-1)
    return verts, labels, valid


def save_mesh_ply(path: str, verts, labels=None, valid=None, weld_tol=None) -> int:
    """Write an `extract_mesh` result as an ascii PLY with welded vertices
    (ref: KinectFusion::save_model kinect_fusion.cpp:592-630) and the
    face's class as a uint8 property. Vertices weld on keys quantised by
    `weld_tol` (default 1e-5 of the bounding-box diagonal); without
    `valid`, faces whose three vertices are equal (the padding rows) are
    dropped. Faces keep their (0, 1, 2) winding, which `extract_mesh`
    already turned outward. Returns the face count."""
    verts = np.asarray(torch.as_tensor(verts).cpu(), np.float32)
    labels = None if labels is None else np.asarray(torch.as_tensor(labels).cpu())
    if valid is not None:
        keep = np.asarray(torch.as_tensor(valid).cpu()).astype(bool)
    else:
        keep = ~np.all(verts == verts[:, :1, :], axis=(1, 2))
    verts = verts[keep]
    labels = None if labels is None else labels[keep]
    flat = verts.reshape(-1, 3)
    if weld_tol is None:
        diag = float(np.linalg.norm(flat.max(0) - flat.min(0))) if len(flat) else 1.0
        weld_tol = max(diag, 1e-12) * 1e-5
    qkeys = np.round(flat / weld_tol).astype(np.int64)
    _, first, inverse = np.unique(qkeys, axis=0, return_index=True, return_inverse=True)
    unique = flat[first]
    faces = inverse.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(unique)}\n")
        f.write("property float32 x\nproperty float32 y\nproperty float32 z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uint8 int32 vertex_index\n")
        if labels is not None:
            f.write("property uint8 label\n")
        f.write("end_header\n")
        for v in unique:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for i, face in enumerate(faces):
            line = f"3 {face[0]} {face[1]} {face[2]}"
            if labels is not None:
                line += f" {int(labels[i])}"
            f.write(line + "\n")
    return len(faces)


def extract_surface(vol: TSDFVolume, threshold: float = 0.2, max_points: int = 65536):
    """Observed voxels with |tsdf| < threshold, the `max_points` nearest
    the zero level, with their argmax labels: (points (N, 3) world, labels
    (N,), valid (N,) bool), N = max_points."""
    g = vol.tsdf.shape[0]
    near_surface = (vol.tsdf.abs() < threshold) & (vol.weight > 0)
    score = torch.where(near_surface, -vol.tsdf.abs(), float("-inf")).reshape(-1)
    idx = _top(score, max_points)
    valid = score[idx] > float("-inf")
    zi, yi, xi = idx % g, (idx // g) % g, idx // (g * g)
    pts = vol.origin + torch.stack([xi, yi, zi], -1).float() * vol.voxel_size
    labels = vol.prob.reshape(-1, vol.prob.shape[-1])[idx].argmax(-1)
    return pts, labels, valid
