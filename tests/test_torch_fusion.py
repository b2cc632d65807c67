"""Port parity: `refine/fusion` (TSDF and probability fusion, raycast, camera
tracking, surfaces and the mesh) against `posecnn_tpu/refine/fusion.py` on
the CPU.

The scene is analytic: a tilted plane behind a sphere, seen at 48×64 from
three camera poses that turn and shift a little; each frame's depth is the
exact ray intersection, its label probabilities a noisy one-hot of the
hit surface. On the same inputs:

- `create_volume`, then three `fuse_frame`s at a 24³ grid: TSDF, weights
  and probabilities within 1e-5 (XLA fuses the projection's products and
  sums into FMAs; an ulp of SDF is 25 ulps of TSDF at a 4 cm truncation).
  The port updates in place, in slabs of x: one slab and several agree
  bit for bit;
- `raycast` from each pose: depth and points within 1e-5, labels equal;
- `track_camera` of frame 2 against the raycast of pose 1: the pose within
  1e-4;
- `extract_surface`: points, labels and valid flags equal;
- `extract_mesh`: triangle vertices within 1e-5, labels and valid flags
  equal (the port in one chunk of slabs and in several);
- `save_mesh_ply` on both meshes: the same vertex and face counts, the
  same faces, the welded vertices within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.refine.fusion as jfusion
from posecnn_torch.refine import fusion

torch.set_num_threads(1)
H, W, C, G = 48, 64, 3, 24
# off-round intrinsics and grid: with round ones, voxel centres project
# exactly onto pixel edges (x.5), where an ulp of difference in the
# projection picks the neighbouring pixel
K = np.array([[50.3, 0, W / 2 + 0.37], [0, 50.3, H / 2 - 0.21], [0, 0, 1]], np.float32)
ORIGIN, VOXEL = (-0.613, -0.457, 0.6071), 0.0503


def pose(angle, shift):
    """world→camera (3, 4): `angle` rad about y, `shift` m along x."""
    c, s = np.cos(angle), np.sin(angle)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.concatenate([r, [[shift], [0.02 * angle], [0.0]]], 1).astype(np.float32)


def render(w2c, rs):
    """Depth (H, W) and noisy one-hot label probabilities (H, W, C) of the
    scene: a sphere (class 1) before the plane z = 1.3 + 0.2 x (class 2)."""
    r, t = w2c[:, :3].astype(np.float64), w2c[:, 3].astype(np.float64)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1)
    o, d = -r.T @ t, d_cam @ r  # world ray origin and direction (rows of r.T @ d_cam)
    # plane: z − 0.2 x = 1.3
    t_plane = (1.3 - (o[2] - 0.2 * o[0])) / (d[..., 2] - 0.2 * d[..., 0])
    centre, rad = np.array([0.0, 0.0, 1.1]), 0.15
    oc = o - centre
    b = (d * oc).sum(-1)
    a = (d * d).sum(-1)
    disc = b * b - a * ((oc * oc).sum() - rad * rad)
    t_sphere = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a, np.inf)
    hit_sphere = t_sphere < t_plane
    depth = np.where(hit_sphere, t_sphere, t_plane).astype(np.float32)  # d_cam.z = 1
    depth[:4, :6] = 0.0  # a hole without depth
    label = np.where(hit_sphere, 1, 2)
    prob = np.eye(C)[label] + 0.1 * rs.rand(H, W, C)
    return depth, (prob / prob.sum(-1, keepdims=True)).astype(np.float32)


POSES = [pose(0.0, 0.0), pose(0.03, 0.02), pose(-0.02, 0.04)]


def c2w(w2c):
    r = w2c[:, :3]
    return np.concatenate([r.T, (-r.T @ w2c[:, 3])[:, None]], 1).astype(np.float32)


@pytest.fixture(scope="module")
def volumes():
    """The JAX volume and the port's after fusing the three frames (the
    port's in 4-slab chunks), and the frames."""
    rs = np.random.RandomState(0)
    frames = [render(p, rs) for p in POSES]
    jvol = jfusion.create_volume(G, C, ORIGIN, VOXEL)
    tvol = fusion.create_volume(G, C, ORIGIN, VOXEL)
    for field in ("tsdf", "weight", "prob", "origin", "voxel_size"):
        np.testing.assert_array_equal(getattr(tvol, field).numpy(), np.asarray(getattr(jvol, field)))
    kt = torch.from_numpy(K)
    for (depth, prob), w2c in zip(frames, POSES):
        jvol = jfusion.fuse_frame(jvol, jnp.asarray(depth), jnp.asarray(prob), jnp.asarray(K),
                                  jnp.asarray(w2c))
        fusion.fuse_frame(tvol, torch.from_numpy(depth), torch.from_numpy(prob), kt,
                          torch.from_numpy(w2c), slab_bytes=4 * G * G * C * 4)
    return jvol, tvol, frames


def test_fuse_frame_matches_jax(volumes):
    jvol, tvol, frames = volumes
    for field in ("tsdf", "weight", "prob"):
        np.testing.assert_allclose(getattr(tvol, field).numpy(), np.asarray(getattr(jvol, field)),
                                   rtol=0, atol=1e-5, err_msg=field)
    assert (tvol.weight.numpy() == 3).sum() > 200 and (np.abs(tvol.tsdf.numpy()) < 0.5).sum() > 100
    # one slab gives the same volume as several
    one = fusion.create_volume(G, C, ORIGIN, VOXEL)
    for (depth, prob), w2c in zip(frames, POSES):
        fusion.fuse_frame(one, torch.from_numpy(depth), torch.from_numpy(prob),
                          torch.from_numpy(K), torch.from_numpy(w2c))
    for field in ("tsdf", "weight", "prob"):
        assert torch.equal(getattr(one, field), getattr(tvol, field)), field


def test_raycast_matches_jax(volumes):
    jvol, tvol, _ = volumes
    for w2c in POSES:
        want = jfusion.raycast(jvol, jnp.asarray(K), jnp.asarray(c2w(w2c)), height=H, width=W,
                               near=0.3, far=2.0, num_steps=96)
        got = fusion.raycast(tvol, torch.from_numpy(K), torch.from_numpy(c2w(w2c)), height=H,
                             width=W, near=0.3, far=2.0, num_steps=96)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert (got[0].numpy() > 0).mean() > 0.3 and set(np.unique(got[2].numpy())) >= {1, 2}


def test_track_camera_matches_jax(volumes):
    jvol, tvol, frames = volumes
    model_depth = jfusion.raycast(jvol, jnp.asarray(K), jnp.asarray(c2w(POSES[1])), height=H,
                                  width=W, near=0.3, far=2.0, num_steps=96)[0]
    eye = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    want = jfusion.track_camera(jnp.asarray(frames[2][0]), model_depth, jnp.asarray(K),
                                jnp.asarray(eye), num_iters=6)
    got = fusion.track_camera(torch.from_numpy(frames[2][0]),
                              torch.from_numpy(np.array(model_depth)), torch.from_numpy(K),
                              torch.from_numpy(eye), num_iters=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert np.abs(np.asarray(want) - eye).max() > 1e-3  # the camera moved


def test_extract_surface_matches_jax(volumes):
    jvol, tvol, _ = volumes
    want = jfusion.extract_surface(jvol, threshold=0.3, max_points=512)
    got = fusion.extract_surface(tvol, threshold=0.3, max_points=512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[2].sum()) < 512  # ties at −inf fill the rest


@pytest.mark.parametrize("chunk_cells", [1 << 20, 3 * (G - 1) ** 2], ids=["one_chunk", "chunks"])
def test_extract_mesh_and_ply_match_jax(volumes, chunk_cells, tmp_path):
    jvol, tvol, _ = volumes
    want = jfusion.extract_mesh(jvol, max_triangles=1024)
    got = fusion.extract_mesh(tvol, max_triangles=1024, chunk_cells=chunk_cells)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) > 100
    n_want = jfusion.save_mesh_ply(str(tmp_path / "jax.ply"), *want)
    n_got = fusion.save_mesh_ply(str(tmp_path / "port.ply"), *got)
    assert n_got == n_want == int(got[2].sum())

    def read_ply(path):
        lines = path.read_text().splitlines()
        end = lines.index("end_header")
        n_v = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
        verts = np.array([[float(v) for v in x.split()] for x in lines[end + 1: end + 1 + n_v]])
        return lines[:end], verts, lines[end + 1 + n_v:]

    (gh, gv, gf), (wh, wv, wf) = read_ply(tmp_path / "port.ply"), read_ply(tmp_path / "jax.ply")
    assert gh == wh and gf == wf and len(gv) == len(wv) > 50
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
