"""Port parity: se3, the quaternion helpers of the evaluation and ICP
paths, every pose error, the AUC and its thresholds, and the normal maps,
each against the JAX package's function on the same numpy inputs.

Tolerances are stated per assertion: fp32 results agree to a few ulps
(rtol 1e-5) where both packages run the same formula; the AUC's
thresholds bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops import normals as jnormals
from posecnn_tpu.utils import pose_error as jpe
from posecnn_tpu.utils import quaternion as jq
from posecnn_tpu.utils import se3 as jse3
from posecnn_torch.ops import normals as tnormals
from posecnn_torch.utils import pose_error as tpe
from posecnn_torch.utils import quaternion as tq
from posecnn_torch.utils import se3 as tse3

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def random_quat(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def random_rt(rng, n):
    r = np.array(jq.quat_to_mat(jnp.asarray(random_quat(rng, n))))
    t = rng.randn(n, 3, 1).astype(np.float32)
    return np.concatenate([r, t], -1)


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               **(tol or TOL))


def test_se3_matches_jax(rng):
    a, b = random_rt(rng, 6), random_rt(rng, 6)
    pts = rng.randn(6, 40, 3).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    close(tse3.se3_mul(ta, tb), jse3.se3_mul(jnp.asarray(a), jnp.asarray(b)))
    close(tse3.se3_inverse(ta), jse3.se3_inverse(jnp.asarray(a)))
    close(tse3.transform_points(ta, torch.from_numpy(pts)),
          jse3.transform_points(jnp.asarray(a), jnp.asarray(pts)))
    # the composition with the inverse is the identity (atol 1e-5)
    ident = tse3.se3_mul(ta, tse3.se3_inverse(ta))
    expect = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], -1), (6, 1, 1))
    close(ident, expect, atol=1e-5)


def test_quaternion_additions_match_jax(rng):
    qa, qb = random_quat(rng, 16), random_quat(rng, 16)
    close(tq.quat_mul(torch.from_numpy(qa), torch.from_numpy(qb)),
          jq.quat_mul(jnp.asarray(qa), jnp.asarray(qb)))
    axis = rng.randn(16, 3).astype(np.float32)
    angle = rng.uniform(-3, 3, 16).astype(np.float32)
    close(tq.axis_angle_to_quat(torch.from_numpy(axis), torch.from_numpy(angle)),
          jq.axis_angle_to_quat(jnp.asarray(axis), jnp.asarray(angle)))
    ra = np.array(jq.quat_to_mat(jnp.asarray(qa)))
    rb = np.array(jq.quat_to_mat(jnp.asarray(qb)))
    # arccos near ±1 magnifies a last-bit difference in the trace: 1e-3 degrees
    close(tq.rotation_geodesic_deg(torch.from_numpy(ra), torch.from_numpy(rb)),
          jq.rotation_geodesic_deg(jnp.asarray(ra), jnp.asarray(rb)), rtol=0, atol=1e-3)


def test_mat_to_quat_matches_jax_and_breaks_ties_to_the_first(rng):
    q = random_quat(rng, 64)
    m = np.array(jq.quat_to_mat(jnp.asarray(q)))
    # a 180° turn about x: qw² = 0 ties qy² and qz² (first maximum is qx²);
    # the identity and a turn about z tie nothing; diag(-1, -1, 1) ties w, x, y
    specials = np.stack([np.diag([1.0, -1.0, -1.0]), np.eye(3), np.diag([-1.0, -1.0, 1.0]),
                         np.diag([-1.0, 1.0, -1.0])]).astype(np.float32)
    m = np.concatenate([m, specials])
    got = tq.mat_to_quat(torch.from_numpy(m))
    close(got, jq.mat_to_quat(jnp.asarray(m)))
    # round trip with w ≥ 0 (atol 1e-5)
    want = q * np.where(q[:, :1] < 0, -1.0, 1.0)
    close(got[:64], want, atol=1e-5)


def test_pose_errors_match_jax(rng):
    n, p = 5, 200
    q_est, q_gt = random_quat(rng, n), random_quat(rng, n)
    t_est = rng.randn(n, 3).astype(np.float32) * 0.05 + [0, 0, 1]
    t_gt = t_est + rng.randn(n, 3).astype(np.float32) * 0.02
    pts = (rng.randn(n, p, 3) * 0.05).astype(np.float32)
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    r_est, r_gt = (np.array(jq.quat_to_mat(jnp.asarray(x))) for x in (q_est, q_gt))
    j = [jnp.asarray(x) for x in (r_est, t_est.astype(np.float32), r_gt, t_gt.astype(np.float32),
                                  pts)]
    t = [torch.from_numpy(np.asarray(x, np.float32)) for x in (r_est, t_est, r_gt, t_gt, pts)]
    close(tpe.add_error(*t), jpe.add_error(*j))
    close(tpe.te(t[1], t[3]), jpe.te(j[1], j[3]))
    close(tpe.reproj_error(torch.from_numpy(k).expand(n, 3, 3), *t),
          jpe.reproj_error(jnp.asarray(k), *j), rtol=1e-5, atol=1e-4)
    close(tpe.re(t[0], t[2]), jpe.re(j[0], j[2]), rtol=0, atol=1e-3)
    # ADD-S: the Gram matrix cancels ~1e-7 of d², so d agrees to 1e-5 m
    close(tpe.adi_error(*t), jpe.adi_error(*j), rtol=0, atol=1e-5)


def test_add_adi_errors_golden(rng):
    """tests/test_utils_math.py's golden values, on the port."""
    pts = torch.from_numpy(rng.randn(200, 3).astype(np.float32))
    r = torch.eye(3)
    t1, t2 = torch.zeros(3), torch.tensor([0.05, 0.0, 0.0])
    np.testing.assert_allclose(float(tpe.add_error(r, t2, r, t1, pts)), 0.05, atol=1e-6)
    # identical poses: the Gram cancellation leaves ≤ 5e-4 m
    np.testing.assert_allclose(float(tpe.adi_error(r, t1, r, t1, pts)), 0.0, atol=5e-4)
    q = tq.quat_to_mat(tq.quat_normalize(torch.from_numpy(rng.randn(4).astype(np.float32))))
    assert float(tpe.adi_error(q, t2, r, t1, pts)) <= float(tpe.add_error(q, t2, r, t1, pts)) + 1e-6
    ang = np.pi / 6
    rz = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                      dtype=torch.float32)
    np.testing.assert_allclose(float(tpe.re(rz, torch.eye(3))), 30.0, atol=1e-4)


@pytest.mark.parametrize("max_threshold", [0.1, 0.05, 0.3])
def test_auc_thresholds_equal_jnp_linspace_bit_for_bit(max_threshold):
    got = tpe.auc_thresholds(max_threshold, 1000).numpy()
    want = np.asarray(jnp.linspace(0.0, max_threshold, 1000))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the trap it avoids: torch.linspace rounds some of them differently
    assert (torch.linspace(0.0, max_threshold, 1000).numpy() != want).any()


def test_auc_of_errors_matches_jax(rng):
    want_thr = np.asarray(jnp.linspace(0.0, 0.1, 1000))
    # errors sitting exactly on thresholds, infinite misses and the rest
    errs = np.concatenate([want_thr[rng.randint(0, 1000, 40)], [np.inf] * 5,
                           rng.uniform(0, 0.15, 60)]).astype(np.float32)
    got = float(tpe.auc_of_errors(torch.from_numpy(errs)))
    # same counts at every threshold; trapezoid's fp32 sum order: 1e-6
    np.testing.assert_allclose(got, float(jpe.auc_of_errors(jnp.asarray(errs))), rtol=0,
                               atol=1e-6)
    golden = float(tpe.auc_of_errors(torch.tensor([0.0, 0.05, 0.2])))
    assert 0.4 < golden < 0.6


def test_normals_match_jax_including_the_borders(rng):
    h, w = 24, 32
    depth = (1.0 + 0.2 * rng.rand(h, w)).astype(np.float32)
    depth[5:9, 10:14] = 0.0  # invalid pixels
    fx, fy, px, py = 180.0, 170.0, 15.5, 12.0
    got_p = tnormals.backproject_depth(torch.from_numpy(depth), fx, fy, px, py)
    want_p = np.asarray(jnormals.backproject_depth(jnp.asarray(depth), fx, fy, px, py))
    close(got_p, want_p)
    got = tnormals.depth_to_normals(torch.from_numpy(depth), fx, fy, px, py).numpy()
    want = np.asarray(jnormals.depth_to_normals(jnp.asarray(depth), fx, fy, px, py))
    # one-sided differences at the first and last rows and columns
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[[0, -1]], want[[0, -1]], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # a flat wall at z = 1 faces the camera (n_z = −1 within 1e-3)
    wall = tnormals.depth_to_normals(torch.ones(40, 40), 180.0, 180.0, 20.0, 20.0).numpy()
    np.testing.assert_allclose(wall[5:-5, 5:-5, 2], -1.0, atol=1e-3)
