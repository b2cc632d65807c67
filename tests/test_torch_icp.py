"""Port parity: ICP (posecnn_torch.refine.icp) against the JAX refiner.

The cases of tests/test_icp.py: the normal map of a plane, the
back-projection, and three refinements of a splat-rendered cuboid (a
translation offset, a small rotation, a 25° rotation with and without the
rotation-hypothesis sweep), plus a batch holding a detection with a NaN
translation. Each refinement runs through `posecnn_tpu.refine.icp.
refine_pose_icp` and through a replica of its per-hypothesis loop built
from the JAX module's own `_associate`, `_gn_step` and `_so3_exp`, which
exposes each hypothesis's final pose. The port is held to JAX:

- per hypothesis, the final [R|t] within ATOL_RT, and the score within
  1/P (one model point across the inlier gate: a last-bit difference in a
  GN step can move one, and then the next step differs by that point);
- the refined pose within ATOL_RT where JAX's winning margin exceeds 2/P,
  so that both must pick the same hypothesis;
- then the case's own assertion, on the port.

On rendered multi-object scenes (`cli/test_icp`'s drive) a hypothesis
that starts with few valid points is chaotic: a last-bit difference
grows over the iterations (one at 3-12 valid points ends at 0 points in
JAX and 54 in the port, while every single step agrees to 1e-6). There
the rule is the SCENE rule, which `chip_smoke.py` phase 9 holds the card
to against the CPU: after one iteration every hypothesis within
ATOL_STEP; after eight, at least SHARE of the hypotheses within ATOL_RT
and 1/P, and every refined pose within ATOL_RT where the winning margin
exceeds 2/P.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops.normals import backproject_depth, depth_to_normals
from posecnn_tpu.refine import icp as jicp
from posecnn_tpu.utils.quaternion import axis_angle_to_quat, mat_to_quat, quat_mul, quat_to_mat
from posecnn_torch.cli import test_icp
from posecnn_torch.ops import normals as tnormals
from posecnn_torch.refine import icp as ticp

torch.set_num_threads(1)
H, W = 120, 160
FX = FY = 180.0
K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)
# per-hypothesis pose tolerance, rotation entries and metres
ATOL_RT = 2e-3
# the scene rule: one iteration, and the share of converged hypotheses
ATOL_STEP, SHARE = 1e-4, 0.8
BASE_Q = np.array([np.cos(0.3), 0.25, 0.25, 0.05], np.float32)
BASE_Q /= np.linalg.norm(BASE_Q)


def make_model(rng, n=1800):
    half = np.array([0.06, 0.04, 0.03])
    pts = []
    for axis in range(3):
        for sign in (-1, 1):
            q = rng.uniform(-1, 1, (n // 6, 3)) * half
            q[:, axis] = sign * half[axis]
            pts.append(q)
    return np.concatenate(pts).astype(np.float32)


def render_depth(pts, q, t):
    r = np.asarray(quat_to_mat(jnp.asarray(q)))
    p = pts @ r.T + t
    depth = np.full((H, W), np.inf, np.float32)
    z = p[:, 2]
    u = np.round(FX * p[:, 0] / z + W / 2).astype(int)
    v = np.round(FY * p[:, 1] / z + H / 2).astype(int)
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            np.minimum.at(depth, (vv[ok], uu[ok]), z[ok])
    depth[np.isinf(depth)] = 0
    return depth


def pose_errors(q_est, t_est, q_gt, t_gt):
    r_est = np.asarray(quat_to_mat(jnp.asarray(np.asarray(q_est))))
    r_gt = np.asarray(quat_to_mat(jnp.asarray(q_gt)))
    cos = np.clip(0.5 * (np.trace(r_est @ r_gt.T) - 1), -1, 1)
    return np.degrees(np.arccos(cos)), np.linalg.norm(np.asarray(t_est) - t_gt)


@partial(jax.jit, static_argnames=("num_iters", "num_hypotheses", "rot_perturb"))
def jax_hypotheses(quat, trans, model_pts, depth, mask, k, *, num_iters, num_hypotheses=8,
                   rot_perturb=0.0):
    """`jicp.refine_pose_icp`'s hypothesis loop (icp.py:211-270) with its
    defaults, returning every hypothesis's final pose and score."""
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    point_map = backproject_depth(depth, fx, fy, px, py)
    normal_map = depth_to_normals(depth, fx, fy, px, py)
    mvalid = mask & (depth > 1e-4)
    mean_obs_z = jnp.sum(jnp.where(mvalid, depth, 0.0)) / jnp.maximum(jnp.sum(mvalid), 1)
    est_z = mean_obs_z + 0.5 * (jnp.max(model_pts[:, 2]) - jnp.min(model_pts[:, 2]))
    t0 = trans * jnp.where(trans[2] > 1e-4, est_z / trans[2], 1.0)
    t0 = jnp.where(jnp.sum(mvalid) > 10, t0, trans)
    r0 = quat_to_mat(quat)
    offsets = jnp.linspace(-0.04, 0.04, num_hypotheses)
    ws = jnp.zeros((1, 3))
    if rot_perturb > 0.0:
        eye3 = jnp.eye(3, dtype=jnp.float32)
        ws = jnp.concatenate([ws, rot_perturb * eye3, -rot_perturb * eye3], axis=0)
    dz_grid = jnp.repeat(offsets, ws.shape[0])
    w_grid = jnp.tile(ws, (num_hypotheses, 1))

    def run_one(dz, w):
        scale = (t0[2] + dz) / jnp.maximum(t0[2], 1e-6)
        rt = jnp.concatenate([jicp._so3_exp(w) @ r0, (t0 * scale)[:, None]], axis=1)

        def body(rt, gate):
            obs_p, obs_n, valid = jicp._associate(rt, model_pts, point_map, normal_map, depth,
                                                  fx, fy, px, py, gate)
            rt_new = jicp._gn_step(rt, model_pts, obs_p, obs_n, valid, 1e-2)
            return jnp.where(jnp.all(jnp.isfinite(rt_new)), rt_new, rt), None

        rt, _ = jax.lax.scan(body, rt, jnp.full((num_iters,), 0.02))
        _, _, valid = jicp._associate(rt, model_pts, point_map, normal_map, depth, fx, fy, px,
                                      py, 0.01)
        return rt, jnp.mean(valid.astype(jnp.float32))

    rts, scores = jax.vmap(run_one)(dz_grid, w_grid)
    return rts, scores, scores - 1e-5 * jnp.linalg.norm(w_grid, axis=1)


jax_refine = jax.jit(jicp.refine_pose_icp,
                     static_argnames=("num_iters", "num_hypotheses", "rot_perturb"))


def refine_both(q0, t0, pts, depth, mask, **kw):
    """The JAX result, its per-hypothesis replica and the port's result on
    the same inputs; the port held to JAX as the module doc says."""
    args = [jnp.asarray(x) for x in (q0, t0, pts, depth, mask, K)]
    want = jax_refine(*args, **kw)
    rts, scores, sel = (np.asarray(x) for x in jax_hypotheses(*args, **kw))
    np.testing.assert_array_equal(scores, np.asarray(want.hypothesis_scores))
    targs = [torch.from_numpy(np.array(x)) for x in (q0, t0, pts, depth, mask, K)]
    got = ticp.refine_pose_icp(*targs, **kw)
    p = pts.shape[0]
    np.testing.assert_allclose(got.hypothesis_scores.numpy(), scores, rtol=0, atol=1.0 / p + 1e-6)
    np.testing.assert_allclose(got.hypothesis_rts.numpy(), rts, rtol=0, atol=ATOL_RT)
    top2 = np.sort(sel)[-2:] if sel.size > 1 else np.array([-np.inf, sel[0]])
    if top2[1] - top2[0] > 2.0 / p:
        np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), rtol=0,
                                   atol=ATOL_RT)
        np.testing.assert_allclose(
            got.quat.numpy() * np.sign(got.quat.numpy() @ np.asarray(want.quat)),
            np.asarray(want.quat), rtol=0, atol=ATOL_RT)
        assert float(got.score) == pytest.approx(float(want.score), abs=1.0 / p + 1e-6)
    return got, want


def test_normals_of_plane():
    n = tnormals.depth_to_normals(torch.ones(40, 40), FX, FY, 20.0, 20.0).numpy()
    want = np.asarray(depth_to_normals(jnp.ones((40, 40)), FX, FY, 20.0, 20.0))
    np.testing.assert_allclose(n, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(n[5:-5, 5:-5, 2], -1.0, atol=1e-3)


def test_backproject_roundtrip():
    pts = tnormals.backproject_depth(torch.full((10, 10), 2.0), FX, FY, 5.0, 5.0).numpy()
    want = np.asarray(backproject_depth(jnp.full((10, 10), 2.0), FX, FY, 5.0, 5.0))
    np.testing.assert_allclose(pts, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(pts[5, 5], [0, 0, 2.0], atol=1e-6)


def test_icp_recovers_translation_offset(rng):
    pts = make_model(rng)
    t_gt = np.array([0.05, -0.02, 0.9], np.float32)
    depth = render_depth(pts, BASE_Q, t_gt)
    t0 = t_gt + np.array([0.015, 0.01, 0.03], np.float32)
    got, _ = refine_both(BASE_Q, t0, pts, depth, depth > 0, num_iters=16)
    _, tr0 = pose_errors(BASE_Q, t0, BASE_Q, t_gt)
    _, tr1 = pose_errors(got.quat.numpy(), got.trans.numpy(), BASE_Q, t_gt)
    assert np.isfinite(tr1) and tr1 < 0.5 * tr0 and tr1 < 0.015, (tr0, tr1)
    assert float(got.score) > 0.3


def test_icp_recovers_small_rotation(rng):
    pts = make_model(rng)
    t_gt = np.array([0.0, 0.0, 0.8], np.float32)
    depth = render_depth(pts, BASE_Q, t_gt)
    ang = np.radians(8.0)
    dq = np.array([np.cos(ang / 2), np.sin(ang / 2), 0, 0], np.float32)
    q0 = np.asarray(quat_mul(jnp.asarray(dq), jnp.asarray(BASE_Q)))
    got, _ = refine_both(q0, t_gt, pts, depth, depth > 0, num_iters=16)
    rot0, _ = pose_errors(q0, t_gt, BASE_Q, t_gt)
    rot1, tr1 = pose_errors(got.quat.numpy(), got.trans.numpy(), BASE_Q, t_gt)
    assert rot1 < 0.6 * rot0 and tr1 < 0.02, (rot0, rot1, tr1)


def test_icp_rotation_hypotheses_escape_gn_basin(rng):
    pts = make_model(rng)
    t_gt = np.array([0.03, -0.01, 0.85], np.float32)
    depth = render_depth(pts, BASE_Q, t_gt)
    dq = np.asarray(axis_angle_to_quat(jnp.asarray(np.array([0.5, 0.8, 0.2], np.float32)),
                                       jnp.asarray(np.float32(np.radians(25.0)))))
    q0 = np.asarray(quat_mul(jnp.asarray(dq), jnp.asarray(BASE_Q)))
    t0 = t_gt + np.array([0.01, -0.005, 0.02], np.float32)
    errs = {}
    for rp in (0.0, 0.25):
        got, _ = refine_both(q0, t0, pts, depth, depth > 0, num_iters=12, rot_perturb=rp)
        errs[rp] = pose_errors(got.quat.numpy(), got.trans.numpy(), BASE_Q, t_gt)
    assert errs[0.25][0] < errs[0.0][0] - 1.0
    assert errs[0.25][0] < 8.0 and errs[0.25][1] < 0.02


def test_icp_batch_with_a_nan_translation_matches_jax_per_object(rng):
    """A NaN translation (a degenerate box fit) beside a good detection in
    one batch: the NaN row returns what JAX returns (its initial rotation,
    a NaN translation, score 0) and leaves the other row as JAX refines it."""
    pts = make_model(rng)
    t_gt = np.array([0.02, 0.01, 0.8], np.float32)
    depth = render_depth(pts, BASE_Q, t_gt)
    mask = depth > 0
    t0 = np.stack([t_gt + np.array([0.01, 0.0, 0.02], np.float32), np.full(3, np.nan, np.float32)])
    q0 = np.stack([BASE_Q, BASE_Q])
    got = ticp.icp_refine_batch(*(torch.from_numpy(np.array(x)) for x in (
        q0, t0, np.stack([pts, pts]), depth, np.stack([mask, mask]), K)), num_iters=16)
    for i in range(2):
        want = jax_refine(*(jnp.asarray(x) for x in (q0[i], t0[i], pts, depth, mask, K)),
                          num_iters=16)
        np.testing.assert_allclose(got.hypothesis_scores[i].numpy(),
                                   np.asarray(want.hypothesis_scores), rtol=0,
                                   atol=1 / pts.shape[0] + 1e-6)
        np.testing.assert_allclose(got.quat[i].numpy(), np.asarray(want.quat), rtol=0, atol=ATOL_RT)
        np.testing.assert_allclose(got.trans[i].numpy(), np.asarray(want.trans), rtol=0,
                                   atol=ATOL_RT, equal_nan=True)
    assert np.isnan(got.trans[1].numpy()).all() and float(got.score[1]) == 0.0
    np.testing.assert_allclose(got.quat[1].numpy(),
                               np.asarray(mat_to_quat(quat_to_mat(jnp.asarray(BASE_Q)))),
                               rtol=0, atol=1e-6)
    assert np.isfinite(got.trans[0].numpy()).all() and float(got.score[0]) > 0.3


def test_icp_on_rendered_scenes_holds_the_scene_rule():
    """test_icp's drive at 240×320 (22 classes, 2 scenes, rotation sweep
    0.25): every object's hypotheses against the JAX replica."""
    args = test_icp.make_parser().parse_args(
        ["--device", "cpu", "--set", "train.num_classes=22", "train.syn_height=240",
         "train.syn_width=320"])
    scenes = test_icp.perturbed_scenes(test_icp.load_config(args), 2, 8.0, 0.03)
    for iters in (1, 8):
        close, rows = 0, 0
        for sc in scenes:
            got = test_icp.refine_scene(sc, torch.device("cpu"), iters, 0.25)
            p = sc["model_pts"].shape[1]
            for i in range(len(sc["gt"])):
                rts, scores, sel = (np.asarray(x) for x in jax_hypotheses(
                    *(jnp.asarray(sc[k][i]) for k in ("quats", "transs", "model_pts")),
                    jnp.asarray(sc["depth"]), jnp.asarray(sc["masks"][i]), jnp.asarray(sc["k"]),
                    num_iters=iters, rot_perturb=0.25))
                d = np.abs(got.hypothesis_rts[i].numpy() - rts).reshape(len(rts), -1).max(1)
                ds = np.abs(got.hypothesis_scores[i].numpy() - scores)
                if iters == 1:
                    assert d.max() <= ATOL_STEP, (i, d.max())
                close += int(((d <= ATOL_RT) & (ds <= 1.0 / p + 1e-6)).sum())
                rows += len(d)
                top2 = np.sort(sel)[-2:]
                if top2[1] - top2[0] > 2.0 / p:
                    np.testing.assert_allclose(got.hypothesis_rts[i, int(np.argmax(sel))].numpy(),
                                               rts[int(np.argmax(sel))], rtol=0, atol=ATOL_RT)
                    np.testing.assert_allclose(got.trans[i].numpy(), rts[int(np.argmax(sel))][:, 3],
                                               rtol=0, atol=ATOL_RT)
        assert close >= SHARE * rows, (iters, close, rows)
