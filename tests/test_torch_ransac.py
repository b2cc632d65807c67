"""Port parity: RANSAC (posecnn_torch.refine.ransac) against the JAX
estimators, on the cases of tests/test_ransac.py.

`jax.random` cannot be reproduced in torch, so the hypotheses' indices are
drawn here with JAX's own draw (as `estimate_center` and
`estimate_pose_3d` draw them from their key) and fed to the port's
deterministic bodies; each result is held to the JAX estimator's on the
same key. Tolerances: centres within 1e-3 px, rotations and translations
within 1e-5, inlier counts equal.

Kabsch's SVD signs may differ between LAPACK builds; R does not where the
singular values are distinct. So hypothesis by hypothesis, `_kabsch` is
held to JAX's on the non-degenerate triples only (three distinct points,
singular values apart by more than 1e-3 of the largest), and on the
all-invalid input only finiteness and the zero inlier count are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from posecnn_tpu.refine import ransac as jr
from posecnn_tpu.utils.quaternion import quat_to_mat
from posecnn_torch.refine import ransac as tr

torch.set_num_threads(1)


def jax_pairs(valid, key, num_hypotheses):
    """The (ia, ib) pixel indices `jr.estimate_center` draws from `key`."""
    r1, r2 = jax.random.split(key)
    order = jnp.argsort(~valid, stable=True)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    ia = jnp.take(order, jax.random.randint(r1, (num_hypotheses,), 0, n_valid))
    ib = jnp.take(order, jax.random.randint(r2, (num_hypotheses,), 0, n_valid))
    return torch.from_numpy(np.stack([np.array(ia), np.array(ib)], 1)).long()


def jax_triples(valid, key, num_hypotheses):
    """The (Hyp, 3) indices `jr.estimate_pose_3d` draws from `key`."""
    order = jnp.argsort(~valid, stable=True)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    idx = jax.vmap(lambda k: jnp.take(order, jax.random.randint(k, (3,), 0, n_valid)))(
        jax.random.split(key, num_hypotheses))
    return torch.from_numpy(np.array(idx)).long()


def centers_both(px, d, valid, key, num_hypotheses):
    want = jr.estimate_center(jnp.asarray(px, jnp.float32), jnp.asarray(d, jnp.float32),
                              jnp.asarray(valid), key, num_hypotheses=num_hypotheses)
    got = tr.estimate_center(torch.from_numpy(px.astype(np.float32)),
                             torch.from_numpy(d.astype(np.float32)), torch.from_numpy(valid),
                             jax_pairs(jnp.asarray(valid), key, num_hypotheses))
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), rtol=0, atol=1e-3)
    assert float(got.inliers) == float(want.inliers)
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-6)
    return got


def poses_both(obj, cam, valid, key, num_hypotheses, **kw):
    want = jr.estimate_pose_3d(jnp.asarray(obj), jnp.asarray(cam), jnp.asarray(valid), key,
                               num_hypotheses=num_hypotheses, **kw)
    triples = jax_triples(jnp.asarray(valid), key, num_hypotheses)
    got = tr.estimate_pose_3d(torch.from_numpy(obj), torch.from_numpy(cam),
                              torch.from_numpy(valid), triples, **kw)
    assert float(got.inliers) == float(want.inliers)
    return got, want, triples


def kabsch_per_hypothesis(obj, cam, valid, triples):
    """`_kabsch` of every non-degenerate triple against JAX's, R and t
    within 1e-4; returns how many were compared."""
    compared = 0
    for idx in triples.numpy():
        w = valid[idx].astype(np.float32)
        cov = (obj[idx] - obj[idx].mean(0)).T @ (cam[idx] - cam[idx].mean(0))
        sv = np.linalg.svd(cov, compute_uv=False)
        if len(set(idx)) < 3 or w.sum() < 3 or np.min(-np.diff(sv)) <= 1e-3 * sv[0]:
            continue
        r_j, t_j = jr._kabsch(jnp.asarray(obj[idx]), jnp.asarray(cam[idx]), jnp.asarray(w))
        r_t, t_t = tr._kabsch(torch.from_numpy(obj[idx]), torch.from_numpy(cam[idx]),
                              torch.from_numpy(w))
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-4)
        compared += 1
    return compared


def test_estimate_center_with_outliers(rng):
    n = 256
    true_c = np.array([80.0, 60.0])
    px = rng.rand(n, 2) * np.array([160, 120])
    d = true_c - px
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bad = rng.rand(n // 4, 2) - 0.5
    d[: n // 4] = bad / np.linalg.norm(bad, axis=1, keepdims=True)
    got = centers_both(px, d, np.ones(n, bool), jax.random.PRNGKey(0), 128)
    np.testing.assert_allclose(got.center.numpy(), true_c, atol=2.0)
    assert float(got.score) > 0.5


def test_estimate_pose_3d_with_outliers(rng):
    n = 300
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    r_true = np.asarray(quat_to_mat(jnp.asarray(q, jnp.float32)))
    t_true = np.array([0.1, -0.05, 0.9], np.float32)
    obj = (rng.rand(n, 3).astype(np.float32) - 0.5) * 0.2
    cam = obj @ r_true.T + t_true + rng.randn(n, 3).astype(np.float32) * 0.002
    cam[: n * 3 // 10] += rng.rand(n * 3 // 10, 3) * 0.5
    cam = cam.astype(np.float32)
    valid = np.ones(n, bool)
    got, want, triples = poses_both(obj, cam, valid, jax.random.PRNGKey(1), 256,
                                    inlier_threshold=0.01)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0,
                               atol=1e-5)
    assert kabsch_per_hypothesis(obj, cam, valid, triples) > 200
    r_err = np.degrees(np.arccos(np.clip(0.5 * (np.trace(got.rotation.numpy() @ r_true.T) - 1),
                                         -1, 1)))
    assert r_err < 3.0 and np.linalg.norm(got.translation.numpy() - t_true) < 0.01
    assert float(got.score) > 0.5


def test_estimate_pose_degenerate_all_invalid():
    n = 50
    zeros = np.zeros((n, 3), np.float32)
    got, _, _ = poses_both(zeros, zeros, np.zeros(n, bool), jax.random.PRNGKey(0), 32)
    assert np.isfinite(got.rotation.numpy()).all() and float(got.inliers) == 0


def test_estimate_center_with_padding(rng):
    n, nv = 500, 50
    true_c = np.array([80.0, 60.0])
    px = rng.rand(n, 2) * np.array([160, 120])
    d = true_c - px
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = np.zeros(n, bool)
    valid[:nv] = True
    d[nv:] = 0
    got = centers_both(px, d, valid, jax.random.PRNGKey(3), 64)
    np.testing.assert_allclose(got.center.numpy(), true_c, atol=2.0)
    assert float(got.score) > 0.5
    # the port's own draw takes valid entries only, too
    pairs = tr.draw_hypotheses(torch.from_numpy(valid), 64, 2, torch.Generator().manual_seed(0))
    assert bool(torch.from_numpy(valid)[pairs].all())


def test_estimate_pose_3d_with_padding(rng):
    n, nv = 400, 60
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    r_true = np.asarray(quat_to_mat(jnp.asarray(q, jnp.float32)))
    t_true = np.array([0.05, 0.0, 0.8], np.float32)
    obj = (rng.rand(n, 3).astype(np.float32) - 0.5) * 0.2
    cam = (obj @ r_true.T + t_true).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:nv] = True
    cam[nv:] = 99.0
    got, want, _ = poses_both(obj, cam, valid, jax.random.PRNGKey(5), 128, inlier_threshold=0.01)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0,
                               atol=1e-5)
    assert np.linalg.norm(got.translation.numpy() - t_true) < 0.01
    assert float(got.score) > 0.9
