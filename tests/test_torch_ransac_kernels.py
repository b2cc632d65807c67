"""RANSAC's two pose kernels (`refine/ransac.pose_hypotheses` and
`pose_refine`, `csrc/kabsch.cu`) and their plain versions.

On the CPU, at tiny sizes against the JAX package:
- `pose_hypotheses_plain`'s fits equal `jax.vmap(jr._kabsch)` on each
  triple within 1e-5 where the triple holds three distinct valid points
  whose covariance's singular values stand apart by 1e-3 of the largest
  (the gap rule of tests/test_torch_ransac.py); its scores equal a numpy
  fp64 count of each fit's inliers, but for points whose fp64 error lies
  within 1e-5 of the threshold (relative), and -1 where a triple holds an
  invalid entry.
- `pose_refine_plain` on those hypotheses equals JAX's jitted
  `estimate_pose_3d` fed the same triples (its draw replaced by a lookup
  of each hypothesis' key): all entries invalid, N = 3, one hypothesis,
  triples with invalid entries among valid ones, and two motions that tie
  the best score (the first index wins). R and t within 1e-5, the inliers
  equal (tests/test_torch_ransac.py's bars).
- `estimate_pose_3d` on the CPU is the two plain steps, bit for bit, and
  the wrappers run the plain versions on CPU tensors.

On the card (`cuda`-marked; `python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_ransac_kernels.py`), each
kernel against its plain version (the SVD for the rotations) by
`chip_smoke.pose_hypotheses_vs_plain` and `pose_refine_vs_plain` at N in
{3, 64, 4096, 4097, 65536} and Hyp in {1, 16, 256, 1000}, with invalid
entries, all entries invalid, no entry, and tied scores; one launch a call
each, counted by the wrapper and on the device. JAX is imported inside the
tests that use it: the card's machine has none.
"""

import types

import numpy as np
import pytest
import torch

from posecnn_torch.ops import _cuda
from posecnn_torch.refine import ransac
from posecnn_torch.utils.quaternion import quat_to_mat_np

torch.set_num_threads(1)
THRESHOLD = 0.01
GAP, TOL, BAND = 1e-3, 1e-5, 1e-5


def rotation(rng):
    q = rng.randn(4)
    return quat_to_mat_np(q / np.linalg.norm(q)).astype(np.float32)


def scene(rng, n, outliers=0.3, invalid=0.0, noise=0.002):
    """n correspondences of one rigid pose with noise, a share of gross
    outliers and of invalid entries: (obj, cam, valid) as numpy."""
    obj = ((rng.rand(n, 3) - 0.5) * 0.2).astype(np.float32)
    cam = obj @ rotation(rng).T + np.array([0.1, -0.05, 0.9], np.float32)
    cam = cam + rng.randn(n, 3).astype(np.float32) * noise
    bad = int(n * outliers)
    cam[:bad] += rng.rand(bad, 3).astype(np.float32) * 0.5
    valid = rng.rand(n) >= invalid
    return obj, cam.astype(np.float32), valid


def two_motions(rng, n):
    """Two halves of the points under two rigid motions 1 m apart, no
    noise: every hypothesis inside one half scores n / 2 (no point of the
    other half comes within reach)."""
    obj = ((rng.rand(n, 3) - 0.5) * 0.2).astype(np.float32)
    half = n // 2
    cam = np.concatenate([obj[:half] @ rotation(rng).T + [0.1, 0.0, 0.9],
                          obj[half:] @ rotation(rng).T + [1.1, 0.05, 0.8]]).astype(np.float32)
    return obj, cam, np.ones(n, bool)


def torch_args(obj, cam, valid, triples, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (obj, cam, valid, triples.astype(np.int64)))


def fp64_counts(obj, cam, valid, rs, ts, threshold):
    """The fp64 inlier count of each fit (H,), and how many of its valid
    points lie within BAND of the fp32 threshold (H,)."""
    thr = float(np.float32(threshold))
    err = np.linalg.norm(obj.astype(np.float64) @ np.swapaxes(rs.astype(np.float64), 1, 2)
                         + ts.astype(np.float64)[:, None] - cam.astype(np.float64), axis=-1)
    return (((err < thr) & valid).sum(1), ((np.abs(err - thr) <= BAND * thr) & valid).sum(1))


# --- the CPU: the plain versions against JAX ---


@pytest.fixture(scope="module")
def jax_kabsch():
    """JAX's `_kabsch`, vmapped over hypotheses and jitted once."""
    import jax

    from posecnn_tpu.refine import ransac as jr

    return jax.jit(jax.vmap(jr._kabsch))


@pytest.fixture
def jax_pose(monkeypatch):
    """JAX's jitted `estimate_pose_3d` on given triples: its draw,
    `jax.random.randint` of each hypothesis' key, is replaced by the
    position in its valid-first order of that hypothesis' triple (looked up
    by the key), so the JAX body scores and refines exactly these triples."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.refine import ransac as jr

    def run(obj, cam, valid, triples, threshold, num_refine):
        key = jax.random.PRNGKey(0)
        keys = jax.random.split(key, len(triples))
        order = np.argsort(~valid, kind="stable")
        position = np.empty_like(order)
        position[order] = np.arange(len(order))
        table = jnp.asarray(position[triples].astype(np.int32))

        def lookup(k, shape, minval, maxval):
            return table[jnp.argmax(jnp.all(keys == k, axis=-1))]

        monkeypatch.setattr(jax.random, "randint", lookup)
        # a copy of the body, jitted anew: JAX keys its traces by the
        # function, so the body itself may hold a trace of another draw
        body = jr.estimate_pose_3d.__wrapped__
        fresh = types.FunctionType(body.__code__, body.__globals__, body.__name__,
                                   body.__defaults__, body.__closure__)
        fresh.__kwdefaults__ = body.__kwdefaults__
        fn = jax.jit(fresh, static_argnames=("num_hypotheses", "num_refine"))
        out = fn(jnp.asarray(obj), jnp.asarray(cam), jnp.asarray(valid), key,
                 num_hypotheses=len(triples), inlier_threshold=threshold, num_refine=num_refine)
        monkeypatch.undo()
        return out

    return run


@pytest.mark.parametrize("case", ["outliers", "invalid_entries"])
def test_hypotheses_plain_match_jax_and_fp64(jax_kabsch, case):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    obj, cam, valid = scene(rng, 200, invalid=0.2 if case == "invalid_entries" else 0.0)
    triples = rng.randint(0, 200, (64, 3))
    rs, ts, scores = ransac.pose_hypotheses_plain(*torch_args(obj, cam, valid, triples),
                                                  THRESHOLD)
    w3 = valid[triples].astype(np.float32)
    r_j, t_j = jax_kabsch(jnp.asarray(obj[triples]), jnp.asarray(cam[triples]), jnp.asarray(w3))
    cov = ransac.weighted_covariance(*(torch.from_numpy(a).double()
                                       for a in (obj[triples], cam[triples], w3)))[0]
    sv = torch.linalg.svdvals(cov).numpy()
    distinct = np.array([len(set(t)) == 3 for t in triples])
    usable = w3.sum(1) == 3
    apart = distinct & usable & (np.minimum(sv[:, 0] - sv[:, 1], sv[:, 1] - sv[:, 2])
                                 > GAP * sv[:, 0])
    assert apart.sum() >= (40 if case == "outliers" else 20)
    np.testing.assert_allclose(rs.numpy()[apart], np.asarray(r_j)[apart], rtol=0, atol=TOL)
    np.testing.assert_allclose(ts.numpy()[apart], np.asarray(t_j)[apart], rtol=0, atol=TOL)
    count, near = fp64_counts(obj, cam, valid, rs.numpy(), ts.numpy(), THRESHOLD)
    scores = scores.numpy()
    assert scores.dtype == np.int64 and (scores[~usable] == -1).all()
    assert (np.abs(scores - count)[usable] <= near[usable]).all()
    assert (case == "outliers") == usable.all()


def refine_case(case):
    """(obj, cam, valid, triples, num_refine) of a `pose_refine_plain` case."""
    rng = np.random.RandomState(1)
    if case == "all_invalid":
        obj, cam, _ = scene(rng, 50)
        return obj, cam, np.zeros(50, bool), rng.randint(0, 50, (16, 3)), 2
    if case == "n3":
        obj, cam, valid = scene(rng, 3, outliers=0.0)
        return obj, cam, valid, np.array([rng.permutation(3) for _ in range(8)]), 2
    if case == "one_hypothesis":
        obj, cam, valid = scene(rng, 100)
        return obj, cam, valid, np.array([[40, 61, 87]]), 2
    if case == "invalid_triples":
        obj, cam, valid = scene(rng, 120, invalid=0.2)
        return obj, cam, valid, rng.randint(0, 120, (32, 3)), 2
    obj, cam, valid = two_motions(rng, 80)  # "tied": triple 0 from the second half
    halves = [rng.choice(np.arange(40, 80), 3, replace=False) if i % 2 == 0
              else rng.choice(40, 3, replace=False) for i in range(16)]
    return obj, cam, valid, np.array(halves), 2


@pytest.mark.parametrize("case", ["all_invalid", "n3", "one_hypothesis", "invalid_triples",
                                  "tied"])
def test_refine_plain_matches_jax(jax_pose, case):
    obj, cam, valid, triples, num_refine = refine_case(case)
    args = torch_args(obj, cam, valid, triples)
    hyps = ransac.pose_hypotheses_plain(*args, THRESHOLD)
    got = ransac.pose_refine_plain(*args[:3], *hyps, THRESHOLD, num_refine)
    want = jax_pose(obj, cam, valid, triples, THRESHOLD, num_refine)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0,
                               atol=TOL)
    assert float(got.inliers) == float(want.inliers)
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-6)
    scores = hyps[2].numpy()
    if case == "all_invalid":
        assert (scores == -1).all() and float(got.inliers) == 0 and float(got.score) == 0
    if case == "invalid_triples":
        assert 0 < (scores == -1).sum() < len(scores)
    if case == "tied":  # all tie at 40; the first is the second half's motion
        assert (scores == 40).all() and float(got.inliers) == 40
        second = np.linalg.norm(obj[40:] @ got.rotation.numpy().T + got.translation.numpy()
                                - cam[40:], axis=1)
        assert second.max() < 1e-5


def test_estimate_pose_3d_is_the_two_plain_steps():
    rng = np.random.RandomState(2)
    obj, cam, valid = scene(rng, 300, invalid=0.1)
    args = torch_args(obj, cam, valid, rng.randint(0, 300, (48, 3)))
    for num_refine in (0, 1, 2):
        got = ransac.estimate_pose_3d(*args, inlier_threshold=THRESHOLD, num_refine=num_refine)
        hyps = ransac.pose_hypotheses_plain(*args, THRESHOLD)
        want = ransac.pose_refine_plain(*args[:3], *hyps, THRESHOLD, num_refine)
        assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    # the wrappers on CPU tensors are the plain versions, no kernel launched
    launches = dict(_cuda.LAUNCHES)
    hyps_w = ransac.pose_hypotheses(*args, THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(hyps_w, hyps))
    out = ransac.pose_refine(*args[:3], *hyps, THRESHOLD, 2)
    assert all(torch.equal(a, b) for a, b in zip(
        out, ransac.pose_refine_plain(*args[:3], *hyps, THRESHOLD, 2)))
    assert _cuda.LAUNCHES == launches


# --- on the card ---


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pose kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def launched_once(call):
    """call() with one launch of each pose kernel, counted by the wrappers
    and on the device."""
    _cuda.reset_device_launches()
    before = dict(_cuda.LAUNCHES)
    out = call()
    after = {k: _cuda.LAUNCHES[k] - before[k] for k in _cuda.KERNELS}
    want = {**dict.fromkeys(_cuda.KERNELS, 0), "pose_hyp": 1, "pose_refine": 1}
    assert after == want and _cuda.device_launches() == want, (after, _cuda.device_launches())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hyp", [1, 16, 256, 1000])
@pytest.mark.parametrize("n", [3, 64, 4096, 4097, 65536])
def test_pose_kernels_match_plain_on_the_card(cuda, n, hyp):
    """Each kernel against its plain version at `chip_smoke`'s bars, on a
    scene with outliers and invalid entries, triples drawn over all
    entries (so some hold invalid ones); estimate_pose_3d one launch of
    each."""
    from chip_smoke import pose_hypotheses_vs_plain, pose_refine_vs_plain

    rng = np.random.RandomState(n + hyp)
    obj, cam, valid = scene(rng, n, invalid=0.1 if n > 3 else 0.0)
    args = torch_args(obj, cam, valid, rng.randint(0, n, (hyp, 3)), cuda)
    est = launched_once(lambda: ransac.estimate_pose_3d(*args, inlier_threshold=THRESHOLD))
    stats = pose_hypotheses_vs_plain(*args, THRESHOLD, f"({n}, {hyp})")
    hyps = ransac.pose_hypotheses(*args, THRESHOLD)
    refined = pose_refine_vs_plain(*args[:3], hyps, THRESHOLD, 2, f"({n}, {hyp})")
    assert all(torch.equal(a, b) for a, b in zip(
        est, ransac.pose_refine(*args[:3], *hyps, THRESHOLD, 2)))
    if n >= 4096 and hyp >= 256:
        assert stats["compared"] > hyp // 2 and refined["inliers"] > 0.5 * n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_invalid", "no_points", "tied"])
def test_pose_kernels_edges_on_the_card(cuda, case):
    from chip_smoke import pose_hypotheses_vs_plain, pose_refine_vs_plain

    rng = np.random.RandomState(7)
    if case == "no_points":  # nothing to gather: every triple invalid
        args = torch_args(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                          np.zeros(0, bool), np.zeros((4, 3), np.int64), cuda)
        out = launched_once(lambda: ransac.estimate_pose_3d(*args, inlier_threshold=THRESHOLD))
        rs, ts, scores = ransac.pose_hypotheses(*args, THRESHOLD)
        assert (scores == -1).all() and torch.equal(rs, torch.eye(3, device=cuda).expand(4, 3, 3))
        assert torch.equal(out.rotation, torch.eye(3, device=cuda)) and float(out.score) == 0
        assert float(out.inliers) == 0 and not bool(ts.any())
        return
    if case == "all_invalid":
        obj, cam, _ = scene(rng, 4096)
        args = torch_args(obj, cam, np.zeros(4096, bool), rng.randint(0, 4096, (256, 3)), cuda)
        pose_hypotheses_vs_plain(*args, THRESHOLD, "all invalid")
        hyps = ransac.pose_hypotheses(*args, THRESHOLD)
        assert bool((hyps[2] == -1).all())
        refined = pose_refine_vs_plain(*args[:3], hyps, THRESHOLD, 2, "all invalid",
                                       exact=True)
        assert refined["inliers"] == 0
        return
    obj, cam, valid = two_motions(rng, 4096)  # "tied"
    triples = np.array([rng.choice(np.arange(2048, 4096), 3, replace=False) if i % 2 == 0
                        else rng.choice(2048, 3, replace=False) for i in range(64)])
    args = torch_args(obj, cam, valid, triples, cuda)
    hyps = ransac.pose_hypotheses(*args, THRESHOLD)
    assert bool((hyps[2] == 2048).all())  # noise-free halves: every fit holds its half
    pose_refine_vs_plain(*args[:3], hyps, THRESHOLD, 2, "tied", exact=True)
    # ties far apart in the order pick the first; without a round, its fit as it is
    scores = torch.zeros(1000, dtype=torch.int64, device=cuda)
    scores[[5, 517, 999]] = 9
    rs = torch.from_numpy(np.stack([rotation(rng) for _ in range(1000)])).to(cuda)
    ts = torch.randn(1000, 3, device=cuda)
    out = ransac.pose_refine(*args[:3], rs, ts, scores, THRESHOLD, 0)
    assert torch.equal(out.rotation, rs[5]) and torch.equal(out.translation, ts[5])
