"""Port parity: the carried host code of the synthetic scene generator.

The port's `data/synthetic.py`, `data/minibatch.py` and the numpy
quaternion helpers are numpy copies of the JAX package's (which cannot
be imported by the port: `posecnn_tpu.data` imports jax). With the same
seed, class library and camera they must give the same arrays. Both run
their splat and vertex-target loops in C++ by default (the port its
carried `csrc/blobops.cpp` through `data/native.py`, JAX
`native/blobops.cpp`), and agree to the bit; with JAX's library switched
off, the port's numpy path (`native=False`) agrees with JAX's to the bit.
"""

import numpy as np
import pytest

import posecnn_tpu.data.minibatch as jmb
import posecnn_tpu.data.native as jnative
import posecnn_tpu.utils.quaternion as jq
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator as JaxGenerator
from posecnn_torch.data import minibatch as tmb
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.utils import quaternion as tq

C, H, W = 4, 96, 128
K = np.array([[75.0, 0, W / 2], [0, 75.0, H / 2], [0, 0, 1]], np.float32)


def generators(textured, native=False, **kw):
    """The port's generator on its C++ loops or its numpy path, and JAX's."""
    lib = synthetic_class_library(C, 512)
    kw = dict(width=W, height=H, seed=11, min_objects=3, max_objects=3, **kw)
    if textured:
        kw.update(point_colors=lib.colors, point_normals=lib.normals)
    return (SyntheticSceneGenerator(lib.points, lib.extents, K, native=native, **kw),
            JaxGenerator(lib.points, lib.extents, K, **kw))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("textured", [True, False])
def test_minibatch_matches_jax(monkeypatch, textured, native):
    """The port's library against JAX's, and the numpy path against JAX
    with its library off: every array bit for bit."""
    if native:
        assert jnative.get_lib() is not None, "the JAX package's library did not build"
    else:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    gen_t, gen_j = generators(textured, native)
    got, want = gen_t.minibatch(2), gen_j.minibatch(2)
    assert set(got) == set(want)
    assert got["label"].any()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sparse_targets_and_pose_bank_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    rng = np.random.RandomState(3)
    bank = [None] + [np.concatenate([rng.randn(4, 4), rng.rand(4, 3) + [0, 0, 1]], 1)
                     for _ in range(C - 1)]
    gen_t, gen_j = generators(True, sample_pose=True, pose_bank=bank, min_separation=0.05)
    got = gen_t.minibatch(2, max_gt=4, dense_vertex_targets=False)
    want = gen_j.minibatch(2, max_gt=4, dense_vertex_targets=False)
    assert set(got) == set(want) and "vertex_centers" in got
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_backgrounds_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    pool = np.random.RandomState(5).randint(0, 255, (2, 60, 70, 3)).astype(np.float32)
    gen_t, gen_j = generators(False, backgrounds=pool, background_prob=1.0)
    np.testing.assert_array_equal(gen_t.minibatch(1)["data"], gen_j.minibatch(1)["data"])


def test_blob_helpers_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    rng = np.random.RandomState(0)
    label = rng.randint(0, C, (H, W)).astype(np.int32)
    cls = np.array([2, 1, 2], np.int64)
    centers = (rng.rand(3, 2) * [W, H]).astype(np.float32)
    zs = (rng.rand(3) + 0.5).astype(np.float32)
    for got, want in zip(tmb.generate_vertex_targets(label, cls, centers, zs, C, native=False),
                         jmb.generate_vertex_targets(label, cls, centers, zs, C)):
        np.testing.assert_array_equal(got, want)
    w2l = rng.randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(tmb.build_meta_blob(K, w2l, -w2l, (1, 2, 3), (4, 5, 6)),
                                  jmb.build_meta_blob(K, w2l, -w2l, (1, 2, 3), (4, 5, 6)))
    quats, trans = rng.randn(3, 4).astype(np.float32), rng.randn(3, 3).astype(np.float32)
    np.testing.assert_array_equal(tmb.build_pose_blob(1, cls, quats, trans, centers),
                                  jmb.build_pose_blob(1, cls, quats, trans, centers))


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(1)
    for _ in range(20):
        q, p = rng.randn(4), rng.randn(4)
        np.testing.assert_array_equal(tq.quat_to_mat_np(q), jq.quat_to_mat_np(q))
        np.testing.assert_array_equal(tq.quat_mul_np(q, p), jq.quat_mul_np(q, p))
        axis, angle = rng.randn(3), rng.uniform(-np.pi, np.pi)
        np.testing.assert_array_equal(tq.axis_angle_to_quat_np(axis, angle),
                                      jq.axis_angle_to_quat_np(axis, angle))
        m = jq.quat_to_mat_np(q)
        np.testing.assert_array_equal(tq.mat_to_quat_np(m), jq.mat_to_quat_np(m))
    # every branch of Shepperd's method: trace > 0, and each largest diagonal
    for q in ([1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]):
        m = jq.quat_to_mat_np(q)
        np.testing.assert_array_equal(tq.mat_to_quat_np(m), jq.mat_to_quat_np(m))
