"""Port parity: the C++ data-path loops (`posecnn_torch/data/native.py`
over the carried `csrc/blobops.cpp`).

The port's library against the JAX package's (`posecnn_tpu/data/native.py`
over `native/blobops.cpp`), bit for bit, on `splat_points`,
`splat_points_rgb` and `vertex_targets` (the pattern of JAX's
`tests/test_native.py`); the library against the port's numpy path in the
generator, splats bit for bit and vertex targets within 1e-6 (fp32 against
fp64 directions); and a build that fails raises instead of falling back.
"""

import numpy as np
import pytest
import torch

import posecnn_tpu.data.native as jnative
from posecnn_torch.data import minibatch as tmb
from posecnn_torch.data import native as tnative
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator

torch.set_num_threads(1)
H, W = 60, 80


def points(rng, n=3000):
    """Projected points with some off the frame and some behind the camera."""
    u = rng.randint(-10, W + 10, n)
    v = rng.randint(-10, H + 10, n)
    z = rng.uniform(-0.1, 2.0, n).astype(np.float32)
    return u, v, z


def buffers():
    return (np.full((H, W), np.inf, np.float32), np.zeros((H, W), np.int32),
            np.zeros((H, W, 3), np.float32))


@pytest.fixture(scope="module")
def jax_lib():
    assert jnative.get_lib() is not None, "the JAX package's library did not build"


@pytest.mark.parametrize("radius", [0, 2])
def test_splat_points_equals_jax(jax_lib, radius):
    rng = np.random.RandomState(radius)
    u, v, z = points(rng)
    color = np.array([100.0, 50.0, 25.0], np.float32)
    got, want = buffers(), buffers()
    tnative.splat_points_native(u, v, z, 3, radius, color, 2.0, *got)
    assert jnative.splat_points_native(u, v, z, 3, radius, color, 2.0, *want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 3).sum() > 100


@pytest.mark.parametrize("radius", [1, 3])
def test_splat_points_rgb_equals_jax(jax_lib, radius):
    rng = np.random.RandomState(10 + radius)
    u, v, z = points(rng)
    rgb = rng.uniform(0, 255, (len(u), 3)).astype(np.float32)
    got, want = buffers(), buffers()
    tnative.splat_points_rgb_native(u, v, z, rgb, 5, radius, *got)
    assert jnative.splat_points_rgb_native(u, v, z, rgb, 5, radius, *want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 5).sum() > 100


def test_vertex_targets_equal_jax(jax_lib):
    rng = np.random.RandomState(4)
    c = 6
    label = rng.randint(0, c + 1, (H, W)).astype(np.int32)  # c is out of range: skipped
    centers = (rng.rand(c, 2) * [W, H]).astype(np.float32)
    centers[3] = np.nan  # an absent class
    log_z = rng.randn(c).astype(np.float32)
    got = [np.zeros((H, W, 3 * c), np.float32) for _ in range(2)]
    want = [np.zeros((H, W, 3 * c), np.float32) for _ in range(2)]
    tnative.vertex_targets_native(label, centers, log_z, 10.0, c, *got)
    assert jnative.vertex_targets_native(label, centers, log_z, 10.0, c, *want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 10.0).any() and not got[1][label == 3].any()


@pytest.mark.parametrize("textured", [True, False])
def test_library_equals_the_numpy_path(textured):
    """The render through the library against `native=False`: the splats
    (image, label, depth) bit for bit, the vertex targets within 1e-6."""
    lib = synthetic_class_library(5, 512)
    k = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    kw = dict(width=W, height=H, seed=7, min_objects=3, max_objects=4)
    if textured:
        kw.update(point_colors=lib.colors, point_normals=lib.normals)
    got = SyntheticSceneGenerator(lib.points, lib.extents, k, **kw).minibatch(2)
    want = SyntheticSceneGenerator(lib.points, lib.extents, k, native=False, **kw).minibatch(2)
    assert set(got) == set(want) and got["label"].any()
    for key in got:
        if key == "vertex_targets":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_vertex_targets_library_against_numpy():
    rng = np.random.RandomState(2)
    label = rng.randint(0, 4, (H, W)).astype(np.int32)
    cls = np.array([2, 1, 2], np.int64)  # the first instance of class 2 claims it
    centers = (rng.rand(3, 2) * [W, H]).astype(np.float32)
    zs = (rng.rand(3) + 0.5).astype(np.float32)
    got = tmb.generate_vertex_targets(label, cls, centers, zs, 4)
    want = tmb.generate_vertex_targets(label, cls, centers, zs, 4, native=False)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


def test_a_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        tnative.build(build_dir=tmp_path, compiler=str(tmp_path / "no-such-g++"))
    assert not list(tmp_path.glob("*.so"))


def test_a_failing_compile_raises_with_its_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void f() { this is not C++; }\n")
    with pytest.raises(RuntimeError, match="failed on bad.cpp") as err:
        tnative.build(source=bad, build_dir=tmp_path)
    assert "error" in str(err.value)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_the_build_lands_in_the_port_build_dir():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert tnative.build() == path  # built once


def test_numpy_splat_breaks_depth_ties_as_the_library():
    """Points that meet at one depth on one pixel with other colours: the
    library keeps the first in point order, and so does the port's numpy
    path. (JAX's numpy fallback keeps the first by splat offset: on 12
    flagship-size renders its two paths differed on one pixel.)"""
    rng = np.random.RandomState(8)
    n = 4000
    u, v = rng.randint(-5, W + 5, n), rng.randint(-5, H + 5, n)
    z = rng.choice(np.float32([1.0, 1.25, 1.5]), n)  # ties everywhere
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    lib = synthetic_class_library(3, 8)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, np.eye(3, dtype=np.float32),
                                  native=False)
    got, want = buffers(), buffers()
    gen._splat_rgb_numpy(2, u, v, z, rgb, 2, *got)
    tnative.splat_points_rgb_native(u, v, z, rgb, 2, 2, *want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 2).all()
