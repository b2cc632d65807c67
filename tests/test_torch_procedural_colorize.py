"""Port parity: the carried appearance of dataset model clouds
(posecnn_torch.data.procedural: `apply_orient_markers`,
`colorize_point_cloud`, `colorize_model_library`, `fill_missing_points`)
against posecnn_tpu.data.procedural on the CPU, bit for bit, with and
without the orientation paint (versions 3 and 4)."""

import numpy as np
import pytest

import posecnn_tpu.data.procedural as jproc
import posecnn_torch.data.procedural as tproc


def library(num_classes=5, num_points=400, zero=(2,)):
    """A model library like a dataset reader's: procedural clouds, with
    the classes in `zero` left all-zero (no points.xyz on disk)."""
    lib = tproc.make_procedural_objects(num_classes, num_points, seed=3)
    points = lib.points.copy()
    points[list(zero)] = 0.0
    return points, lib.extents


PAINTS = [(False, 3), (True, 3), (True, 4)]


@pytest.mark.parametrize("orient,version", PAINTS)
def test_colorize_model_library_matches_jax(orient, version):
    points, _ = library()
    got = tproc.colorize_model_library(points, seed=1, orient_detail=orient,
                                       paint_version=version)
    want = jproc.colorize_model_library(points, seed=1, orient_detail=orient,
                                        paint_version=version)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    colors, normals = got
    assert not colors[2].any() and colors[1].any()  # empty classes stay unpainted
    np.testing.assert_allclose(np.linalg.norm(normals[1], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("orient,version", PAINTS)
def test_fill_missing_points_matches_jax(orient, version):
    points, extents = library(zero=(2, 4))
    got = tproc.fill_missing_points(points, extents, seed=0, orient_detail=orient,
                                    paint_version=version)
    want = jproc.fill_missing_points(points, extents, seed=0, orient_detail=orient,
                                     paint_version=version)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    filled = got[0]
    # the stand-ins take the classes' real extents
    np.testing.assert_allclose(np.abs(filled[4]).max(0) * 2, extents[4], rtol=1e-5)
    np.testing.assert_array_equal(filled[1], points[1])


@pytest.mark.parametrize("version", [3, 4])
def test_orient_markers_and_point_cloud_paint_match_jax(version):
    points, _ = library()
    base = np.full((points.shape[1], 3), 100.0, np.float32)
    np.testing.assert_array_equal(tproc.apply_orient_markers(points[1], base.copy(), version),
                                  jproc.apply_orient_markers(points[1], base.copy(), version))
    for hue in (None, 0.3):
        got = tproc.colorize_point_cloud(points[3], seed=7, base_hue=hue, orient_detail=True,
                                         paint_version=version)
        want = jproc.colorize_point_cloud(points[3], seed=7, base_hue=hue, orient_detail=True,
                                          paint_version=version)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
