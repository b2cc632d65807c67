"""Port parity: Hough voting's training emission and `append_gt_rois`
(posecnn_torch.ops.hough_voting) against the JAX package, row for row.

Scenes are the planted ones of tests/test_torch_hough.py (1/8-resolution
direction fields) with GT rows that match a maximum (IoU > 0.2), rows
that miss it (wrong place, wrong class, wrong image) and padding rows
(gt_valid False). The port's dense backend is held to JAX "xla"; one case
holds the port's c2f to JAX "pallas_c2f" in interpret mode.

Tolerances: valid, targets, weights and domains exact; rois and
poses_init rtol 1e-5, atol 1e-4 (as tests/test_torch_hough.py); the GT
boxes of append_gt_rois atol 1e-4 (a 3×3 product summed in another order).
"""

import importlib
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jhv = importlib.import_module("posecnn_tpu.ops.hough_voting")
from posecnn_torch.ops import hough_voting as thv
from tests.test_hough_voting import EXTENTS, FX, FY, NUM_CLASSES, PX, PY, make_meta
from tests.test_torch_hough import KW, SCENES, lowres_scene

torch.set_num_threads(1)
F = 8
M = 3  # maxima per image


def gt_row(batch, cls, cx, cy, depth, quat=(1.0, 0.0, 0.0, 0.0)):
    row = np.zeros(13, np.float32)
    row[0], row[1] = batch, cls
    row[6:10] = quat
    row[10:13] = ((cx - PX) / FX * depth, (cy - PY) / FY * depth, depth)
    return row


def gt_for(objects_per_image, extra=(), pad=2):
    """One GT row per planted object (tilted a little), the `extra` rows,
    then `pad` padding rows."""
    q = np.array([0.95, 0.1, -0.2, 0.2], np.float32)
    q /= np.linalg.norm(q)
    rows = [gt_row(b, cls, cx, cy, d, q) for b, objs in enumerate(objects_per_image)
            for cls, cx, cy, d, _, _ in objs]
    rows += list(extra)
    valid = [True] * len(rows) + [False] * pad
    rows += [gt_row(0, 1, 40.0, 40.0, 1.0)] * pad  # padding that would match if valid
    return np.stack(rows), np.array(valid)


HOUGH_KW = dict(KW, max_objects_per_image=M, vertex_factor=F)


@lru_cache(maxsize=None)
def jax_hough(backend):
    """The JAX training Hough, jitted: its eager "xla" reduction
    dispatches op by op (~15 s a call here)."""
    return jax.jit(partial(jhv.hough_voting, is_train=True, backend=backend, sample_chunk=8,
                           **HOUGH_KW))


def run_both(objects_per_image, gt_poses, gt_valid, backend_t="dense", backend_j="xla"):
    labels, verts = zip(*(lowres_scene(o, noise=0.05, seed=i)
                          for i, o in enumerate(objects_per_image)))
    label, vert = np.stack(labels), np.stack(verts)
    meta = np.stack([make_meta()] * len(labels))
    want = jax_hough(backend_j)(jnp.asarray(label), jnp.asarray(vert), jnp.asarray(EXTENTS),
                                jnp.asarray(meta), jnp.asarray(gt_poses), jnp.asarray(gt_valid))
    got = thv.hough_voting(
        torch.from_numpy(label), torch.from_numpy(vert), torch.from_numpy(EXTENTS),
        torch.from_numpy(meta), torch.from_numpy(gt_poses), torch.from_numpy(gt_valid),
        is_train=True, backend=backend_t, **HOUGH_KW)
    return got, want, meta


def assert_rows_equal(got, want):
    for name in ("valid", "poses_target", "poses_weight", "domains"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("rois", "poses_init"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


CASES = {
    # every planted object matched
    "two": ([SCENES["two"]], ()),
    # a GT of the right class far away, one of a class not in the image,
    # one in an image that does not exist
    "misses": ([SCENES["corner_three"]],
               (gt_row(0, 2, 20.0, 100.0, 1.0), gt_row(0, 3, 150.0, 10.0, 2.0),
                gt_row(1, 1, 30.0, 40.0, 0.9))),
    # two images; the second has one object, matched in its own image only
    "batch2": ([SCENES["two"], SCENES["single"]], (gt_row(1, 1, 40.0, 40.0, 0.8),)),
    # no object at all: nothing valid, domain 0 (GT rows exist)
    "empty": ([SCENES["empty"]], ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_training_emission_matches_jax_xla(name):
    objects, extra = CASES[name]
    gt, gt_valid = gt_for(objects, extra)
    got, want, _ = run_both(objects, gt, gt_valid)
    b = len(objects)
    assert got.rois.shape == (9 * b * M, 7)
    assert_rows_equal(got, want)
    matched = got.poses_weight.numpy().max(1) > 0
    if name != "empty":
        assert matched.any() and (got.valid.numpy() & ~matched).sum() >= 0
        # the 9 jittered rows of a maximum share everything but the box
        rois = got.rois.numpy().reshape(b * M, 9, 7)
        np.testing.assert_array_equal(rois[:, :, [0, 1, 6]], rois[:, :1, [0, 1, 6]].repeat(9, 1))
    if name == "two":
        assert matched.sum() >= 9


def test_no_valid_gt_gives_domain_1():
    objects = [SCENES["two"]]
    gt, _ = gt_for(objects)
    gt_valid = np.zeros(len(gt), bool)
    got, want, _ = run_both(objects, gt, gt_valid)
    assert_rows_equal(got, want)
    assert (got.domains.numpy() == 1).all() and not got.poses_weight.any()


def test_training_emission_c2f_matches_jax_pallas_c2f():
    objects, extra = CASES["misses"]
    gt, gt_valid = gt_for(objects, extra)
    got, want, _ = run_both(objects, gt, gt_valid, backend_t="c2f", backend_j="pallas_c2f")
    assert_rows_equal(got, want)
    assert got.poses_weight.numpy().max(1).sum() > 0


@pytest.mark.parametrize("name", ["two", "batch2"])
def test_append_gt_rois_matches_jax(name):
    objects, extra = CASES[name]
    gt, gt_valid = gt_for(objects, extra)
    got, want, meta = run_both(objects, gt, gt_valid)
    got = thv.append_gt_rois(got, torch.from_numpy(gt), torch.from_numpy(gt_valid),
                             torch.from_numpy(EXTENTS), torch.from_numpy(meta), NUM_CLASSES)
    want = jhv.append_gt_rois(want, jnp.asarray(gt), jnp.asarray(gt_valid),
                              jnp.asarray(EXTENTS), jnp.asarray(meta), NUM_CLASSES)
    assert got.rois.shape[0] == len(gt) + 9 * len(objects) * M
    assert_rows_equal(got, want)
    # the prepended rows: one per GT row, weight 1 exactly where valid
    w = got.poses_weight.numpy()[: len(gt)]
    np.testing.assert_array_equal(w.max(1) > 0, gt_valid)
