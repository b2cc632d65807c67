"""Port: the detection family's ops (box transforms, class-agnostic NMS,
the gather RoI-Align, the RPN's proposals and targets, the translation
from a box) against the JAX package on the same numpy inputs, with
JAX's own uniform draws fed to the port's target layers.

Tolerances: anchors, keep masks, labels and sampled rows equal; box
transforms within 1e-6; RoI-Align, proposal boxes and scores and
targets within 1e-5; translations within 1e-4 m.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_torch.ops import rpn
from posecnn_torch.ops.nms import nms, nms_per_class
from posecnn_torch.ops.roi_align import roi_align
from posecnn_torch.utils import bbox

# the JAX package's ops modules (posecnn_tpu.ops re-exports functions of
# the same names)
jax_nms_mod = importlib.import_module("posecnn_tpu.ops.nms")
jax_roi_mod = importlib.import_module("posecnn_tpu.ops.roi_align")
jax_rpn = importlib.import_module("posecnn_tpu.ops.rpn")
jax_bbox = importlib.import_module("posecnn_tpu.utils.bbox")

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))
SCALES, RATIOS = (4, 8, 16, 32), (0.5, 0.75, 1, 1.5, 2)  # lov_det.yaml


def jnp_(x):
    return jnp.asarray(np.asarray(x))


def random_boxes(rng, n, h=64, w=96, lo=4, hi=40):
    x1 = rng.uniform(0, w - lo, n)
    y1 = rng.uniform(0, h - lo, n)
    return np.stack([x1, y1, x1 + rng.uniform(lo, hi, n), y1 + rng.uniform(lo, hi, n)],
                    1).astype(np.float32)


def test_anchors_and_grid_are_exact():
    for scales, ratios in ((SCALES, RATIOS), ((8, 16, 32), (0.5, 1.0, 2.0))):
        want = jax_rpn.generate_anchors(16, ratios, scales)
        got = rpn.generate_anchors(16, ratios, scales)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rpn.anchor_grid(30, 40, 16, got),
                                      jax_rpn.anchor_grid(30, 40, 16, want))


def test_box_transforms_match_jax():
    rng = np.random.RandomState(0)
    ex, gt = random_boxes(rng, 50), random_boxes(rng, 50)
    np.testing.assert_allclose(bbox.bbox_transform(T(ex), T(gt)).numpy(),
                               np.asarray(jax_bbox.bbox_transform(jnp_(ex), jnp_(gt))),
                               rtol=0, atol=1e-6)
    deltas = (0.3 * rng.randn(50, 12)).astype(np.float32)  # 3 classes of 4
    got = bbox.bbox_transform_inv(T(ex), T(deltas)).numpy()
    want = np.asarray(jax_bbox.bbox_transform_inv(jnp_(ex), jnp_(deltas)))
    assert got.shape == want.shape == (50, 12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    big = (want * 1.5 - 20).astype(np.float32)
    np.testing.assert_array_equal(bbox.clip_boxes(T(big), 64, 96).numpy(),
                                  np.asarray(jax_bbox.clip_boxes(jnp_(big), 64, 96)))


def test_nms_keep_mask_equals_jax():
    """300 boxes in a few clusters, scores with planted ties (a tenth share
    one value, some exactly repeated pairs), a fifth invalid."""
    rng = np.random.RandomState(1)
    centres = rng.uniform(10, 80, (12, 2))
    c = centres[rng.randint(0, 12, 300)] + rng.randn(300, 2) * 4
    wh = rng.uniform(8, 30, (300, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    scores[rng.rand(300) < 0.1] = 0.5
    scores[1::37] = scores[0::37][: len(scores[1::37])]
    valid = rng.rand(300) > 0.2
    for thr in (0.3, 0.5, 0.7):
        want = np.asarray(jax_nms_mod.nms(jnp_(boxes), jnp_(scores), thr, valid=jnp_(valid)))
        got = nms(T(boxes), T(scores), thr, valid=T(valid)).numpy()
        assert want.sum() > 10
        np.testing.assert_array_equal(got, want)
    # batched, as the detection head's class loop: one NMS a score column
    boxes3 = np.stack([boxes, boxes + 3.0, boxes[::-1].copy()])
    scores3 = np.stack([scores, scores[::-1], np.round(scores, 1)])
    got = nms(T(boxes3), T(scores3), 0.5, valid=T(valid)).numpy()
    for c in range(3):
        want = jax_nms_mod.nms(jnp_(boxes3[c]), jnp_(scores3[c]), 0.5, valid=jnp_(valid))
        np.testing.assert_array_equal(got[c], np.asarray(want), err_msg=f"column {c}")
    # the per-class form on Hough rows: (batch, class) pairs with ties
    rois = np.concatenate([rng.randint(0, 2, (300, 1)), rng.randint(1, 4, (300, 1)), boxes,
                           scores[:, None]], 1).astype(np.float32)
    want = np.asarray(jax_nms_mod.nms_per_class(jnp_(rois), 0.5, valid=jnp_(valid)))
    np.testing.assert_array_equal(nms_per_class(T(rois), 0.5, T(valid)).numpy(), want)


def test_roi_align_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 4, 6, 8).astype(np.float32)
    boxes = random_boxes(rng, 10, 64, 96)
    boxes[0] = [0, 0, 95, 63]  # the whole frame, clamped at the far edge
    boxes[1] = [40, 20, 41, 21]  # under one bin
    rois = np.concatenate([rng.randint(0, 2, (10, 1)), np.zeros((10, 1)), boxes,
                           np.ones((10, 1))], 1).astype(np.float32)
    want = np.asarray(jax_roi_mod.roi_align(jnp_(feats), jnp_(rois), pooled_size=7,
                                            spatial_scale=1 / 16))
    got = roi_align(T(feats), T(rois), pooled_size=7, spatial_scale=1 / 16).numpy()
    assert got.shape == want.shape == (10, 7, 7, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def rpn_inputs(rng, h, w, a):
    logits = rng.randn(h, w, 2, a).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    prob = prob.reshape(h, w, 2 * a).astype(np.float32)
    deltas = (0.2 * rng.randn(h, w, 4 * a)).astype(np.float32)
    return prob, deltas


@pytest.mark.parametrize("pre,post", [(100, 16), (2000, 200)])
def test_proposal_layer_matches_jax(pre, post):
    """(2000, 200) asks for more rows than the 4×6 map's 120 anchors and
    more slots than survive NMS: the padded path."""
    rng = np.random.RandomState(3)
    h, w, a = 4, 6, 5
    base = rpn.generate_anchors(16, (0.5, 1, 2), (2, 4))[:a]
    anchors = rpn.anchor_grid(h, w, 16, base)
    prob, deltas = rpn_inputs(rng, h, w, a)
    prob[0, 0, a:] = prob[0, 1, a:]  # tied fg scores
    kw = dict(pre_nms_topk=pre, post_nms_topk=post, nms_threshold=0.7, min_size=16.0)
    want = jax_rpn.proposal_layer(jnp_(prob), jnp_(deltas), jnp_(anchors), 64, 96, **kw)
    got = rpn.proposal_layer(T(prob), T(deltas), T(anchors), 64, 96, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 3
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def gt_set(rng):
    """Four GT boxes: two inside, one on the image border, one padded."""
    gt = np.zeros((4, 5), np.float32)
    gt[0] = [10, 8, 50, 40, 1]
    gt[1] = [30, 20, 90, 60, 2]
    gt[2] = [0, 0, 20, 63, 3]  # touches the left and bottom borders
    valid = np.array([True, True, True, False])
    poses = np.zeros((4, 13), np.float32)
    q = rng.randn(4, 4)
    poses[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    poses[:, 1] = gt[:, 4]
    return gt, valid, poses


@pytest.mark.parametrize("clobber", [False, True])
def test_anchor_target_layer_matches_jax(clobber):
    rng = np.random.RandomState(4)
    h, w = 4, 6
    anchors = rpn.anchor_grid(h, w, 16, rpn.generate_anchors(16, (0.5, 1, 2), (1, 2, 4)))
    gt, valid, _ = gt_set(rng)
    key = jax.random.PRNGKey(7)
    kw = dict(positive_overlap=0.5, negative_overlap=0.3, batch_size=32, fg_fraction=0.5,
              clobber_positives=clobber)
    want = jax_rpn.anchor_target_layer(jnp_(anchors), jnp_(gt), jnp_(valid), 64, 96, key, **kw)
    k1, k2 = jax.random.split(key)
    n = anchors.shape[0]
    fg, bg = (T(np.asarray(jax.random.uniform(k, (n,)))) for k in (k1, k2))
    got = rpn.anchor_target_layer(T(anchors), T(gt), T(valid), 64, 96, fg, bg, **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels == 1).sum() > 0 and (got.labels == 0).sum() > 0
    for name in ("bbox_targets", "bbox_inside_weights", "bbox_outside_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("normalize", [False, True])
def test_proposal_target_layer_matches_jax(normalize):
    rng = np.random.RandomState(5)
    n_prop, c = 24, 4
    gt, valid, poses = gt_set(rng)
    boxes = np.concatenate([random_boxes(rng, n_prop - 6),
                            gt[:3, :4] + rng.randn(3, 4).astype(np.float32),
                            gt[:3, :4] + 2 * rng.randn(3, 4).astype(np.float32)])
    rois = np.concatenate([np.zeros((n_prop, 1)), boxes], 1).astype(np.float32)
    pvalid = rng.rand(n_prop) > 0.2
    scores = rng.rand(n_prop).astype(np.float32)
    norm = dict(bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2)) if normalize else {}
    kw = dict(rois_per_image=16, fg_fraction=0.25, fg_thresh=0.5, bg_thresh_hi=0.5,
              bg_thresh_lo=0.1, **norm)
    key = jax.random.PRNGKey(11)
    want = jax_rpn.proposal_target_layer(
        jax_rpn.Proposals(jnp_(rois), jnp_(scores), jnp_(pvalid)), jnp_(gt), jnp_(poses),
        jnp_(valid), c, key, **kw)
    k1, k2 = jax.random.split(key)
    n = n_prop + gt.shape[0]
    fg, bg = (T(np.asarray(jax.random.uniform(k, (n,)))) for k in (k1, k2))
    got = rpn.proposal_target_layer(rpn.Proposals(T(rois), T(scores), T(pvalid)), T(gt),
                                    T(poses), T(valid), c, fg, bg, **kw)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert (got.labels > 0).sum() > 0
    for name in ("bbox_targets", "bbox_inside_weights", "pose_targets", "pose_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_translation_from_box_matches_jax():
    rng = np.random.RandomState(6)
    k = np.array([[500.0, 0, 48], [0, 500.0, 32], [0, 0, 1]], np.float32)
    pts = (rng.rand(3, 64, 3) * [0.1, 0.06, 0.08] - [0.05, 0.03, 0.04]).astype(np.float32)
    q = rng.randn(3, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    boxes = np.array([[30, 20, 60, 44], [5, 5, 25, 30], [40, 10, 44, 14]], np.float32)
    want = np.stack([np.asarray(jax_rpn.estimate_translation_from_box(
        jnp_(q[i]), jnp_(boxes[i]), jnp_(pts[i]), jnp_(k))) for i in range(3)])
    got = rpn.estimate_translation_from_box(T(q), T(boxes), T(pts), T(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
