"""Port parity: RoI pooling, the pose head, NMS, box IoU and detection
decoding against the JAX package, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.engine.evaluate import extract_detections as jax_extract
from posecnn_tpu.models.posecnn import PoseHead as JaxPoseHead
from posecnn_tpu.models.posecnn import _eval_pose_weight as jax_eval_weight
from posecnn_tpu.ops.hough_voting import HoughOutputs as JaxHough
from posecnn_tpu.ops.nms import nms_per_class as jax_nms
from posecnn_tpu.ops.roi_align import roi_pool_fused as jax_roi_pool
from posecnn_tpu.utils.bbox import box_iou as jax_box_iou
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.engine.evaluate import extract_detections
from posecnn_torch.models.posecnn import PoseHead, _eval_pose_weight
from posecnn_torch.ops.hough_voting import HoughOutputs
from posecnn_torch.ops.nms import nms_per_class
from posecnn_torch.ops.roi_align import roi_pool_fused
from posecnn_torch.utils.bbox import box_iou

torch.set_num_threads(1)
C = 4


def random_rois(rng, r, batch, width=96, height=64, ties=False):
    x1 = rng.uniform(-10, width, r)
    y1 = rng.uniform(-10, height, r)
    rois = np.stack([
        rng.randint(0, batch, r), rng.randint(1, C, r), x1, y1,
        x1 + rng.uniform(0, 60, r), y1 + rng.uniform(0, 40, r),
        np.round(rng.uniform(0, 5, r), 0 if ties else 3),
    ], 1).astype(np.float32)
    rois[0, 4:6] = rois[0, 2:4]  # a degenerate box (min size 1)
    return rois


@pytest.mark.parametrize("pooled_size", [7, 3])
def test_roi_pool_fused_matches_jax(pooled_size):
    rng = np.random.RandomState(0)
    conv4 = rng.randn(2, 8, 12, 16).astype(np.float32)
    conv5 = rng.randn(2, 4, 6, 16).astype(np.float32)
    rois = random_rois(rng, 9, 2)
    want = jax_roi_pool(jnp.asarray(conv4), jnp.asarray(conv5), jnp.asarray(rois),
                        pooled_size=pooled_size)
    got = roi_pool_fused(torch.from_numpy(conv4), torch.from_numpy(conv5),
                         torch.from_numpy(rois), pooled_size=pooled_size)
    assert got.shape == want.shape == (9, pooled_size, pooled_size, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm, act", [(True, "linear"), (False, "tanh")])
def test_pose_head_eval_matches_jax(norm, act):
    rng = np.random.RandomState(1)
    r = 6
    pooled = rng.randn(r, 7, 7, 8).astype(np.float32) * 3.0
    rois = random_rois(rng, r, 1)
    rois[2, 1] = 0  # background class row
    hough_j = JaxHough(jnp.asarray(rois), *([None] * 5))
    hough_t = HoughOutputs(torch.from_numpy(rois), *([None] * 5))
    weight_j = jax_eval_weight(hough_j, C)
    weight_t = _eval_pose_weight(hough_t, C)
    np.testing.assert_array_equal(weight_t.numpy(), np.asarray(weight_j))

    jhead = JaxPoseHead(C, fc_dim=32, compute_dtype=jnp.float32, norm_features=norm,
                        quat_activation=act)
    params = jhead.init(jax.random.PRNGKey(2), jnp.asarray(pooled), weight_j, train=False)
    want_pred, want_raw = jhead.apply(params, jnp.asarray(pooled), weight_j, train=False)
    state = params_from_jax(_flatten({"params": {"pose_head": params["params"]}}))
    head = PoseHead(C, 7 * 7 * 8, 32, norm_features=norm, quat_activation=act)
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        got_pred, got_raw = head(torch.from_numpy(pooled), weight_t)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), rtol=1e-4, atol=1e-5)
    norms = np.linalg.norm(got_pred.numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


@pytest.mark.parametrize("seed, ties", [(3, False), (4, True), (5, True)])
def test_nms_per_class_matches_jax(seed, ties):
    rng = np.random.RandomState(seed)
    rois = random_rois(rng, 24, 2, ties=ties)
    rois[5:9] = rois[4] + np.array([0, 0, 1, 1, 1, 1, 0], np.float32)  # overlapping twins
    valid = rng.rand(24) > 0.2
    want = jax_nms(jnp.asarray(rois), 0.5, jnp.asarray(valid))
    got = nms_per_class(torch.from_numpy(rois), 0.5, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() < valid.sum()  # something was suppressed


def test_box_iou_matches_jax():
    rng = np.random.RandomState(6)
    a = random_rois(rng, 7, 1)[:, 2:6]
    b = random_rois(rng, 5, 1)[:, 2:6]
    np.testing.assert_allclose(box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


def test_extract_detections_matches_jax():
    rng = np.random.RandomState(7)
    rois = random_rois(rng, 8, 1)
    init = rng.randn(8, 7).astype(np.float32)
    pred = rng.randn(8, 4 * C).astype(np.float32)
    pred[3] = 0.0  # falls back to the initial rotation
    valid = rng.rand(8) > 0.3
    valid[3] = True
    got = extract_detections(rois, init, pred, valid, C, with_indices=True)
    want = jax_extract(rois, init, pred, valid, C, with_indices=True)
    assert [d[0] for d in got] == [d[0] for d in want]
    assert [d[3] for d in got] == [d[3] for d in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
