"""Port parity: the evaluator. Each case of tests/test_evaluate.py but
`detection_ap` feeds the same detections, GTs and labels to the JAX
`PoseEvaluator` and the port's, and holds `summarize()` of the two
together: counts, success rates and seg IoU equal, the AUCs and mean
errors within 1e-5 (fp32 errors computed by two libraries); then the
case's own assertion on the port's summary.
"""

import numpy as np
import torch

from posecnn_tpu.engine import evaluate as jev
from posecnn_torch.engine import evaluate as tev

torch.set_num_threads(1)
Q_ID = np.array([1.0, 0, 0, 0], np.float32)


def assert_summaries_agree(got: dict, want: dict):
    assert set(got) == set(want)
    assert got["num_images"] == want["num_images"]
    assert got["seg_iou_per_class"] == want["seg_iou_per_class"]
    assert got["seg_mean_iou"] == want["seg_mean_iou"]
    for key in ("add_auc", "adds_auc"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    assert set(got["per_class"]) == set(want["per_class"])
    for cls, w in want["per_class"].items():
        g = got["per_class"][cls]
        assert set(g) == set(w), cls
        for key in ("count", "success_rate", "reproj_success_rate"):
            if key in w:
                assert g[key] == w[key], (cls, key)
        for key in ("add_auc", "adds_auc", "mean_rot_deg", "mean_trans_m"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{cls} {key}")


def both(images, seg=(), **kw):
    """Run the same images (list of (detections, gts)) and segmentation
    pairs through both evaluators; return the port's summary after
    holding it to the JAX one's."""
    ev_j, ev_t = jev.PoseEvaluator(**kw), tev.PoseEvaluator(**kw)
    for gt_label, pred in seg:
        ev_j.add_segmentation(gt_label, pred)
        ev_t.add_segmentation(gt_label, pred)
    for dets, gts in images:
        ev_j.add_image(dets, gts)
        ev_t.add_image(dets, gts)
    got = ev_t.summarize()
    assert_summaries_agree(got, ev_j.summarize())
    return got


def library(rng, c=3, p=40):
    pts = (rng.rand(c, p, 3).astype(np.float32) - 0.5) * 0.1
    return pts, np.abs(pts).max(1) * 2


def test_fast_hist_and_iou_match_jax(rng):
    gt = np.array([0, 0, 1, 1, 2, 2])
    pred = np.array([0, 1, 1, 1, 2, 0])
    np.testing.assert_array_equal(tev.fast_hist(gt, pred, 3), jev.fast_hist(gt, pred, 3))
    hist = tev.fast_hist(gt, pred, 3)
    np.testing.assert_allclose(tev.iou_from_hist(hist)[1], 2 / 3, atol=1e-6)
    gt, pred = rng.randint(-1, 5, 500), rng.randint(0, 5, 500)
    np.testing.assert_array_equal(tev.iou_from_hist(tev.fast_hist(gt, pred, 5)),
                                  jev.iou_from_hist(jev.fast_hist(gt, pred, 5)))


def test_perfect_predictions(rng):
    pts, ext = library(rng)
    t = np.array([0.1, 0.0, 1.0], np.float32)
    labels = [(rng.randint(0, 3, (6, 8)), rng.randint(0, 3, (6, 8))) for _ in range(2)]
    s = both([([(1, Q_ID, t)], [(1, Q_ID, t)])] * 4, seg=labels, num_classes=3, points=pts,
             extents=ext)
    assert s["per_class"][1]["success_rate"] == 1.0
    assert s["add_auc"] > 0.95


def test_instance_matching(rng):
    pts, ext = library(rng)
    t_a = np.array([-0.2, 0.0, 1.0], np.float32)
    t_b = np.array([0.25, 0.0, 1.1], np.float32)
    dets = [(1, Q_ID, t_a), (1, Q_ID, t_b)]
    gts = [(1, Q_ID, t_b), (1, Q_ID, t_a)]
    kw = dict(num_classes=3, points=pts, extents=ext)
    assert both([(dets, gts)], **kw)["per_class"][1]["success_rate"] == 0.5
    assert both([(dets, gts)], instance_matching=True, **kw)["per_class"][1]["success_rate"] == 1.0
    s2 = both([([(1, Q_ID, t_a)], gts)], instance_matching=True, **kw)
    assert s2["per_class"][1]["count"] == 2 and s2["per_class"][1]["success_rate"] == 0.5
    # a NaN translation (a degenerate box fit) matches nothing, the other still does
    nan_t = np.full(3, np.nan, np.float32)
    s3 = both([([(1, Q_ID, nan_t), (1, Q_ID, t_a)], gts)], instance_matching=True, **kw)
    assert s3["per_class"][1]["success_rate"] == 0.5


def test_missed_detection(rng):
    pts, ext = library(rng)
    t = np.array([0.0, 0.0, 1.0], np.float32)
    s = both([([], [(2, Q_ID, t)]), ([(2, Q_ID, t)], [(2, Q_ID, t)])], num_classes=3,
             points=pts, extents=ext)
    assert s["per_class"][2]["success_rate"] == 0.5


def test_symmetric_class_uses_adi():
    theta = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    ring = np.stack([0.05 * np.cos(theta), 0.05 * np.sin(theta), np.zeros(64)], 1)
    pts = np.stack([np.zeros((64, 3)), ring]).astype(np.float32)
    ext = np.abs(pts).max(1) * 2
    ang = 2 * np.pi / 64 * 7
    q_rot = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)], np.float32)
    t = np.array([0, 0, 1.0], np.float32)
    image = [([(1, q_rot, t)], [(1, Q_ID, t)])]
    kw = dict(num_classes=2, points=pts, extents=ext)
    assert both(image, symmetric_classes=(1,), **kw)["per_class"][1]["success_rate"] == 1.0
    assert both(image, **kw)["per_class"][1]["success_rate"] == 0.0


def test_extract_detections_match_jax():
    rois = np.zeros((3, 7), np.float32)
    rois[0, 1], rois[1, 1] = 2, 1
    init = np.zeros((3, 7), np.float32)
    init[:, 0] = 1.0
    init[0, 4:7] = [0.1, 0.2, 1.0]
    quats = np.zeros((3, 12), np.float32)
    quats[0, 8:12] = [0.0, 2.0, 0.0, 0.0]
    valid = np.array([True, False, False])
    got = tev.extract_detections(rois, init, quats, valid, 3)
    want = jev.extract_detections(rois, init, quats, valid, 3)
    assert len(got) == len(want) == 1 and got[0][0] == want[0][0] == 2
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[0][2], want[0][2])
    np.testing.assert_allclose(got[0][1], [0, 1, 0, 0], atol=1e-6)


def test_z_flip_class_recovers(rng):
    pts, ext = library(rng, c=2, p=60)
    q_flip = np.array([0.0, 0, 0, 1.0], np.float32)
    t = np.array([0, 0, 1.0], np.float32)
    image = [([(1, q_flip, t)], [(1, Q_ID, t)])]
    kw = dict(num_classes=2, points=pts, extents=ext)
    assert both(image, **kw)["per_class"][1]["success_rate"] == 0.0
    assert both(image, z_flip_classes=(1,), **kw)["per_class"][1]["success_rate"] == 1.0


def test_reproj_metric(rng):
    pts, ext = library(rng, c=2, p=60)
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    t = np.array([0, 0, 1.0], np.float32)
    t_off = t + np.array([0.05, 0, 0], np.float32)
    s = both([([(1, Q_ID, t)], [(1, Q_ID, t)]), ([(1, Q_ID, t_off)], [(1, Q_ID, t)])],
             num_classes=2, points=pts, extents=ext, intrinsics=k)
    assert s["per_class"][1]["reproj_success_rate"] == 0.5


def test_diameter_threshold(rng):
    pts, ext = library(rng, c=2, p=60)
    t = np.array([0, 0, 1.0], np.float32)
    t_off = t + np.array([0.005, 0, 0], np.float32)
    s = both([([(1, Q_ID, t_off)], [(1, Q_ID, t)])], num_classes=2, points=pts, extents=ext,
             diameters=np.array([0.0, 0.01], np.float32))
    assert s["per_class"][1]["success_rate"] == 0.0


def test_extract_detections_with_indices_pairing():
    rois = np.zeros((3, 7), np.float32)
    rois[0, 1], rois[0, 6] = 2, 0.2
    rois[1, 1], rois[1, 6] = 1, 0.9
    rois[2, 1], rois[2, 6] = 3, 0.5
    init = np.zeros((3, 7), np.float32)
    init[:, 0] = 1.0
    quats = np.zeros((3, 16), np.float32)
    valid = np.array([True, True, True])
    got = tev.extract_detections(rois, init, quats, valid, 4, with_indices=True)
    want = jev.extract_detections(rois, init, quats, valid, 4, with_indices=True)
    assert [i for *_, i in got] == [i for *_, i in want] == [1, 2, 0]


def test_summary_sample_sizes_and_table(rng):
    pts, ext = library(rng)
    q = np.array([0.9, 0.1, 0.3, 0.2], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.1, 0.0, 1.0], np.float32)
    noisy = [([(1, q, t + 0.01 * i)], [(1, Q_ID, t), (2, Q_ID, t)]) for i in range(5)]
    s = both(noisy, num_classes=3, points=pts, extents=ext)
    assert s["num_images"] == 5
    assert s["per_class"][1]["count"] == 5 and s["per_class"][2]["count"] == 5
    names = ["bg", "cls_one", "cls_two"]
    table = tev.format_per_class_table(s, names)
    # the same report as the JAX package's on the same summary
    assert table == jev.format_per_class_table(s, names)
    assert "cls_one" in table and "ALL" in table
