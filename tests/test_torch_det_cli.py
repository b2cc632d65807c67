"""Port: the detection family's entry points at toy size on the CPU
(`train_net` and `test_net` with `network=posecnn_det`) and
`detection_ap`, against the JAX package.

`detection_ap` equals JAX's on hand-made lists. The port's `train_net`
writes a snapshot the JAX `restore_params` fills its whole template from.
Both packages' `test_net` evaluate one JAX-written checkpoint on the same
held-out renders: `eval_det.json`'s mAP and per-class AP equal, the pose
AUCs and the mean translation error within 1e-4, each class's mean
rotation and translation errors within 1e-5 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.cli import test_net as jax_test_net
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.engine.evaluate import detection_ap as jax_detection_ap
from posecnn_tpu.models.detection import PoseCNNDet as JaxPoseCNNDet
from posecnn_torch.cli import test_net, train_net
from posecnn_torch.engine.evaluate import detection_ap

torch.set_num_threads(1)
C, H, W = 4, 64, 96
TOY = ["--set", "network=posecnn_det", "compute_dtype=float32", f"train.num_classes={C}",
       f"train.syn_height={H}", f"train.syn_width={W}", "train.fc_dim=32",
       "anchor_scales=[1,2,4]", "anchor_ratios=[0.5,1.0,2.0]", "train.rpn_post_nms_top_n=16",
       "train.rpn_pre_nms_top_n=100", "train.batch_size=16", "train.rpn_batchsize=32",
       "test.rpn_post_nms_top_n=16", "test.rpn_pre_nms_top_n=100", "train.add_num_points=32",
       "train.display=1"]


def test_detection_ap_matches_jax():
    """Equal scores across images and within one, a class with GTs and
    no detections, one without GTs, duplicates of one box, a miss."""
    b1, b2 = (10.0, 10.0, 40.0, 40.0), (50.0, 20.0, 80.0, 60.0)
    all_gts = [[(1, b1), (2, b2)], [(1, b2), (3, b1)], [(1, b1), (1, b2)]]
    all_dets = [
        [(1, 0.9, b1), (1, 0.9, b1), (2, 0.5, (52.0, 22.0, 78.0, 58.0)), (4, 0.7, b2)],
        [(1, 0.9, (11.0, 9.0, 41.0, 39.0)), (1, 0.6, b2), (2, 0.4, b1)],
        [(1, 0.6, b2), (1, 0.3, (0.0, 0.0, 5.0, 5.0)), (1, 0.3, b1)],
    ]
    for thr in (0.5, 0.75):
        want = jax_detection_ap(all_dets, all_gts, 5, iou_threshold=thr)
        got = detection_ap(all_dets, all_gts, 5, iou_threshold=thr)
        assert got == want
    assert set(got["per_class"]) == {1, 2, 3} and got["per_class"][3] == 0.0
    assert detection_ap([[]], [[]], 3) == jax_detection_ap([[]], [[]], 3) == {
        "map": 0.0, "per_class": {}}


def test_train_net_det_writes_a_snapshot_jax_restores(tmp_path):
    out = tmp_path / "det"
    train_net.main(["--device", "cpu", "--iters", "2", "--output", str(out), *TOY])
    snaps = sorted(p for p in os.listdir(out) if p.endswith(".npz"))
    assert snaps == ["posecnn_iter_2.npz"]
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["iter"] for x in lines] == [1, 2]
    for x in lines:
        assert {"rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss_pose", "loss",
                "lr"} <= set(x)
        assert np.isfinite([x[k] for k in ("loss", "rpn_box", "rcnn_box")]).all()
    jmodel = JaxPoseCNNDet(num_classes=C, anchor_scales=(1, 2, 4), anchor_ratios=(0.5, 1.0, 2.0),
                           fc_dim=32, compute_dtype=jnp.float32)
    template = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), train=False)
    restored, step = jckpt.restore_params(str(out / snaps[0]), template, verbose=False)
    assert step == 2
    data = np.load(out / snaps[0])
    flat = jckpt._flatten(restored)
    assert set(flat) == {k for k in data.files if not k.startswith("__")}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)


@pytest.fixture(scope="module")
def det_ckpt(tmp_path_factory):
    """A JAX-written detection checkpoint at the toy size."""
    path = str(tmp_path_factory.mktemp("det_ckpt") / "det_iter_1.npz")
    jmodel = JaxPoseCNNDet(num_classes=C, anchor_scales=(1, 2, 4), anchor_ratios=(0.5, 1.0, 2.0),
                           fc_dim=32, compute_dtype=jnp.float32)
    params = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, H, W, 3)), train=False))(
        jax.random.PRNGKey(2))
    jckpt.save_params(path, params, step=1)
    return path


def test_test_net_det_matches_jax_on_one_checkpoint(det_ckpt, tmp_path):
    flags = ["--num_images", "3", "--ckpt", det_ckpt, *TOY]
    jax_test_net.main(["--output", str(tmp_path / "jax"), *flags])
    got = test_net.main(["--device", "cpu", "--output", str(tmp_path / "port"), *flags])
    with open(tmp_path / "jax" / "eval_det.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "eval_det.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    got = json.loads(json.dumps(got))
    assert got["map"] == want["map"] and got["per_class"] == want["per_class"]
    assert got["run"]["detections"] > 0 and len(want["per_class"]) > 0
    np.testing.assert_allclose(got["mean_trans_err_m"], want["mean_trans_err_m"], rtol=0,
                               atol=1e-4)
    gp, wp = got["pose"], want["pose"]
    for key in ("add_auc", "adds_auc"):
        np.testing.assert_allclose(gp[key], wp[key], rtol=0, atol=1e-4, err_msg=key)
    assert set(gp["per_class"]) == set(wp["per_class"])
    for cls, w in wp["per_class"].items():
        g = gp["per_class"][cls]
        assert g["count"] == w["count"] and g["success_rate"] == w["success_rate"], cls
        for key in ("add_auc", "adds_auc"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4, err_msg=f"{cls} {key}")
        for key in ("mean_rot_deg", "mean_trans_m"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"{cls} {key}")
    assert set(got["run"]["seconds"]) == set(test_net.DET_STAGES)
