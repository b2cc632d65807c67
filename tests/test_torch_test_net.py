"""Port: the evaluation entry points (posecnn_torch.cli.test_net and
cli.test_icp) at toy size on the CPU, and the cross-package check.

One checkpoint written by the port's `save_params` (the JAX `.npz`
layout) at tests/test_cli_e2e.py's TINY size is evaluated by both
packages' `test_net` on the same held-out seed, 2 images, with ICP
(`--refine`). Their `eval.json`s must agree: the seg IoU of every class
(the histograms) and each class's GT count, success rate and
reprojection success equal; the AUCs and mean errors within 1e-3. ICP's
inlier gate can move one model point between the packages
(tests/test_torch_icp.py), which moves a refined pose by up to 2e-3; on
these frames they agree to 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from posecnn_tpu.cli import test_net as jax_test_net
from posecnn_torch.cli import test_icp, test_net
from posecnn_torch.core.checkpoint import save_params
from posecnn_torch.models.posecnn import PoseCNN, init_weights

torch.set_num_threads(1)
TINY = ["--set", "compute_dtype=float32", "train.num_classes=4", "train.num_units=16",
        "train.fc_dim=64", "train.syn_width=64", "train.syn_height=48",
        "train.add_num_points=32", "test.hough_num_samples=64"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "toy_iter_1.npz")
    model = PoseCNN(4, num_units=16, fc_dim=64)
    init_weights(model, 0)
    save_params(path, model, step=1, meta={"norm_features": True, "quat_activation": "linear",
                                          "pose_pool_size": 7})
    return path


def run_port(out, ckpt, *extra):
    return test_net.main(["--device", "cpu", "--num_images", "2", "--output", str(out),
                          "--ckpt", ckpt, *extra, *TINY])


def read(out):
    with open(os.path.join(out, "eval.json")) as f:
        return json.load(f)


def test_test_net_matches_jax_on_one_checkpoint(ckpt, tmp_path):
    jax_test_net.main(["--dataset", "synthetic", "--data_root", "/nonexistent",
                       "--backgrounds", "", "--num_images", "2", "--refine",
                       "--output", str(tmp_path / "jax"), "--ckpt", ckpt, *TINY])
    run_port(tmp_path / "port", ckpt, "--refine")
    want, got = read(tmp_path / "jax"), read(tmp_path / "port")
    assert got["num_images"] == want["num_images"] == 2
    assert got["seg_iou_per_class"] == want["seg_iou_per_class"]
    assert got["seg_mean_iou"] == want["seg_mean_iou"]
    assert set(got["per_class"]) == set(want["per_class"])
    for cls, w in want["per_class"].items():
        g = got["per_class"][cls]
        for key in ("count", "success_rate", "reproj_success_rate"):
            assert g[key] == w[key], (cls, key)
        for key in ("add_auc", "adds_auc", "mean_rot_deg", "mean_trans_m"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-3, err_msg=f"{cls} {key}")
    for key in ("add_auc", "adds_auc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
    run = got["run"]
    # something was detected and refined, so the comparison covered ICP
    assert run["device"] == "cpu" and run["detections"] > 0 and run["refined"] == run["detections"]
    assert set(run["seconds"]) == set(test_net.STAGES)


def test_test_net_ransac_and_save_results(ckpt, tmp_path):
    plain = run_port(tmp_path / "plain", ckpt, "--save_results")
    summary = run_port(tmp_path / "ransac", ckpt, "--ransac", "--save_results")
    for out in ("plain", "ransac"):
        files = sorted(f for f in os.listdir(tmp_path / out) if f.startswith("results_"))
        assert files == ["results_0000.npz", "results_0001.npz"]
    a = np.load(tmp_path / "plain" / "results_0000.npz")
    b = np.load(tmp_path / "ransac" / "results_0000.npz")
    assert a["label"].shape == (48, 64) and a["rois"].shape[1] == 7
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_array_equal(a["classes"], b["classes"])
    assert len(b["classes"]) > 0 and np.isfinite(b["poses"]).all()
    # the rotation is the network's either way; the translation is RANSAC's
    np.testing.assert_array_equal(a["poses"][:, :4], b["poses"][:, :4])
    assert not np.array_equal(a["poses"][:, 4:], b["poses"][:, 4:])
    assert summary["seg_iou_per_class"] == plain["seg_iou_per_class"]


def test_test_icp_reduces_translation_error(tmp_path):
    summary = test_icp.main(["--device", "cpu", "--output", str(tmp_path), "--num_scenes", "2",
                             "--set", "train.num_classes=4", "train.syn_height=96",
                             "train.syn_width=128"])
    assert os.path.exists(tmp_path / "icp_report.json")
    assert summary["num_objects"] >= 2
    assert summary["mean_te_after_cm"] < summary["mean_te_before_cm"]
    for obj in summary["objects"]:
        assert np.isfinite([obj["after"]["re"], obj["after"]["te"]]).all()


@pytest.mark.parametrize("argv, error, match", [
    (["--set", "network=fcn8"], NotImplementedError, "posecnn and posecnn_det families only"),
    (["--dataset", "coco"], ValueError, "unknown --dataset"),
    (["--set", "input=RGBX"], ValueError, "RGBX"),
])
def test_unsupported_test_net_branches_raise_naming_their_roadmap_item(argv, error, match):
    """test_net evaluates the posecnn and detection families only (the
    detection family: tests/test_torch_det_cli.py; the segmentation and
    video families raise, as tests/test_torch_seg_cli.py checks); an
    unknown dataset or input mode is an error (the dataset branches and
    the other inputs run: tests/test_torch_real_cli.py)."""
    with pytest.raises(error, match=match):
        test_net.main(["--device", "cpu", *argv])


def test_a_data_root_with_models_raises(tmp_path):
    """The name dates from before the dataset branches: a `--data_root`
    holding `models/` no longer raises, and the synthetic evaluation takes
    its YCB-Video geometry, as the JAX test_net does."""
    from posecnn_torch.cli.common import class_geometry
    from posecnn_torch.data.fabricate import write_ycb_tree

    write_ycb_tree(str(tmp_path), sets=(), num_points=64)
    args = test_net.make_parser().parse_args(["--data_root", str(tmp_path)])
    geo = class_geometry(args, test_net.load_config(args), False, 3)
    assert geo.num_classes == 22 and geo.ds is not None and geo.extents[1:].min() > 0
    assert geo.points.shape == (22, 2620, 3) and np.abs(geo.points[1:]).max() > 0


def test_backgrounds_that_match_nothing_raise(ckpt, tmp_path):
    with pytest.raises(FileNotFoundError):
        run_port(tmp_path, ckpt, "--backgrounds", str(tmp_path / "none_*.png"))


def test_test_icp_visualize_raises(tmp_path):
    """The name dates from before `utils/visualize.py`: `--visualize` no
    longer raises, and writes each scene's refined boxes (compared with
    the JAX CLI's in tests/test_torch_demo.py)."""
    test_icp.main(["--device", "cpu", "--visualize", "--output", str(tmp_path),
                   "--num_scenes", "1", "--set", "train.num_classes=4", "train.syn_height=48",
                   "train.syn_width=64"])
    assert os.path.exists(tmp_path / "000-refined.png")


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_net.main(["--num_images", "1"])
