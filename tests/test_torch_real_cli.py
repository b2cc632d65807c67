"""Port: the real-frame entry points at toy size on the CPU, on dataset
trees written in the reference's formats (`data/fabricate.py`): a
YCB-Video tree of 480×640 frames, read at `scales_base` 0.1 (48×64), and a
LINEMOD tree (extents and image sets; its object cloud is a stand-in at
the real extents).

- `train_net --dataset lov` for 2 steps, the real and synthetic streams
  1 : 1 (the synthetic scenes posed from the tree's pose bank), RGBD with
  chromatic jitter and noise: finite losses, metrics and a snapshot; a
  step of DEPTH and of NORMAL input; the pose bank asked for without a
  dataset raises;
- `--resume`: the newest snapshot restored, the step continued, the
  optimizer fresh as the JAX CLI leaves it (count 0, Adam's `step` 0)
  with `train.lr_step_offset` at the restored step, and the learning rate
  on the global step's staircase, as JAX's schedule gives it;
- `test_net --dataset lov` (COLOR, DEPTH, and RGBD with ICP), `--dataset
  linemod` (with ICP, LINEMOD's diameters, intrinsics and z-flip class)
  and NORMAL input on rendered frames, each on one checkpoint: the port's
  `eval.json` against the JAX `test_net`'s, as tests/test_torch_test_net.py
  holds the synthetic one: seg IoUs, GT counts and success rates equal,
  AUCs and mean errors within 1e-3. Both vote with coarse-to-fine Hough:
  the port's "auto" backend is c2f on every device, the JAX package's is
  its dense XLA reduction on the CPU, and the two may pick different
  maxima where the coarse pass misses the exhaustive one (a 48×64 NORMAL
  frame with random weights does), so the JAX side runs "pallas_c2f" (in
  interpret mode), whose rows the port's c2f equals
  (tests/test_torch_hough.py);
- `serve --data_root` takes the dataset's class geometry.
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import posecnn_tpu.models as jax_models
from posecnn_tpu.cli import test_net as jax_test_net
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.engine.train import lr_schedule as jax_lr_schedule
from posecnn_torch.cli import serve, test_net, train_net
from posecnn_torch.core.checkpoint import save_params
from posecnn_torch.data.datasets import YCBVideoDataset
from posecnn_torch.data.fabricate import write_linemod_tree, write_ycb_tree
from posecnn_torch.models.posecnn import PoseCNN, init_weights

torch.set_num_threads(1)
SMALL = ["train.fc_dim=32", "train.num_units=8", "train.hough_num_samples=64",
         "test.hough_num_samples=64", "train.add_num_points=64", "compute_dtype=float32"]
TRAIN = ["train.scales_base=[0.1]", "train.display=1", "train.snapshot_iters=2",
         "train.synthesize=True", "train.syn_ratio=1", "train.chromatic=True",
         "train.add_noise=True", "train.stepsize=3", "train.gamma=0.1",
         "train.learning_rate=0.001", "train.gt_pose_rois=True", "train.snapshot_prefix=toy",
         "train.vertex_reg_2d=True", "train.pose_reg=True", "train.ims_per_batch=2",
         "train.syn_sample_pose=True"]
TEST = ["test.scales_base=[0.1]"]


@pytest.fixture(scope="module")
def lov(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lov"))
    write_ycb_tree(root, sets=(("train", 2), ("val", 2)), num_points=512)
    return root


def run_train(root, out, iters, *extra):
    argv = ["--device", "cpu", "--dataset", "lov", "--data_root", root, "--iters", str(iters),
            "--output", str(out), *extra, "--set", "input=RGBD", *SMALL, *TRAIN]
    args = train_net.make_parser().parse_args(argv)
    return train_net.main_run(args, train_net.load_config(args), iters), args


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(lov, tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    state, _ = run_train(lov, out, 2)
    return out, state


def test_train_net_on_dataset_frames(trained):
    out, state = trained
    assert state.step == 2
    metrics = read_jsonl(out / "metrics.jsonl")
    assert [m["iter"] for m in metrics] == [1, 2]
    for m in metrics:
        assert {"loss", "loss_cls", "loss_vertex", "loss_pose"} <= set(m)
        assert all(np.isfinite(v) for v in m.values())
    assert os.path.exists(out / "toy_iter_2.npz")


def test_the_real_feed_alternates_streams_and_makes_rgbd_blobs(lov, tmp_path):
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--dataset", "lov", "--data_root", lov, "--output", str(tmp_path),
         "--set", "input=RGBD", *SMALL, *TRAIN])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    try:
        assert len(tr.batches.workers) == 1  # the real-frame feed's one producer
        real, syn = next(tr.batches), next(tr.batches)
    finally:
        tr.batches.close()
    for b in (real, syn):
        assert b["data"].shape == b["data_p"].shape == (2, 48, 64, 3)
        assert b["data"].dtype == torch.float32 and "vertex_centers" in b
    # the real stream's GT is the frames' (index 0 and 1 of the train set)
    ds = YCBVideoDataset(lov, "train")
    classes = sorted(int(c) for i in ds.image_index for c in ds.load_frame(i)["cls_indexes"])
    assert sorted(real["gt_poses"][real["gt_valid"], 1].int().tolist()) == classes


@pytest.mark.parametrize("mode", ["DEPTH", "NORMAL"])
def test_train_net_on_depth_and_normal_input(lov, tmp_path, mode):
    argv = ["--device", "cpu", "--dataset", "lov", "--data_root", lov, "--iters", "2",
            "--output", str(tmp_path), "--set", f"input={mode}", *SMALL, *TRAIN]
    args = train_net.make_parser().parse_args(argv)
    tr = train_net.build_trainer(args, train_net.load_config(args))
    try:
        real, syn = next(tr.batches), next(tr.batches)
    finally:
        tr.batches.close()
    assert tr.model.input_format == "COLOR" and tr.model.seg_head.score_conv4.in_channels == 512
    for b in (real, syn):
        assert "data_p" not in b and b["data"].shape == (2, 48, 64, 3)
    means = torch.tensor([102.9801, 115.9465, 122.7717])
    if mode == "DEPTH":  # tile3(depth / max · 255) − means: the three channels carry one map
        gray = syn["data"] + means
        assert torch.allclose(gray[..., 0], gray[..., 2], atol=1e-3)
        assert float(gray.max()) == pytest.approx(255.0, abs=1e-3)
    state = train_net.main_run(args, train_net.load_config(args), 2)
    assert state.step == 2
    assert all(np.isfinite(v) for m in read_jsonl(tmp_path / "metrics.jsonl") for v in m.values())


def test_sample_pose_without_a_dataset_raises(tmp_path):
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--output", str(tmp_path), "--set", "train.syn_sample_pose=True",
         "train.vertex_reg_2d=True", "train.pose_reg=True"])
    with pytest.raises(ValueError, match="pose bank"):
        train_net.build_trainer(args, train_net.load_config(args))


def test_resume_restores_the_step_and_the_lr_staircase(lov, trained, tmp_path):
    out, _ = trained
    import shutil

    resumed = tmp_path / "resume"
    shutil.copytree(out, resumed)
    state, args = run_train(lov, resumed, 4, "--resume")
    assert args.ckpt == str(resumed / "toy_iter_2.npz")
    # the step continued from 2; the optimizer's count from 0 (2 updates)
    assert state.step == 4 and state.opt.count == 2
    metrics = read_jsonl(resumed / "metrics.jsonl")
    assert [m["iter"] for m in metrics] == [1, 2, 3, 4]
    # staircase of stepsize 3 on the global step: steps 2 and 3 (logged as
    # 3, 4), applied at counts 0 and 1 with lr_step_offset 2
    jcfg = jax_cfg_from_dict({"train": {"learning_rate": 0.001, "stepsize": 3, "gamma": 0.1,
                                        "lr_step_offset": 2}})
    want = [float(jax_lr_schedule(jcfg)(count)) for count in (0, 1)]
    np.testing.assert_allclose([m["lr"] for m in metrics[2:]], want, rtol=1e-6)
    np.testing.assert_allclose([state.opt.schedule(count) for count in (0, 1)], want, rtol=1e-6)
    assert want[1] == pytest.approx(want[0] * 0.1)
    # an Adam run resumes fresh: count 0, every parameter's step 0, zero
    # moments, the offset at the snapshot's step
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--dataset", "lov", "--data_root", lov, "--output", str(out),
         "--resume", "--set", "input=RGBD", "train.optimizer=adam", *SMALL, *TRAIN])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    tr.batches.close()
    assert tr.state.step == tr.cfg.train.lr_step_offset == 2 and tr.state.opt.count == 0
    assert all(not t.any() for t in tr.state.state_tensors())  # steps and moments


def test_resume_without_snapshots_starts_fresh(lov, tmp_path):
    state, args = run_train(lov, tmp_path, 1, "--resume")
    assert args.ckpt is None and state.step == 1


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded random weights in the JAX layout: 22 classes COLOR and RGBD,
    and LINEMOD's 2 classes."""
    d = tmp_path_factory.mktemp("ckpt")
    meta = {"norm_features": True, "quat_activation": "linear", "pose_pool_size": 7,
            "orient_paint": False, "paint_version": 3}
    out = {}
    for name, c, fmt in (("COLOR", 22, "COLOR"), ("RGBD", 22, "RGBD"), ("linemod", 2, "COLOR"),
                         ("synthetic", 4, "COLOR")):
        model = PoseCNN(c, num_units=8, fc_dim=32, input_format=fmt)
        init_weights(model, 3)
        out[name] = str(d / f"{name}_iter_1.npz")
        save_params(out[name], model, step=1, meta=meta)
    return out


def read(out):
    with open(os.path.join(out, "eval.json")) as f:
        return json.load(f)


def assert_summaries_agree(got, want):
    assert got["num_images"] == want["num_images"] == 2
    assert got["seg_iou_per_class"] == want["seg_iou_per_class"]
    assert set(got["per_class"]) == set(want["per_class"])
    for cls, w in want["per_class"].items():
        g = got["per_class"][cls]
        assert set(g) == set(w)
        for key in ("count", "success_rate", "reproj_success_rate"):
            if key in w:
                assert g[key] == w[key], (cls, key)
        for key in ("add_auc", "adds_auc", "mean_rot_deg", "mean_trans_m"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-3, err_msg=f"{cls} {key}")
    for key in ("add_auc", "adds_auc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)


CASES = {
    "lov_color": (["--dataset", "lov"], "COLOR", []),
    "lov_rgbd_refine": (["--dataset", "lov", "--refine"], "RGBD", ["input=RGBD"]),
    "lov_depth": (["--dataset", "lov"], "COLOR", ["input=DEPTH"]),
    "linemod_refine": (["--dataset", "linemod", "--cls", "eggbox", "--image_set", "test",
                        "--refine"], "linemod",
                       ["train.num_classes=2", "train.syn_height=480", "train.syn_width=640"]),
    "synthetic_normal": (["--dataset", "synthetic"], "synthetic",
                         ["input=NORMAL", "train.num_classes=4", "train.syn_height=480",
                          "train.syn_width=640"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_test_net_on_datasets_matches_jax(case, lov, ckpts, tmp_path, monkeypatch):
    argv, ckpt, sets = CASES[case]
    root = lov if argv[1] == "lov" else str(tmp_path / "none")
    if argv[1] == "linemod":
        root = str(tmp_path / "linemod")
        os.makedirs(root)
        write_linemod_tree(root, "eggbox", num_points=512)
    flags = [*argv, "--data_root", root, "--num_images", "2", "--ckpt", ckpts[ckpt]]
    overrides = ["--set", *SMALL, *TEST, *sets]
    monkeypatch.setattr(jax_models, "PoseCNN",
                        partial(jax_models.PoseCNN, hough_backend="pallas_c2f"))
    jax_test_net.main([*flags, "--backgrounds", "", "--output", str(tmp_path / "jax"),
                       *overrides])
    got = test_net.main(["--device", "cpu", "--output", str(tmp_path / "port"), *flags,
                         *overrides])
    want = read(tmp_path / "jax")
    assert_summaries_agree(read(tmp_path / "port"), want)
    run = got["run"]
    assert run["device"] == "cpu" and run["detections"] > 0
    assert set(run["seconds"]) == set(test_net.STAGES)
    if "--refine" in argv:
        assert run["refined"] == run["detections"]
    if case == "linemod_refine":
        assert "reproj_success_rate" in want["per_class"]["1"]
    elif argv[1] == "lov":
        assert len(got["seg_iou_per_class"]) == 22


def test_serve_takes_the_dataset_class_geometry(lov):
    args = serve.make_parser().parse_args(
        ["--device", "cpu", "--data_root", lov, "--height", "48", "--width", "64",
         "--set", "train.fc_dim=32", "train.num_units=8", "test.hough_num_samples=64"])
    engine = serve.build_engine(args)
    ds = YCBVideoDataset(lov, "train", num_points=512)
    np.testing.assert_array_equal(engine._extents.numpy(), ds.extents)


def test_data_flags_come_from_the_checkpoint(ckpts, tmp_path):
    """The paint flags follow the checkpoint's metadata, as the JAX
    `data_flags_from_ckpt` has them; a 'False' string reads as False."""
    from posecnn_tpu.cli.common import data_flags_from_ckpt as jax_flags
    from posecnn_torch.cli.common import data_flags_from_ckpt

    cfg = train_net.load_config(train_net.make_parser().parse_args(
        ["--set", "train.orient_paint=True", "train.paint_version=4"]))
    jcfg = jax_cfg_from_dict({"train": {"orient_paint": True, "paint_version": 4}})
    assert data_flags_from_ckpt(cfg, None) == jax_flags(jcfg, None) == {
        "orient_detail": True, "paint_version": 4}
    assert data_flags_from_ckpt(cfg, ckpts["COLOR"]) == jax_flags(jcfg, ckpts["COLOR"]) == {
        "orient_detail": False, "paint_version": 3}
    path = str(tmp_path / "str_iter_1.npz")
    model = PoseCNN(2, num_units=8, fc_dim=32)
    save_params(path, model, meta={"orient_paint": "False"})
    assert data_flags_from_ckpt(cfg, path)["orient_detail"] is False
