"""Port: the segmentation and video families' entry points at toy size on the
CPU, against the JAX package.

- `train_net` with `network` fcn8 (an `rgbd_scene_single_*_fcn8.yaml`, on
  DEPTH input, which both trainers feed colour frames), resnet50_seg and
  recurrent_seg (`lov_color_rnn.yaml`) writes `metrics.jsonl` and a
  snapshot that the JAX `restore_params` fills its whole template from;
- `test_video` on one JAX-written `RecurrentSegNet` checkpoint gives the
  JAX CLI's `video_eval.json`: IoU and surface points equal, the tracked
  motion within 1e-4 m; on synthetic sequences and on real video frames
  (`--dataset ycb_video`, a fabricated moving-camera tree);
- `test_fusion` gives the JAX CLI's `fusion_report.json`: the counts and
  classes equal, the raycast depth error and label accuracy within 1e-5,
  the mesh area within 1e-6 m², the tracking translation errors within
  1e-4 m and the rotation errors within 0.01° (at this toy size the
  tracking does not converge, 2-8° off, and the raycast model depth's
  last bits move its iterates);
  and the `--visualize` images and `model.ply`;
- `test_net` raises on the segmentation and video families, naming
  `test_video` for the video one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.cli import test_fusion as jax_test_fusion
from posecnn_tpu.cli import test_video as jax_test_video
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.models import FCN8 as JaxFCN8
from posecnn_tpu.models import RecurrentSegNet as JaxRecurrentSegNet
from posecnn_tpu.models import ResNet50Seg as JaxResNet50Seg
from posecnn_torch.cli import test_fusion, test_net, test_video, train_net

torch.set_num_threads(1)
C, H, W, U, FC, T = 4, 48, 64, 8, 32, 3
CFGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                    "cfgs")
TOY = ["--set", f"train.num_classes={C}", f"train.syn_height={H}", f"train.syn_width={W}",
       f"train.fc_dim={FC}", f"train.num_units={U}", f"train.num_steps={T}", "train.display=1",
       "train.ims_per_batch=1"]
RUNS = {
    "fcn8": ("rgbd_scene_single_depth_fcn8.yaml", [],
             lambda: JaxFCN8(num_classes=C, fc_dim=FC, compute_dtype=jnp.float32),
             lambda m: m.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))),
    "resnet50_seg": ("rgbd_scene_single_color_fcn8.yaml", ["network=resnet50_seg"],
                     lambda: JaxResNet50Seg(num_classes=C, num_units=U, compute_dtype=jnp.float32),
                     lambda m: m.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))),
    "recurrent_seg": ("lov_color_rnn.yaml", [],
                      lambda: JaxRecurrentSegNet(num_classes=C, num_units=U),
                      lambda m: m.init(jax.random.PRNGKey(1), jnp.zeros((T, 1, H, W, 3)),
                                       jnp.ones((T, 1, H, W)), jnp.zeros((T, 1, 48)))),
}


@pytest.mark.parametrize("network", sorted(RUNS))
def test_train_net_writes_a_snapshot_jax_restores(network, tmp_path):
    yaml, extra, jax_model, jax_init = RUNS[network]
    out = tmp_path / network
    train_net.main(["--device", "cpu", "--iters", "2", "--output", str(out), "--cfg",
                    os.path.join(CFGS, yaml), *TOY, *extra])
    snaps = sorted(p for p in os.listdir(out) if p.endswith(".npz"))
    assert len(snaps) == 1 and snaps[0].endswith("_iter_2.npz")
    lines = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [x["iter"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) and x["loss"] > 0 for x in lines)
    template = jax_init(jax_model())
    restored, step = jckpt.restore_params(str(out / snaps[0]), template, verbose=False)
    assert step == 2
    data = np.load(out / snaps[0])
    flat = jckpt._flatten(restored)
    assert set(flat) == {k for k in data.files if not k.startswith("__")}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)


def test_test_video_matches_jax_on_one_checkpoint(tmp_path):
    model = RUNS["recurrent_seg"][2]()
    params = RUNS["recurrent_seg"][3](model)
    ckpt = str(tmp_path / "rnn_iter_1.npz")
    jckpt.save_params(ckpt, params, step=1)
    flags = ["--ckpt", ckpt, "--num_sequences", "2", "--num_steps", "3", "--grid_size", "48",
             "--cfg", os.path.join(CFGS, "lov_color_rnn.yaml"), *TOY, "train.syn_tnear=0.4",
             "train.syn_tfar=0.9"]
    jax_test_video.main(["--output", str(tmp_path / "jax"), *flags])
    got = test_video.main(["--device", "cpu", "--output", str(tmp_path / "port"), *flags])
    with open(tmp_path / "jax" / "video_eval.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "video_eval.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"seconds"}
        assert g["sequence"] == w["sequence"] and g["surface_points"] == w["surface_points"]
        assert g["mean_iou"] == w["mean_iou"]
        np.testing.assert_allclose(g["tracked_motion_m"], w["tracked_motion_m"], rtol=0,
                                   atol=1e-4)
        assert set(g["seconds"]) == set(test_video.STAGES)
    assert sum(g["surface_points"] for g in got) > 0


def test_test_video_on_real_frames_matches_jax(tmp_path):
    """`--dataset ycb_video` on a fabricated moving-camera tree (22 classes,
    48×64 frames, 4 frames a video): the real-video feed into both CLIs."""
    from posecnn_torch.data.fabricate import write_ycb_tree

    root = str(tmp_path / "lov")
    k = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    write_ycb_tree(root, sets=(("val", 6),), height=H, width=W, k=k, num_points=256,
                   video_length=4, moving_camera=True)
    model = JaxRecurrentSegNet(num_classes=22, num_units=U)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((T, 1, H, W, 3)),
                        jnp.ones((T, 1, H, W)), jnp.zeros((T, 1, 48)))
    ckpt = str(tmp_path / "rnn22_iter_1.npz")
    jckpt.save_params(ckpt, params, step=1)
    flags = ["--ckpt", ckpt, "--num_sequences", "2", "--num_steps", "3", "--grid_size", "48",
             "--dataset", "ycb_video", "--data_root", root, "--set", f"train.num_units={U}"]
    want = jax_test_video.main(["--output", str(tmp_path / "jax"), *flags])
    got = test_video.main(["--device", "cpu", "--output", str(tmp_path / "port"), *flags])
    for g, w in zip(got, want):
        assert g["mean_iou"] == w["mean_iou"] and g["surface_points"] == w["surface_points"]
        np.testing.assert_allclose(g["tracked_motion_m"], w["tracked_motion_m"], rtol=0,
                                   atol=1e-4)
    assert len(got) == 2 and sum(g["surface_points"] for g in got) > 0


def test_test_fusion_matches_jax(tmp_path):
    flags = ["--grid_size", "48", "--set", "train.num_classes=4", "train.syn_height=96",
             "train.syn_width=128", "train.syn_tnear=0.4", "train.syn_tfar=0.9"]
    jax_test_fusion.main(["--output", str(tmp_path / "jax"), *flags])
    got = test_fusion.main(["--device", "cpu", "--output", str(tmp_path / "port"), "--visualize",
                            *flags])
    with open(tmp_path / "jax" / "fusion_report.json") as f:
        want = json.load(f)
    for key in ("num_steps", "ply_faces", "grid_size", "surface_points", "surface_classes",
                "mesh_triangles"):
        assert got[key] == want[key], key
    assert got["surface_points"] > 0 and got["mesh_triangles"] > 0
    for key, tol in (("raycast_depth_mae_m", 1e-5), ("raycast_fg_label_acc", 1e-5),
                     ("mesh_area_m2", 1e-6), ("tracking_trans_err_m", 1e-4),
                     ("tracking_rot_err_deg", 1e-2)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=key)
    written = sorted(os.listdir(tmp_path / "port"))
    assert "model.ply" in written and "fusion_report.json" in written
    assert sum(p.endswith("-raycast-label.png") for p in written) == got["num_steps"]


@pytest.mark.parametrize("network,match", [
    ("fcn8", "posecnn and posecnn_det families only"),
    ("resnet50_seg", "posecnn and posecnn_det families only"),
    ("recurrent_seg", "test_video"),
])
def test_test_net_raises_on_the_seg_and_video_families(network, match):
    with pytest.raises(NotImplementedError, match=match):
        test_net.main(["--device", "cpu", "--cfg",
                       os.path.join(CFGS, "rgbd_scene_single_color_fcn8.yaml"), "--set",
                       f"network={network}"])
