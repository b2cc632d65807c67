"""Port: `utils/visualize.py`, the demo (`cli/demo.py`) and `test_icp
--visualize` against the JAX package on the CPU.

`overlay_label` is bit-exact, `project_box_corners` within 1e-3 px and
`draw_detections` equal on the same detections. The demo runs on two
480×640 frames rendered in the demo's format, with one checkpoint in
both packages (the JAX model on its coarse-to-fine Pallas backend, as the
port's Hough is c2f): the same frames, labels and classes, the network
poses within 1e-4 (the port without `--refine` against the JAX run's
`*_init` poses, and with it). ICP is held by tests/test_torch_icp.py's
scene rule: with seeded random weights the predicted masks are scattered,
so every hypothesis starts with few valid points, and after eight
iterations a last-bit difference has moved some of them elsewhere in each
package (that file's docstring). So each ICP call's inputs (initial pose,
model points, depth, predicted mask, intrinsics) are recorded in both
demos and must agree, one iteration on them must agree within ATOL_STEP
(the rule's first clause), and `detections.json` must hold what the
port's ICP returns on its inputs. `test_icp --visualize` writes the files
the JAX CLI writes, equal in nearly every pixel.
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import posecnn_tpu.models as jax_models
from posecnn_tpu.cli import demo as jax_demo
from posecnn_tpu.cli import test_icp as jax_test_icp
from posecnn_tpu.refine import icp as jax_icp
from posecnn_tpu.utils import visualize as jvis
from posecnn_torch.cli import demo, test_icp
from posecnn_torch.core.checkpoint import save_params
from posecnn_torch.data.datasets import YCB_CLASS_COLORS
from posecnn_torch.data.fabricate import write_demo_frames
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.refine.icp import icp_refine_batch
from posecnn_torch.utils import visualize as tvis

torch.set_num_threads(1)
ATOL_STEP, ATOL_RT = 1e-4, 2e-3  # tests/test_torch_icp.py
SMALL = ["--set", "compute_dtype=float32", "train.num_units=16", "train.fc_dim=64",
         "test.hough_num_samples=128"]
K = np.array([[500.0, 0, 48.0], [0, 500.0, 32.0], [0, 0, 1]], np.float32)


def detections(rng, n=4):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
                  rng.uniform(0.4, 0.8, n)], 1).astype(np.float32)
    return [(int(c), q[i], t[i]) for i, c in enumerate(rng.randint(1, 5, n))]


def test_overlay_label_is_bit_exact():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    label = rng.randint(0, 23, (64, 96))  # 22 out of range: clipped to the last colour
    for alpha in (0.5, 0.3):
        got = tvis.overlay_label(img, label, YCB_CLASS_COLORS, alpha)
        np.testing.assert_array_equal(got, jvis.overlay_label(img, label, YCB_CLASS_COLORS,
                                                              alpha))
    np.testing.assert_array_equal(tvis.label_to_color(label, YCB_CLASS_COLORS),
                                  jvis.label_to_color(label, YCB_CLASS_COLORS))


def test_box_corners_and_drawings_match_jax():
    rng = np.random.RandomState(1)
    extents = rng.uniform(0.05, 0.2, (5, 3)).astype(np.float32)
    dets = detections(rng)
    for cls, q, t in dets:
        np.testing.assert_allclose(tvis.project_box_corners(q, t, extents[cls], K),
                                   jvis.project_box_corners(q, t, extents[cls], K),
                                   rtol=0, atol=1e-3)
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    names = [f"class {i}" for i in range(5)]
    for kw in ({}, {"class_colors": YCB_CLASS_COLORS[:5], "class_names": names}):
        np.testing.assert_array_equal(tvis.draw_detections(img, dets, extents, K, **kw),
                                      jvis.draw_detections(img, dets, extents, K, **kw))


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Two demo frames, one checkpoint; the JAX demo with --refine, the
    port's with and without it."""
    root = tmp_path_factory.mktemp("demo")
    images = str(root / "images")
    write_demo_frames(images, 2)
    ckpt = str(root / "ckpt.npz")
    model = PoseCNN(22, num_units=16, fc_dim=64)
    init_weights(model, 0)
    save_params(ckpt, model, step=1, meta={"norm_features": True, "quat_activation": "linear",
                                          "pose_pool_size": 7})
    flags = ["--images", images, "--ckpt", ckpt, *SMALL]
    calls = {"jax": [], "port": []}  # each ICP call's inputs, as numpy

    def jax_recorder(quat, trans, pts, depth, mask, k, **kw):
        calls["jax"].append([np.asarray(a) for a in (quat, trans, pts, depth, mask, k)])
        return refine_pose_icp(quat, trans, pts, depth, mask, k, **kw)

    def port_recorder(*args, **kw):
        calls["port"].append([a.numpy() for a in args])
        return icp_refine_batch(*args, **kw)

    refine_pose_icp = jax_icp.refine_pose_icp
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_models, "PoseCNN", partial(jax_models.PoseCNN, hough_backend="pallas_c2f"))
    mp.setattr(jax_icp, "refine_pose_icp", jax_recorder)
    mp.setattr(demo, "icp_refine_batch", port_recorder)
    try:
        jax_demo.main(["--output", str(root / "jax"), "--refine", *flags])
        runs = {"jax": json.load(open(root / "jax" / "detections.json"))}
        for name, extra in (("port", []), ("port_refine", ["--refine"])):
            got = demo.main(["--device", "cpu", "--output", str(root / name), *extra, *flags])
            with open(root / name / "detections.json") as f:
                assert json.load(f) == json.loads(json.dumps(got))
            runs[name] = got
    finally:
        mp.undo()
    return root, runs, calls


def test_demo_matches_jax(demo_runs):
    root, runs, _ = demo_runs
    want = runs["jax"]
    assert [f["frame"] for f in runs["port"]] == [f["frame"] for f in want] == [
        "000000", "000001"]
    for name in ("port", "port_refine"):
        for i, frame in enumerate(runs[name]):
            np.testing.assert_array_equal(
                np.load(root / name / f"{frame['frame']}-label.npy"),
                np.load(root / "jax" / f"{frame['frame']}-label.npy"))
            assert os.path.exists(root / name / f"{frame['frame']}-overlay.png")
            assert [d["class"] for d in frame["detections"]] == [
                d["class"] for d in want[i]["detections"]]
    for frame, frame_r, frame_w in zip(runs["port"], runs["port_refine"], want):
        assert frame_w["detections"], frame_w["frame"]
        for d, dr, dw in zip(frame["detections"], frame_r["detections"], frame_w["detections"]):
            assert d["class_name"] == dw["class_name"]
            for got in (d["quat_wxyz"], dr["quat_wxyz_init"]):
                np.testing.assert_allclose(got, dw["quat_wxyz_init"], rtol=0, atol=1e-4)
            for got in (d["trans"], dr["trans_init"]):
                np.testing.assert_allclose(got, dw["trans_init"], rtol=0, atol=1e-4)


def test_demo_refinement_holds_the_scene_rule(demo_runs):
    _, runs, calls = demo_runs
    # one batched call a frame in the port, one call a detection in JAX
    assert len(calls["port"]) == len(runs["port_refine"])
    rows = [(args, i) for args in calls["port"] for i in range(args[0].shape[0])]
    assert len(rows) == len(calls["jax"]) > 0
    refined = [d for f in runs["port_refine"] for d in f["detections"]]
    for ((quats, transs, pts, depth, masks, k), i), want, det in zip(rows, calls["jax"], refined):
        np.testing.assert_allclose(quats[i], want[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(transs[i], want[1], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(pts[i], want[2])
        np.testing.assert_array_equal(depth, want[3])
        np.testing.assert_array_equal(masks[i], want[4])
        np.testing.assert_array_equal(k, want[5])
        one = icp_refine_batch(*(torch.from_numpy(a) for a in (
            want[0][None], want[1][None], want[2][None], want[3], want[4][None], want[5])),
            num_iters=1)
        jone = jax_icp.refine_pose_icp(*want, num_iters=1)
        np.testing.assert_allclose(one.quat[0].numpy(), np.asarray(jone.quat), rtol=0,
                                   atol=ATOL_STEP)
        np.testing.assert_allclose(one.trans[0].numpy(), np.asarray(jone.trans), rtol=0,
                                   atol=ATOL_STEP)
        res = icp_refine_batch(*(torch.from_numpy(a) for a in (quats, transs, pts, depth,
                                                                masks, k)))
        np.testing.assert_array_equal(det["quat_wxyz"], res.quat[i].numpy().tolist())
        np.testing.assert_array_equal(det["trans"], res.trans[i].numpy().tolist())


def test_test_icp_visualize_writes_what_jax_writes(tmp_path):
    """The same files; a scene's image bit-equal where all its refined
    poses agree with JAX's by the scene rule's ATOL_RT (their errors in
    icp_report.json within 0.1° and 2 mm; a chaotic hypothesis can move
    one, see above)."""
    from PIL import Image

    argv = ["--num_scenes", "2", "--visualize", "--set", "train.num_classes=4",
            "train.syn_height=96", "train.syn_width=128"]
    jax_test_icp.main(["--output", str(tmp_path / "jax"), *argv])
    got = test_icp.main(["--device", "cpu", "--output", str(tmp_path / "port"), *argv])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert files == ["000-refined.png", "001-refined.png", "icp_report.json"]
    with open(tmp_path / "jax" / "icp_report.json") as f:
        want = json.load(f)
    same = {}
    for g, w in zip(got["objects"], want["objects"]):
        agree = (abs(g["after"]["re"] - w["after"]["re"]) <= 0.1
                 and abs(g["after"]["te"] - w["after"]["te"]) <= ATOL_RT)
        same[g["scene"]] = same.get(g["scene"], True) and agree
    assert any(same.values())
    for scene, agree in same.items():
        a, b = (np.asarray(Image.open(tmp_path / d / f"{scene:03d}-refined.png"))
                for d in ("jax", "port"))
        assert a.shape == b.shape == (96, 128, 3)
        if agree:
            np.testing.assert_array_equal(b, a, err_msg=f"scene {scene}")
