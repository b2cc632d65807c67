"""Port parity: the inspection CLIs `check_data`, `test_synthesis` and
`render_poses` against the JAX CLIs on the CPU, on the same cfg and seed.

The JAX side is called through its `main` with its own flags (these CLIs
take no `--backgrounds`, so the F1 default does not reach them).

- `check_data`: every image equal, `NNN-vertex.png` too: both generators
  compute the centre directions in their C++ loops (`data/native.py`);
- `test_synthesis`: the report equal but for `scenes_per_sec` (a host
  rate), and the saved images equal;
- `render_poses`: on the port's own artifacts, `test_net --save_results`'s
  `results_NNNN.npz` (label maps as the images) and the demo's
  `detections.json` and `-label.npy` (with and without `--images`), the
  renderings equal to the JAX CLI's.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from posecnn_tpu.cli import check_data as jax_check_data
from posecnn_tpu.cli import render_poses as jax_render_poses
from posecnn_tpu.cli import test_synthesis as jax_test_synthesis
from posecnn_torch.cli import check_data, demo, render_poses, test_net, test_synthesis
from posecnn_torch.core.checkpoint import save_params
from posecnn_torch.data.fabricate import write_demo_frames, write_ycb_tree
from posecnn_torch.models.posecnn import PoseCNN, init_weights

torch.set_num_threads(1)
TINY = ["--set", "train.num_classes=4", "train.syn_width=80", "train.syn_height=60"]
CPU = ["--device", "cpu"]


def images(out):
    return {f: np.asarray(Image.open(os.path.join(out, f))) for f in sorted(os.listdir(out))
            if f.endswith(".png")}


def test_check_data_writes_what_jax_writes(tmp_path):
    jax_check_data.main(["--num_samples", "2", "--output", str(tmp_path / "jax"), *TINY])
    check_data.main([*CPU, "--num_samples", "2", "--output", str(tmp_path / "port"), *TINY])
    want, got = images(tmp_path / "jax"), images(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) == 10
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_test_synthesis_reports_what_jax_reports(tmp_path):
    argv = ["--num_samples", "5", "--save_images", "2", *TINY]
    jax_test_synthesis.main([*argv, "--output", str(tmp_path / "jax")])
    got = test_synthesis.main([*CPU, *argv, "--output", str(tmp_path / "port")])
    with open(tmp_path / "jax" / "synthesis_report.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "synthesis_report.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(got))
    assert got["scenes_per_sec"] > 0
    for report in (want, written):
        del report["scenes_per_sec"]
    assert written == want
    want_i, got_i = images(tmp_path / "jax"), images(tmp_path / "port")
    assert sorted(got_i) == sorted(want_i) and len(want_i) == 4
    for name in want_i:
        np.testing.assert_array_equal(got_i[name], want_i[name], err_msg=name)


def test_test_synthesis_renders_a_datasets_clouds(tmp_path):
    """With `--dataset`, the YCB-Video clouds of a fabricated tree render
    (unpainted); the JAX tool paints them with a name only its procedural
    branch defines and fails (ROADMAP Queue 3, F5)."""
    root = str(tmp_path / "lov")
    write_ycb_tree(root, sets=(("train", 1),), height=48, width=64)
    argv = ["--dataset", "ycb_video", "--data_root", root, "--num_samples", "2",
            "--set", "train.syn_width=64", "train.syn_height=48"]
    with pytest.raises(UnboundLocalError, match="proc"):
        jax_test_synthesis.main([*argv, "--output", str(tmp_path / "jax")])
    got = test_synthesis.main([*CPU, *argv, "--output", str(tmp_path / "port")])
    assert got["num_samples"] == 2 and got["tz_within_config"]
    assert max(map(int, got["class_frequency"])) > 4  # YCB-Video's 22 classes


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The port's test_net --save_results and demo outputs on a seeded
    checkpoint of small heads."""
    root = tmp_path_factory.mktemp("artifacts")
    ckpt = str(root / "toy_iter_1.npz")
    model = PoseCNN(22, num_units=16, fc_dim=64)
    init_weights(model, 0)
    save_params(ckpt, model, step=1)
    heads = ["compute_dtype=float32", "train.num_units=16", "train.fc_dim=64",
             "test.hough_num_samples=64"]
    test_net.main([*CPU, "--num_images", "2", "--save_results", "--output", str(root / "eval"),
                   "--ckpt", ckpt, "--set", "train.num_classes=22", "train.syn_width=64",
                   "train.syn_height=48", "train.add_num_points=32", *heads])
    write_demo_frames(str(root / "images"), 1)
    demo.main([*CPU, "--images", str(root / "images"), "--ckpt", ckpt, "--output",
               str(root / "demo"), "--set", *heads])
    return root


@pytest.mark.parametrize("kind,with_images", [("eval", False), ("demo", False),
                                              ("demo", True)])
def test_render_poses_draws_what_jax_draws(artifacts, kind, with_images, tmp_path):
    argv = ["--results", str(artifacts / kind)]
    if with_images:
        argv += ["--images", str(artifacts / "images")]
    jax_render_poses.main([*argv, "--output", str(tmp_path / "jax")])
    written = render_poses.main([*CPU, *argv, "--output", str(tmp_path / "port")])
    want, got = images(tmp_path / "jax"), images(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert written == (2 if kind == "eval" else 1)
    assert len(want) == (2 if kind == "eval" else 2 * written)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
