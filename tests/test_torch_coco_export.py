"""Port parity: the COCO export (`posecnn_torch/data/coco_export.py`,
`posecnn_torch/cli/export_coco.py`) against the JAX package's on the CPU.

Every helper gives the original's result on the same masks and rows
(largest components, the boundary trace, Douglas-Peucker, polygons, RLE
both ways, the shoelace area, the writer's records, a frame's
annotations), and the CLI writes the JAX CLI's JSON on the same
arguments: with `--dataset synthetic` (random clouds, and YCB geometry
from a fabricated root) and on a fabricated YCB-Video tree's frames (the
pattern of JAX's `tests/test_coco_export.py`).
"""

import json
import os

import numpy as np
import pytest
import torch

import posecnn_tpu.data.coco_export as jce
from posecnn_tpu.cli.export_coco import main as jax_main
from posecnn_torch.cli.export_coco import main as port_main
from posecnn_torch.data import coco_export as tce
from posecnn_torch.data.fabricate import write_ycb_tree

torch.set_num_threads(1)
SMALL = ["--set", "train.num_classes=5", "train.syn_width=96", "train.syn_height=64",
         "train.syn_tnear=0.6", "train.syn_tfar=1.2"]


def masks():
    rng = np.random.RandomState(0)
    blobs = np.zeros((40, 50), bool)
    blobs[2:10, 2:10] = True
    blobs[20:38, 20:38] = True
    blobs[30:34, 5:9] = True
    ragged = rng.rand(30, 40) > 0.55
    line = np.zeros((6, 7), bool)
    line[2, 1:5] = True
    dot = np.zeros((5, 5), bool)
    dot[2, 3] = True
    return [blobs, ragged, line, dot, np.zeros((4, 4), bool), np.ones((6, 5), bool)]


@pytest.mark.parametrize("i", range(6))
def test_mask_helpers_equal_jax(i):
    mask = masks()[i]
    for got, want in zip(tce.largest_components(mask, 3), jce.largest_components(mask, 3)):
        np.testing.assert_array_equal(got, want)
    assert len(tce.largest_components(mask, 3)) == len(jce.largest_components(mask, 3))
    np.testing.assert_array_equal(tce.trace_boundary(mask), jce.trace_boundary(mask))
    got, want = tce.mask_to_polygons(mask, max_components=3), jce.mask_to_polygons(
        mask, max_components=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert tce.polygon_area(g) == jce.polygon_area(w)
    assert tce.mask_to_rle(mask) == jce.mask_to_rle(mask)
    np.testing.assert_array_equal(tce.rle_to_mask(tce.mask_to_rle(mask)), mask)


@pytest.mark.parametrize("eps", [0.0, 0.5, 2.0])
def test_simplify_polygon_equals_jax(eps):
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    poly = np.stack([20 + 10 * np.cos(t) + np.sin(5 * t), 20 + 8 * np.sin(t)], 1)
    np.testing.assert_array_equal(tce.simplify_polygon(poly, eps),
                                  jce.simplify_polygon(poly, eps))


def test_writer_and_frame_annotations_equal_jax():
    label = np.zeros((24, 32), np.int32)
    label[4:12, 6:16] = 1
    label[14:20, 20:30] = 3
    gt = np.zeros((3, 13), np.float32)
    gt[:, 1] = [1, 3, 2]  # class 2 is absent from the label map: no annotation
    gt[:, 2:4] = [[10.0, 8.0], [25.0, 17.0], [3.0, 3.0]]
    gt[:, 6] = 1.0
    gt[:, 12] = 1.0
    k = np.eye(3, dtype=np.float32) * 100.0
    data = []
    for mod in (tce, jce):
        w = mod.CocoWriter([f"c{i}" for i in range(1, 6)], supercategory="S")
        w.add_image(7, 32, 24, "x-color.png", "x-depth.png", factor_depth=5000.0)
        nxt = mod.frame_annotations(w, 7, 1, label, gt, k, segmentation="polygon")
        nxt = mod.frame_annotations(w, 7, nxt, label, gt, k, segmentation="rle")
        w.add_annotation(nxt, 7, 2, polygons=[np.array([[1, 1], [10, 1], [10, 8]])])
        data.append((nxt, w.get_annot_json()))
    assert data[0] == data[1] and data[0][0] == 5


@pytest.fixture(scope="module")
def ycb_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ycb")
    write_ycb_tree(str(root), sets=(("train", 2), ("val", 1)), height=48, width=64,
                   k=np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32),
                   num_points=256)
    return str(root)


def run_both(tmp_path, argv):
    got = port_main(argv + ["--output", str(tmp_path / "port")])
    want = jax_main(argv + ["--output", str(tmp_path / "jax")])
    with open(tmp_path / "port" / "annotations.json") as f:
        assert json.load(f) == want
    return got, want


def test_cli_synthetic_equals_jax(tmp_path):
    got, want = run_both(tmp_path, ["--dataset", "synthetic", "--num_images", "3",
                                    "--data_root", str(tmp_path / "none")] + SMALL)
    assert got == want and len(got["annotations"]) >= 3 and len(got["categories"]) == 4
    for img in got["images"]:
        assert os.path.exists(tmp_path / "port" / "images" / img["file_name"])
        assert os.path.exists(tmp_path / "port" / "images" / img["meta"]["depth_file"])


def test_cli_synthetic_on_ycb_geometry_equals_jax(tmp_path, ycb_root):
    got, want = run_both(tmp_path, ["--dataset", "synthetic", "--num_images", "2",
                                    "--data_root", ycb_root, "--segmentation", "rle"] + SMALL)
    assert got == want and len(got["categories"]) == 21 and got["annotations"]


@pytest.mark.parametrize("image_set", ["train", "val"])
def test_cli_dataset_frames_equal_jax(tmp_path, ycb_root, image_set):
    got, want = run_both(tmp_path, ["--dataset", "lov", "--data_root", ycb_root,
                                    "--image_set", image_set, "--num_images", "0"])
    assert got == want and got["annotations"]
    assert {a["meta"]["intrinsic_matrix"][0][0] for a in got["annotations"]} == {60.0}
