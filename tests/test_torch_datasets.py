"""Port parity: the carried dataset readers (posecnn_torch.data.datasets)
against posecnn_tpu.data.datasets on the CPU.

A YCB-Video tree and a LINEMOD tree are written to temporary directories
in the reference's formats (`data/fabricate.py`); both packages read
them, and every array they return is held bit for bit: image sets, model
clouds, extents, symmetry, the pose bank, each frame's colour, depth,
label and `.mat` meta, LINEMOD's diameters, intrinsics and z-flip
classes, the single-object splits and the demo set.
"""

import os

import numpy as np
import pytest
from PIL import Image

import posecnn_tpu.data.datasets as jds
import posecnn_torch.data.datasets as tds
from posecnn_tpu.core.registry import DATASETS as JAX_DATASETS
from posecnn_torch.data.fabricate import write_linemod_tree, write_ycb_tree

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def ycb_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ycb")
    write_ycb_tree(str(root), sets=(("train", 3), ("val", 2)), height=H, width=W, k=K,
                   num_points=300)
    return str(root)


def assert_frames_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "meta":
            assert set(g) == set(w)
            for mk in w:
                if isinstance(w[mk], np.ndarray):
                    np.testing.assert_array_equal(g[mk], w[mk], err_msg=mk)
            continue
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("image_set", ["train", "val"])
def test_ycb_video_tree_reads_as_in_jax(ycb_root, image_set):
    got = tds.YCBVideoDataset(ycb_root, image_set, num_points=300)
    want = jds.YCBVideoDataset(ycb_root, image_set, num_points=300)
    assert got.image_index == want.image_index and len(got.image_index) in (2, 3)
    assert got.classes == want.classes and got.num_classes == 22
    for name in ("points", "extents", "symmetry"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert np.abs(got.points[1:]).max(axis=(1, 2)).min() > 0
    np.testing.assert_array_equal(got.subsampled_points(64), want.subsampled_points(64))
    assert got.adi_classes == want.adi_classes
    for index in got.image_index:
        assert got.frame_prefix(index) == want.frame_prefix(index)
        frame = got.load_frame(index)
        assert_frames_equal(frame, want.load_frame(index))
        assert frame["color"].shape == (H, W, 3) and frame["depth_raw"].dtype == np.uint16
        assert frame["poses"].shape == (3, 4, len(frame["cls_indexes"]))


def test_pose_bank_reads_as_in_jax(ycb_root):
    got = tds.YCBVideoDataset(ycb_root, "train", num_points=300).load_pose_bank()
    want = jds.YCBVideoDataset(ycb_root, "train", num_points=300).load_pose_bank()
    assert got[0] is None and want[0] is None and len(got) == len(want) == 22
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == (16, 7)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cls", ["", "val"])
def test_single_object_splits_read_as_in_jax(ycb_root, tmp_path, cls):
    # YCBSingleDataset also finds <cls>_<set>.txt under image_sets/ and indexes/
    os.makedirs(os.path.join(ycb_root, "image_sets"), exist_ok=True)
    with open(os.path.join(ycb_root, "image_sets", "val_train.txt"), "w") as f:
        f.write(open(os.path.join(ycb_root, "val.txt")).read())
    for tcls, jcls in ((tds.YCBSingleDataset, jds.YCBSingleDataset),
                       (tds.LOVSingleDataset, jds.LOVSingleDataset)):
        got, want = tcls(ycb_root, "train", cls=cls, num_points=300), jcls(
            ycb_root, "train", cls=cls, num_points=300)
        assert got.image_index == want.image_index and got.image_index
        assert got._image_set_file() == want._image_set_file()
        np.testing.assert_array_equal(got.points, want.points)


@pytest.mark.parametrize("with_model", [False, True])
def test_linemod_tree_reads_as_in_jax(tmp_path, with_model):
    write_linemod_tree(str(tmp_path), "eggbox", with_model=with_model, num_points=300)
    got = tds.LinemodDataset(str(tmp_path), "test", cls="eggbox", num_points=300)
    want = jds.LinemodDataset(str(tmp_path), "test", cls="eggbox", num_points=300)
    assert got.image_index == want.image_index and len(got.image_index) == 4
    for name in ("points", "extents", "symmetry", "diameters", "intrinsic_matrix"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.z_flip_classes == want.z_flip_classes == (10,)
    assert bool(np.any(got.points[10])) == with_model


def test_demo_dataset_reads_as_in_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(
            str(tmp_path / f"{i:06d}-color.png"))
        Image.fromarray(rng.randint(0, 20000, (H, W)).astype(np.uint16)).save(
            str(tmp_path / f"{i:06d}-depth.png"))
    got, want = tds.DemoDataset(str(tmp_path)), jds.DemoDataset(str(tmp_path))
    assert got.image_index == want.image_index == ["000000", "000001"]
    np.testing.assert_array_equal(got.intrinsic_matrix, want.intrinsic_matrix)
    for index in got.image_index:
        assert_frames_equal(got.load_frame(index), want.load_frame(index))


def test_registry_names_the_jax_packages_pose_datasets():
    assert set(tds.DATASETS.names()) == set(JAX_DATASETS.names())
    for name in tds.DATASETS.names():
        assert tds.DATASETS.get(name).__name__ == JAX_DATASETS.get(name).__name__


def test_load_points_xyz_matches_jax(tmp_path):
    pts = np.random.RandomState(1).randn(500, 3).astype(np.float32)
    np.savetxt(tmp_path / "p.xyz", pts)
    for n in (None, 64, 1000):
        np.testing.assert_array_equal(tds.load_points_xyz(str(tmp_path / "p.xyz"), n),
                                      jds.load_points_xyz(str(tmp_path / "p.xyz"), n))


def test_class_data_from_dataset_matches_jax(ycb_root):
    from posecnn_tpu.cli.common import class_data_from_dataset as jax_class_data
    from posecnn_torch.cli.common import class_data_from_dataset

    ds = tds.YCBVideoDataset(ycb_root, "val", num_points=300)
    for got, want in zip(class_data_from_dataset(ds, 64), jax_class_data(ds, 64)):
        np.testing.assert_array_equal(got, want)
    demo = tds.DemoDataset(ycb_root)
    got, want = class_data_from_dataset(demo, 64), jax_class_data(demo, 64)
    assert got[0] is None and got[1] is None and want[0] is None
    np.testing.assert_array_equal(got[2], want[2])
