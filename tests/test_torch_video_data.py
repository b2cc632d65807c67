"""Port parity: the video family's data against the JAX package on the CPU,
bit for bit.

- `SyntheticSequenceGenerator.minibatch` for one seed: every blob equal,
  with its dtype;
- `get_real_video_minibatch` on a fabricated YCB-Video tree with a moving
  camera (`write_ycb_tree(moving_camera=True)`, 4 frames a video), from
  starts whose sequences run into the next video (the last in-video frame
  repeats) and at scale 1 and 0.5, with chromatic jitter from a seeded
  RandomState: image, depth, meta and label equal; the meta blob carries
  the camera motion;
- the scene-segmentation readers (`SceneSegDataset`'s subclasses,
  `SymDataset`, `YumiDataset`) on a fabricated scene tree: classes,
  symmetry, image sets and frames equal;
- `Voxelizer` on a depth map and on an empty one.
"""

import numpy as np
import pytest

import posecnn_tpu.data.datasets as jds
from posecnn_tpu.data.minibatch import get_real_video_minibatch as jax_video_minibatch
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator as JaxGenerator
from posecnn_tpu.data.synthetic import SyntheticSequenceGenerator as JaxSequences
from posecnn_tpu.utils.voxelizer import Voxelizer as JaxVoxelizer
import posecnn_torch.data.datasets as tds
from posecnn_torch.data.fabricate import write_scene_tree, write_ycb_tree
from posecnn_torch.data.minibatch import get_real_video_minibatch
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.utils.voxelizer import Voxelizer

H, W = 48, 64
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)


def assert_blobs_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_sequence_generator_matches_jax_bit_for_bit():
    lib = synthetic_class_library(4, 128)
    kw = dict(width=W, height=H, seed=5, point_colors=lib.colors, point_normals=lib.normals)
    want = JaxSequences(JaxGenerator(lib.points, lib.extents, K, **kw), num_steps=3).minibatch(2)
    got = SyntheticSequenceGenerator(SyntheticSceneGenerator(lib.points, lib.extents, K, **kw),
                                     num_steps=3).minibatch(2)
    assert_blobs_equal(got, want)
    assert got["image"].shape == (3, 2, H, W, 3) and np.abs(got["meta"][1:, :, 18:42]).sum() > 0


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycb_video"))
    index = write_ycb_tree(root, sets=(("train", 6),), height=H, width=W, k=K, num_points=128,
                           video_length=4, moving_camera=True)
    assert index["train"][3:5] == ["0000/000004", "0001/000001"]
    return root


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("starts", [[0, 2], [3, 4]], ids=["in_video", "at_boundary"])
def test_real_video_minibatch_matches_jax(video_root, starts, scale):
    got_ds = tds.YCBVideoDataset(video_root, "train")
    want_ds = jds.YCBVideoDataset(video_root, "train")
    h, w = int(H * scale), int(W * scale)
    kw = dict(num_steps=3, height=h, width=w, pixel_means=MEANS, chromatic=True, scale=scale)
    want = jax_video_minibatch(want_ds, starts, rng=np.random.RandomState(0), **kw)
    got = get_real_video_minibatch(got_ds, starts, rng=np.random.RandomState(0), **kw)
    assert_blobs_equal(got, want)
    # the camera moves inside a video; past a video's end its last frame
    # repeats (start 3 is 0000/000004); the voxel grid comes from frame 0
    assert np.abs(got["meta"][1, 1, 18:30] - got["meta"][0, 1, 18:30]).max() > 1e-4
    if starts[0] == 3:
        assert (got["depth"][1:, 0] == got["depth"][0, 0]).all()
    assert (got["meta"][:, :, 42:45] > 0).all()


def test_scene_segmentation_readers_match_jax(tmp_path):
    index = write_scene_tree(str(tmp_path), 10, sets=(("train", 2), ("val", 1)), height=H,
                             width=W)
    assert index == {"train": ["000000", "000001"], "val": ["000002"]}
    for name in ("rgbd_scene", "shapenet_scene", "shapenet_single", "gmu_scene", "sym", "yumi"):
        got = tds.DATASETS.get(name)(str(tmp_path), "train")
        want = jds.DATASETS.get(name)(str(tmp_path), "train")
        assert type(got).__name__ == type(want).__name__
        assert tuple(got.classes) == tuple(want.classes) and got.num_classes == want.num_classes
        np.testing.assert_array_equal(got.symmetry, want.symmetry)
        np.testing.assert_array_equal(got.extents, want.extents)
        assert got.image_index == want.image_index == index["train"]
        for i in got.image_index:
            a, b = got.load_frame(i), want.load_frame(i)
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {i} {key}")


def test_voxelizer_matches_jax():
    depth = np.zeros((H, W), np.float32)
    depth[10:30, 20:50] = np.linspace(0.8, 1.4, 30, dtype=np.float32)[None, :]
    for d in (depth, np.zeros_like(depth)):
        got, want = Voxelizer(grid_size=64, margin=0.2), JaxVoxelizer(grid_size=64, margin=0.2)
        got.setup_from_depth(d, K)
        want.setup_from_depth(d, K)
        assert got.meta_fields() == want.meta_fields()
        ijk = np.array([[0, 0, 0], [3, 17, 63]])
        xyz = np.array([[0.1, -0.2, 1.0], [-0.3, 0.25, 0.9]])
        np.testing.assert_array_equal(got.voxel_to_world(ijk), want.voxel_to_world(ijk))
        np.testing.assert_array_equal(got.world_to_voxel(xyz), want.world_to_voxel(xyz))
