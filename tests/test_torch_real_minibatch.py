"""Port parity: the carried real-frame minibatch code
(posecnn_torch.data.minibatch) against posecnn_tpu.data.minibatch on the
CPU.

Frames come from a YCB-Video tree written to a temporary directory in the
reference's formats (`data/fabricate.write_ycb_tree`, 48×64 renders);
both packages' `get_real_minibatch` read them through the same reader.
Everything is held bit for bit: the image blobs of each input mode
(COLOR, DEPTH, RGBD, NORMAL), plain, augmented (chromatic and noise from
one `RandomState` seed) and flipped; the batches of each mode, flipped,
rescaled, dense and sparse, and the `RandomState` left behind; the
helpers. The dense vertex targets come from C++ loops in both packages
(the port's `data/native.py` over its carried `csrc/blobops.cpp`, JAX's
`native/blobops.cpp`), equal bit for bit; with JAX's library off, the
port's numpy path (`native=False`) equals JAX's bit for bit. The two
paths differ by fp32 rounding (1e-6: the C++ loop's compiler contracts
dx·dx + dy·dy into an FMA), as tests/test_torch_synthetic.py holds the
renders.
"""

from functools import partial

import numpy as np
import pytest
import torch

import posecnn_tpu.data.minibatch as jmb
import posecnn_tpu.data.native as jnative
import posecnn_torch.data.minibatch as tmb
from posecnn_torch.data.datasets import YCBVideoDataset
from posecnn_torch.data.fabricate import write_ycb_tree
from posecnn_torch.ops.losses import build_vertex_targets

torch.set_num_threads(1)
H, W, C = 48, 64, 22
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)
MODES = ("COLOR", "DEPTH", "RGBD", "NORMAL")


@pytest.fixture(scope="module")
def ycb(tmp_path_factory):
    root = tmp_path_factory.mktemp("ycb")
    write_ycb_tree(str(root), sets=(("train", 3),), height=H, width=W, k=K, num_points=256)
    return YCBVideoDataset(str(root), "train", num_points=256)


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("flip", [False, True])
def test_image_blobs_match_jax(ycb, mode, flip):
    frame = ycb.load_frame(ycb.image_index[1])
    color, depth = frame["color"], frame["depth_raw"].astype(np.float32)
    for aug in (False, True):
        r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
        kw = dict(input_mode=mode, pixel_means=MEANS, chromatic=aug, noise=aug, flip=flip,
                  depth_factor=10000.0)
        got = tmb.build_image_blobs(color, depth, K, rng=r1, **kw)
        want = jmb.build_image_blobs(color, depth, K, rng=r2, **kw)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        assert r1.rand() == r2.rand()
    assert (got[1] is not None) == (mode == "RGBD")


@pytest.mark.parametrize("mode", MODES)
def test_real_minibatch_matches_jax(ycb, mode, monkeypatch):
    # the numpy paths on both sides
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tmb, "generate_vertex_targets",
                        partial(tmb.generate_vertex_targets, native=False))
    kw = dict(num_classes=C, height=H, width=W, pixel_means=MEANS, input_mode=mode,
              chromatic=True, noise=True, use_flipped=True, max_gt=12)
    # indices ≥ the frame count select the mirrored copies
    for dense in (True, False):
        r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
        got = tmb.get_real_minibatch(ycb, [0, 4, 2], rng=r1, dense_vertex_targets=dense, **kw)
        want = jmb.get_real_minibatch(ycb, [0, 4, 2], rng=r2, dense_vertex_targets=dense, **kw)
        assert_batches_equal(got, want)
        assert r1.rand() == r2.rand()
    assert got["gt_valid"].sum() > 0 and (got["label"] > 0).any()
    assert ("data_p" in got) == (mode == "RGBD")


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_rescaled_minibatch_matches_jax(ycb, scale):
    h, w = int(round(H * scale)), int(round(W * scale))
    kw = dict(num_classes=C, height=h, width=w, pixel_means=MEANS, input_mode="RGBD",
              scale=scale, max_gt=12, dense_vertex_targets=False)
    assert_batches_equal(tmb.get_real_minibatch(ycb, [1, 2], **kw),
                         jmb.get_real_minibatch(ycb, [1, 2], **kw))


def test_sparse_vertex_targets_build_the_dense_maps(ycb):
    kw = dict(num_classes=C, height=H, width=W, pixel_means=MEANS, max_gt=12)
    dense = tmb.get_real_minibatch(ycb, [0, 1, 2], **kw)
    sparse = tmb.get_real_minibatch(ycb, [0, 1, 2], dense_vertex_targets=False, **kw)
    targets, weights = build_vertex_targets(
        torch.from_numpy(sparse["label"]), torch.from_numpy(sparse["vertex_centers"]),
        torch.from_numpy(sparse["vertex_logz"]), torch.from_numpy(sparse["vertex_valid"]))
    np.testing.assert_allclose(targets.numpy(), dense["vertex_targets"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(weights.numpy(), dense["vertex_weights"])


@pytest.mark.parametrize("native", [False, True])
def test_vertex_targets_equal_the_jax_package(ycb, native, monkeypatch):
    """The port's numpy path against the JAX package's numpy path, and
    the port's C++ loop against JAX's, bit for bit."""
    if native:
        assert jnative.get_lib() is not None, "the JAX package's library did not build"
    else:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    for index in ycb.image_index:
        f = ycb.load_frame(index)
        poses = np.transpose(f["poses"], (2, 0, 1))
        args = (f["label"], f["cls_indexes"], f["center"], poses[:, 2, 3].astype(np.float32), C)
        for got, want in zip(tmb.generate_vertex_targets(*args, native=native),
                             jmb.generate_vertex_targets(*args)):
            np.testing.assert_array_equal(got, want)
        assert (want != 0).any()


def test_helpers_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(8):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        from posecnn_tpu.utils.quaternion import quat_to_mat_np

        m = quat_to_mat_np(q.astype(np.float32))
        np.testing.assert_array_equal(tmb.mat_to_quat_np(m), jmb.mat_to_quat_np(m))
    poses = rng.randn(3, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(tmb.flip_poses(poses, K, W), jmb.flip_poses(poses, K, W))
    depth = rng.uniform(0.5, 1.5, (H, W)).astype(np.float32)
    depth[5:9, 7:20] = 0
    np.testing.assert_array_equal(tmb.normals_from_depth_np(depth, K),
                                  jmb.normals_from_depth_np(depth, K))
    im = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmb._box_smooth(im), jmb._box_smooth(im))
    for s in (0.5, 1.25):
        np.testing.assert_array_equal(tmb.resize_bilinear(im, s), jmb.resize_bilinear(im, s))
        np.testing.assert_array_equal(tmb.resize_nearest(im, s), jmb.resize_nearest(im, s))
    for hw in ((40, 70), (56, 50)):
        np.testing.assert_array_equal(tmb._fit_hw(im, *hw), jmb._fit_hw(im, *hw))
    ims = [im[:30, :41], im[:25, :33]]
    np.testing.assert_array_equal(tmb.pad_image_blob(ims, MEANS), jmb.pad_image_blob(ims, MEANS))
    label = np.zeros((H, W), np.int32)
    label[3:9, 4:11], label[20:30, 40:50] = 2, 5
    np.testing.assert_array_equal(tmb.label_to_boxes(label, np.array([5, 2, 7])),
                                  jmb.label_to_boxes(label, np.array([5, 2, 7])))
