"""Port parity: Hough voting and its vote kernels (posecnn_torch) against
the JAX package on the scenes of tests/test_hough_voting.py.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_hough_pallas.py does. The port's plain vote versions
accumulate sample by sample with the kernels' arithmetic and skips, so
votes are held to rtol 1e-5 (they agree to the bit in practice) and the
picked cells exactly. The CUDA kernels themselves are held to the plain
versions in tests/test_torch_kernels.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jhp = importlib.import_module("posecnn_tpu.ops.hough_pallas")
jhv = importlib.import_module("posecnn_tpu.ops.hough_voting")
from posecnn_torch.ops import hough_kernels as thk
from posecnn_torch.ops import hough_voting as thv
from tests.test_hough_voting import EXTENTS, H, NUM_CLASSES, W, make_meta, make_scene

torch.set_num_threads(1)

SCENES = {
    "single": [(2, 100.0, 60.0, 1.2, 30, 25)],
    "two": [(1, 40.0, 40.0, 0.8, 22, 22), (3, 120.0, 80.0, 1.5, 25, 20)],
    "small_edge": [(1, 30.0, 100.0, 2.0, 4, 4), (2, 3.0, 3.0, 1.0, 10, 10)],
    "corner_three": [(1, 30.0, 40.0, 0.9, 16, 16), (3, 8.0, 8.0, 1.1, 14, 14),
                     (2, 110.0, 90.0, 1.4, 20, 16)],
    "empty": [],
}
KW = dict(label_threshold=100, num_samples=128, max_classes=3, skip_pixels=10)
F = 8  # vertex_factor of the model's Hough call


def lowres_scene(objects, noise=0.0, seed=0):
    """Full-res labels + the 1/8-res vertex map the model's vertex head
    would give: each object's unit direction field and log depth at the
    low-res pixel centres of a box around it, plus optional noise."""
    label, _ = make_scene(objects)
    hl, wl = H // F, W // F
    rng = np.random.RandomState(seed)
    low = (rng.randn(hl, wl, 3 * NUM_CLASSES) * noise).astype(np.float32)
    ys, xs = np.mgrid[0:hl, 0:wl]
    fy_c, fx_c = (ys + 0.5) * F - 0.5, (xs + 0.5) * F - 0.5
    for cls, cx, cy, depth, hw, hh in objects:
        region = (np.abs(fx_c - cx) <= hw + F) & (np.abs(fy_c - cy) <= hh + F)
        dx, dy = cx - fx_c, cy - fy_c
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        low[region, 3 * cls + 0] += (dx / n)[region]
        low[region, 3 * cls + 1] += (dy / n)[region]
        low[region, 3 * cls + 2] += np.log(depth)
    return label, low


def jax_prep(label, vert, factor):
    return jhv._prepare_slots(
        jnp.asarray(label), jnp.asarray(vert), jnp.asarray(EXTENTS), jnp.asarray(make_meta()),
        num_classes=NUM_CLASSES, vertex_factor=factor, **KW,
    )


def torch_prep(label, vert, factor):
    return thv._prepare_slots(
        torch.from_numpy(label), torch.from_numpy(vert), torch.from_numpy(EXTENTS),
        torch.from_numpy(make_meta()), num_classes=NUM_CLASSES, vertex_factor=factor, **KW,
    )


def packed_inputs(name, noise=0.05):
    """JAX-packed samples + boxes of a scene, as numpy."""
    label, low = lowres_scene(SCENES[name], noise=noise)
    prep = jax_prep(label, low, F)
    return np.array(prep["packed"]), np.array(prep["bboxes"])


@pytest.mark.parametrize("factor", [1, F])
@pytest.mark.parametrize("name", ["two", "corner_three", "random"])
def test_prepare_slots_matches_jax(name, factor):
    if name == "random":  # every class present, odd block padding
        rng = np.random.RandomState(7)
        label = rng.randint(0, NUM_CLASSES, (H, W)).astype(np.int32)
        vert = rng.randn(H // factor, W // factor, 3 * NUM_CLASSES).astype(np.float32)
    elif factor == 1:
        label, vert = make_scene(SCENES[name])
    else:
        label, vert = lowres_scene(SCENES[name], noise=0.05)
    want = jax_prep(label, vert, factor)
    got = torch_prep(label, vert, factor)
    assert set(got) == set(want)
    for key in ("slot_cls", "slot_valid", "samp_ok", "samp_x", "samp_y"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("samp_u", "samp_v", "samp_d", "samp_uv_norm", "samp_thresh", "samp_w",
                "packed", "bboxes"):
        # exp and divisions may round differently in the last bit
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["single", "two", "corner_three"])
def test_flat_votes_match_jax(name):
    samples, bboxes = packed_inputs(name)
    kw = dict(cell_stride=4, grid_h=H // 4, grid_w=W // 4)
    jv, jd = jhp.hough_votes_flat(jnp.asarray(samples), jnp.asarray(bboxes), interpret=True, **kw)
    tv, td = thk.hough_votes_flat(torch.from_numpy(samples), torch.from_numpy(bboxes), **kw)
    assert tv.shape == (samples.shape[0], (H // 4) * (W // 4))
    assert np.asarray(jv).max() > 0
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["single", "two", "small_edge", "corner_three"])
def test_c2f_windows_and_maximum_match_jax(name):
    samples, bboxes = packed_inputs(name)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W)
    j_win = jhp.hough_votes_c2f_windows(
        jnp.asarray(samples), jnp.asarray(bboxes), interpret=True, **kw
    )
    t_win = thk.hough_votes_c2f_windows(torch.from_numpy(samples), torch.from_numpy(bboxes), **kw)
    for got, want in zip(t_win[2:], j_win[2:]):  # origins and enable: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(t_win[0].numpy(), np.asarray(j_win[0]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_win[1].numpy(), np.asarray(j_win[1]), rtol=1e-5, atol=1e-6)

    jbest = jhp.hough_votes_c2f(jnp.asarray(samples), jnp.asarray(bboxes), interpret=True, **kw)
    tbest = thk.hough_votes_c2f(torch.from_numpy(samples), torch.from_numpy(bboxes), **kw)
    np.testing.assert_allclose(tbest[0].numpy(), np.asarray(jbest[0]), rtol=1e-5)
    np.testing.assert_allclose(tbest[1].numpy(), np.asarray(jbest[1]), rtol=1e-5, atol=1e-6)
    # the picked cell: exact (ties resolve alike, the sums are equal)
    np.testing.assert_array_equal(tbest[2].numpy(), np.asarray(jbest[2]))
    np.testing.assert_array_equal(tbest[3].numpy(), np.asarray(jbest[3]))


def run_both(objects_per_image, backend_t, backend_j, noise=0.05, cell_stride=1):
    labels, verts = zip(*(lowres_scene(o, noise=noise, seed=i)
                          for i, o in enumerate(objects_per_image)))
    label, vert = np.stack(labels), np.stack(verts)
    meta = np.stack([make_meta()] * len(labels))
    kw = dict(KW, max_objects_per_image=4, vertex_factor=F, cell_stride=cell_stride)
    want = jhv.hough_voting(
        jnp.asarray(label), jnp.asarray(vert), jnp.asarray(EXTENTS), jnp.asarray(meta),
        backend=backend_j, sample_chunk=8, **kw,
    )
    got = thv.hough_voting(
        torch.from_numpy(label), torch.from_numpy(vert), torch.from_numpy(EXTENTS),
        torch.from_numpy(meta), backend=backend_t, **kw,
    )
    return got, want


def assert_rows_match(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.poses_init.numpy(), np.asarray(want.poses_init),
                               rtol=1e-5, atol=1e-5)
    assert got.rois.shape == (valid.shape[0], 7)


@pytest.mark.parametrize("name", ["single", "two", "small_edge", "corner_three", "empty"])
def test_hough_voting_c2f_matches_jax_pallas_c2f(name):
    got, want = run_both([SCENES[name]], "c2f", "pallas_c2f")
    assert_rows_match(got, want)
    if name in ("single", "two"):
        assert got.valid.sum() == len(SCENES[name])


@pytest.mark.parametrize("name", ["single", "corner_three"])
def test_hough_voting_c2f_cell_stride2_matches_jax(name):
    got, want = run_both([SCENES[name]], "c2f", "pallas_c2f", cell_stride=2)
    assert_rows_match(got, want)


def test_hough_voting_c2f_batch2_matches_jax():
    got, want = run_both([SCENES["two"], SCENES["single"]], "c2f", "pallas_c2f")
    assert_rows_match(got, want)
    assert got.valid.sum() == 3
    assert set(got.rois[got.valid, 0].tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("name", ["single", "two"])
def test_hough_voting_dense_matches_jax_xla(name):
    got, want = run_both([SCENES[name]], "dense", "xla", noise=0.0)
    assert_rows_match(got, want)
    # the centre sits on the planted one and the depth is recovered
    for row, pose in zip(got.rois[got.valid].numpy(), got.poses_init[got.valid].numpy()):
        obj = next(o for o in SCENES[name] if o[0] == int(row[1]))
        assert abs(0.5 * (row[2] + row[4]) - obj[1]) <= 2.0
        assert abs(pose[6] - obj[3]) <= 0.02 * obj[3]


def test_hough_voting_rejects_unknown_backend():
    label, low = lowres_scene(SCENES["single"])
    args = (torch.from_numpy(label[None]), torch.from_numpy(low[None]),
            torch.from_numpy(EXTENTS), torch.from_numpy(make_meta()[None]))
    with pytest.raises(ValueError):
        thv.hough_voting(*args, backend="pallas", vertex_factor=F)


def test_wrappers_refuse_devices_without_the_kernel():
    """A tensor neither on the CPU nor on a CUDA card gets no plain
    fallback: the wrapper raises."""
    samples, bboxes = packed_inputs("single")
    meta_s = torch.from_numpy(samples).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        thk.hough_votes_flat(meta_s, torch.from_numpy(bboxes).to("meta"),
                             cell_stride=4, grid_h=30, grid_w=40)

