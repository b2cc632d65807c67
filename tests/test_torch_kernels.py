"""The port's Hough vote kernels against their plain PyTorch versions.

No JAX here, so the file also runs on the GPU machine, where the
`cuda`-marked tests hold each CUDA kernel to its plain version:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card those skip; the CPU tests check the plain c2f path
against the plain exhaustive vote and the launch bookkeeping.
"""

import pytest
import torch

from chip_smoke import intrinsics, planted_extents, planted_scene
from posecnn_torch.ops import hough_kernels as hk
from posecnn_torch.ops.hough_voting import _prepare_slots, hough_voting

torch.set_num_threads(1)

H, W, C, S = 96, 128, 6, 128
SCENES = {
    "two": [(1, 32.0, 40.0, 0.8, 20, 18), (4, 96.0, 64.0, 1.5, 22, 16)],
    "edge_three": [(2, 8.0, 8.0, 1.1, 14, 14), (3, 64.0, 48.0, 0.9, 16, 12),
                   (5, 120.0, 88.0, 1.3, 14, 10)],
    "empty": [],
}


def packed(name, device="cpu", noise=0.05):
    label, low = planted_scene(H, W, C, SCENES[name], noise=noise)
    _, meta = intrinsics(H, W, f=150.0)
    prep = _prepare_slots(
        torch.from_numpy(label).to(device), torch.from_numpy(low).to(device),
        torch.from_numpy(planted_extents(C)).to(device), torch.from_numpy(meta).to(device),
        num_classes=C, label_threshold=100, skip_pixels=10, num_samples=S, max_classes=4,
        vertex_factor=8,
    )
    return prep["packed"], prep["bboxes"]


def run_hough(name, backend, device="cpu", noise=0.05):
    label, low = planted_scene(H, W, C, SCENES[name], noise=noise)
    _, meta = intrinsics(H, W, f=150.0)
    return hough_voting(
        torch.from_numpy(label[None]).to(device), torch.from_numpy(low[None]).to(device),
        torch.from_numpy(planted_extents(C)).to(device), torch.from_numpy(meta[None]).to(device),
        label_threshold=100, num_samples=S, max_classes=4, max_objects_per_image=6,
        vertex_factor=8, backend=backend,
    )


@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_plain_c2f_finds_the_exhaustive_maximum(name):
    """The coarse-to-fine vote picks the exhaustive vote's maximum on
    compact objects (the c2f guarantee of hough_pallas.hough_votes_c2f)."""
    c2f, dense = run_hough(name, "c2f"), run_hough(name, "dense")
    assert torch.equal(c2f.valid, dense.valid)
    assert int(c2f.valid.sum()) == len(SCENES[name])
    # padding rows differ by design (the dense path reads cell 0 there);
    # votes differ in the last bits (chunked vs sample-order sums)
    v = c2f.valid
    torch.testing.assert_close(c2f.rois[v], dense.rois[v], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(c2f.poses_init[v], dense.poses_init[v], rtol=1e-5, atol=1e-5)


def test_planted_centres_are_recovered():
    """Within 2 px and 2% at this small size, as tests/test_hough_voting.py
    asks of the JAX op (chip_smoke.py asks 1 px of the full-size scene)."""
    out = run_hough("two", "c2f", noise=0.0)
    rois, poses = out.rois[out.valid], out.poses_init[out.valid]
    for cls, cx, cy, depth, _, _ in SCENES["two"]:
        (i,) = torch.nonzero(rois[:, 1] == cls)[:, 0].tolist()
        assert abs(0.5 * float(rois[i, 2] + rois[i, 4]) - cx) <= 2.0
        assert abs(0.5 * float(rois[i, 3] + rois[i, 5]) - cy) <= 2.0
        assert abs(float(poses[i, 6]) - depth) <= 0.02 * depth


def test_plain_path_counts_no_launch():
    before = dict(hk.LAUNCHES)
    samples, bboxes = packed("two")
    hk.hough_votes_c2f(samples, bboxes, cell_stride=1, grid_h=H, grid_w=W)
    assert hk.LAUNCHES == before


def test_windows_plain_skips_disabled_windows():
    samples, bboxes = packed("two")
    k = samples.shape[0]
    origins = torch.zeros((k * 2, 3), dtype=torch.int32)
    origins[0] = torch.tensor([20, 10, 1])  # slot 0, enabled: around object 1
    origins[1] = torch.tensor([20, 10, 0])  # same window, disabled
    votes, dsum = hk.hough_votes_windows_plain(samples, origins, cell_stride=1, grid_h=H,
                                               grid_w=W)
    assert votes.shape == (2 * k, hk.TILE)
    assert float(votes[0].max()) > 0
    assert float(votes[1].abs().max()) == 0 and float(dsum[1].abs().max()) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the vote kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_flat_kernel_matches_plain(cuda, name, stride):
    samples, bboxes = packed(name, cuda)
    kw = dict(cell_stride=stride * 4, grid_h=-(-H // (4 * stride)), grid_w=-(-W // (4 * stride)))
    n0 = hk.LAUNCHES["flat"]
    kv, kd = hk.hough_votes_flat(samples, bboxes, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["flat"] == n0 + 1
    pv, pd = hk.hough_votes_flat_plain(samples, bboxes, **kw)
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=0)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_window_kernel_and_c2f_match_plain(cuda, name):
    samples, bboxes = packed(name, cuda)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W)
    vk = hk.hough_votes_c2f_windows(samples, bboxes, **kw)
    vp = hk.hough_votes_c2f_windows(samples.cpu(), bboxes.cpu(), **kw)
    for got, want in zip(vk, vp):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    bk = hk.hough_votes_c2f(samples, bboxes, **kw)
    bp = hk.hough_votes_c2f(samples.cpu(), bboxes.cpu(), **kw)
    for got, want in zip(bk, bp):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_hough_voting_on_card_matches_cpu(cuda):
    got, want = run_hough("edge_three", "c2f", cuda), run_hough("edge_three", "c2f")
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_bad_inputs(cuda):
    samples, bboxes = packed("two", cuda)
    with pytest.raises(ValueError):
        hk.hough_votes_flat(samples.double(), bboxes, cell_stride=4, grid_h=24, grid_w=32)
    with pytest.raises(ValueError):
        hk.hough_votes_flat(samples, bboxes.cpu(), cell_stride=4, grid_h=24, grid_w=32)
    with pytest.raises(ValueError):
        hk.hough_votes_windows(samples[:, :, ::2], torch.zeros((samples.shape[0], 3),
                               dtype=torch.int32, device=cuda), cell_stride=1, grid_h=H,
                               grid_w=W)
    with pytest.raises(ValueError, match="split evenly"):
        hk.hough_votes_windows(samples, torch.zeros((samples.shape[0] + 1, 3),
                               dtype=torch.int32, device=cuda), cell_stride=1, grid_h=H,
                               grid_w=W)
