"""The port's Hough vote kernels and its NMS scan kernel against their
plain PyTorch versions.

No JAX here, so the file also runs on the GPU machine, where the
`cuda`-marked tests hold each CUDA kernel to its plain version:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Each kernel is held to its plain version bit for bit (NaN where the
plain version gives NaN), at small scenes and at `chip_smoke`'s edge
cases (the exhaustive vote at stride 1, the c2f pair as c2f runs them)
and at the four tunings of `bench c2f`; the scan kernel at `chip_smoke`'s
scan cases (the RPN's (1, 2000) matrix, test_net's (21, 128), the serving
programs' (1, 16) and (1, 64), and the edges of its design), also one
byte off its allocation.
Without a card those skip; the CPU tests check the plain c2f path against
the plain exhaustive vote, the plain scan against the host scan, the
launch bookkeeping, and the bilinear upsample's backward (its exact
adjoint, on every device) against autograd's own backward of
`F.interpolate` (the card test holds it so on the card, and to itself
run after run).
"""

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (
    EDGE_CASES,
    SCAN_CASES,
    intrinsics,
    planted_extents,
    planted_scene,
    scan_case,
    vote_edge_case,
)
from posecnn_torch.ops import _cuda
from posecnn_torch.ops import hough_kernels as hk
from posecnn_torch.ops.nms import Suppression, greedy_keep, greedy_scan, greedy_scan_plain
from posecnn_torch.models.vgg16 import _resize_weights, bilinear_upsample
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


def assert_exact(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0, equal_nan=True)


def run_hough(name, backend, device="cpu", noise=0.05, **kw):
    label, low = planted_scene(H, W, C, SCENES[name], noise=noise)
    _, meta = intrinsics(H, W, f=150.0)
    return hough_voting(
        torch.from_numpy(label[None]).to(device), torch.from_numpy(low[None]).to(device),
        torch.from_numpy(planted_extents(C)).to(device), torch.from_numpy(meta[None]).to(device),
        label_threshold=100, num_samples=S, max_classes=4, max_objects_per_image=6,
        vertex_factor=8, backend=backend, **kw,
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


@pytest.mark.parametrize("name", ["two", "edge_three"])
def test_plain_c2f_equals_plain_exhaustive(name):
    """The c2f path equals the exhaustive kernel's path row for row: the
    same sample-order sums at the picked cell."""
    c2f, exh = run_hough(name, "c2f"), run_hough(name, "exhaustive")
    assert torch.equal(c2f.valid, exh.valid)
    v = c2f.valid
    torch.testing.assert_close(c2f.rois[v], exh.rois[v], rtol=0, atol=1e-5)
    torch.testing.assert_close(c2f.poses_init[v], exh.poses_init[v], rtol=0, atol=1e-5)


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
    assert_exact(kv, pv)
    assert_exact(kd, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_tile_kernel_matches_plain(cuda, name, stride):
    samples, bboxes = packed(name, cuda)
    kw = dict(cell_stride=stride, grid_h=H // stride, grid_w=W // stride)
    n0 = hk.LAUNCHES["tile"]
    kv, kd = hk.hough_votes_exhaustive(samples, bboxes, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["tile"] == n0 + 1
    assert kv.shape == (samples.shape[0], H // stride, W // stride)
    pv, pd = hk.hough_votes_exhaustive_plain(samples, bboxes, **kw)
    assert_exact(kv, pv)
    assert_exact(kd, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_tile_kernel_matches_plain_at_edge_cases(cuda, case):
    """S of 1-1100, ragged last tile row and column, d = inf tested (NaN
    in the tiles it reaches) and skipped, dead slots
    (chip_smoke.vote_edge_case), at stride 1."""
    samples, bboxes, (h, w), _ = vote_edge_case(case)
    samples, bboxes = torch.from_numpy(samples), torch.from_numpy(bboxes)
    kw = dict(cell_stride=1, grid_h=h, grid_w=w)
    n0 = hk.LAUNCHES["tile"]
    got = hk.hough_votes_exhaustive(samples.to(cuda), bboxes.to(cuda), **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["tile"] == n0 + 1
    for a, b in zip(got, hk.hough_votes_exhaustive_plain(samples, bboxes, **kw)):
        assert_exact(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_window_kernel_and_c2f_match_plain(cuda, name):
    samples, bboxes = packed(name, cuda)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W)
    vk = hk.hough_votes_c2f_windows(samples, bboxes, **kw)
    vp = hk.hough_votes_c2f_windows(samples.cpu(), bboxes.cpu(), **kw)
    for got, want in zip(vk, vp):
        assert_exact(got, want)
    bk = hk.hough_votes_c2f(samples, bboxes, **kw)
    bp = hk.hough_votes_c2f(samples.cpu(), bboxes.cpu(), **kw)
    for got, want in zip(bk, bp):
        assert_exact(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("factor, top_t", [(4, 4), (8, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("name", ["two", "edge_three", "empty"])
def test_c2f_pair_matches_plain_at_each_tuning(cuda, name, factor, top_t):
    """The tunings of `bench c2f` (coarse factor 4 or 8, 4 or 2 windows a
    slot): the flat pass at stride `factor`, the windows, the maximum."""
    samples, bboxes = packed(name, cuda)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W, coarse_factor=factor, top_t=top_t)
    n0 = dict(hk.LAUNCHES)
    got = hk.hough_votes_c2f_windows(samples, bboxes, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["flat"] == n0["flat"] + 1 and hk.LAUNCHES["window"] == n0["window"] + 1
    assert got[0].shape == (samples.shape[0], top_t, hk.TILE)
    for a, b in zip(got, hk.hough_votes_c2f_windows(samples.cpu(), bboxes.cpu(), **kw)):
        assert_exact(a, b)
    for a, b in zip(hk.hough_votes_c2f(samples, bboxes, **kw),
                    hk.hough_votes_c2f(samples.cpu(), bboxes.cpu(), **kw)):
        assert_exact(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_c2f_pair_matches_plain_at_edge_cases(cuda, case):
    """S of 1-1100, d = inf tested and skipped, a ragged last tile,
    windows clamped and reaching past the grid, dead slots, 32 windows
    per slot (chip_smoke.vote_edge_case)."""
    samples, bboxes, (h, w), opts = vote_edge_case(case)
    samples, bboxes = torch.from_numpy(samples), torch.from_numpy(bboxes)
    kw = dict(cell_stride=4, grid_h=-(-h // 4), grid_w=-(-w // 4))
    got = hk.hough_votes_flat(samples.to(cuda), bboxes.to(cuda), **kw)
    for a, b in zip(got, hk.hough_votes_flat_plain(samples, bboxes, **kw)):
        assert_exact(a, b)
    kw = dict(cell_stride=1, grid_h=h, grid_w=w, **opts)
    got = hk.hough_votes_c2f_windows(samples.to(cuda), bboxes.to(cuda), **kw)
    for a, b in zip(got, hk.hough_votes_c2f_windows(samples, bboxes, **kw)):
        assert_exact(a, b)


@pytest.mark.cuda
def test_window_kernel_matches_plain_past_the_grid(cuda):
    """Origins the c2f glue never gives: windows hanging over the bottom
    and right edges, one disabled, at stride 2. A sample at d = inf is
    tested at the first window, so its cells past the grid hold NaN."""
    samples, _, _, _ = vote_edge_case("s300")
    samples[0, :, 0] = [150.0, 130.0, 1.0, 0.0, float("inf"), 0.81, 20.0, 1.0]
    samples = torch.from_numpy(samples)
    origins = torch.tensor([[60, 70, 1], [70, 80, 1], [0, 0, 0], [75, 5, 1], [3, 84, 1],
                            [40, 40, 1]], dtype=torch.int32)
    kw = dict(cell_stride=2, grid_h=75, grid_w=86)
    want = hk.hough_votes_windows_plain(samples, origins, **kw)
    assert bool(torch.isnan(want[1][0].reshape(32, 32)[75 - 60:]).all())
    got = hk.hough_votes_windows(samples.to(cuda), origins.to(cuda), **kw)
    for a, b in zip(got, want):
        assert_exact(a, b)


@pytest.mark.cuda
def test_hough_voting_on_card_matches_cpu(cuda):
    got, want = run_hough("edge_three", "c2f", cuda), run_hough("edge_three", "c2f")
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["exhaustive", "c2f", "dense"])
def test_multi_instance_hough_on_card_matches_cpu(cuda, backend):
    kw = dict(vote_threshold=2.0, vote_percentage=1e-4)
    got = run_hough("edge_three", backend, cuda, **kw)
    want = run_hough("edge_three", backend, **kw)
    assert int(want.valid.sum()) >= len(SCENES["edge_three"])
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_tile_kernel_refuses_bad_inputs(cuda):
    samples, bboxes = packed("two", cuda)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W)
    with pytest.raises(ValueError):
        hk.hough_votes_exhaustive(samples.double(), bboxes, **kw)
    with pytest.raises(ValueError):
        hk.hough_votes_exhaustive(samples, bboxes.cpu(), **kw)
    with pytest.raises(ValueError):
        hk.hough_votes_exhaustive(samples[:, :, ::2], bboxes, **kw)


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


@pytest.mark.parametrize("case", SCAN_CASES)
def test_plain_scan_equals_the_host_scan(case):
    """`greedy_scan_plain` (the CPU's scan, and the kernel's plain version)
    keeps the rows `greedy_keep`'s numpy loop keeps, with no launch."""
    kill, valid = scan_case(case)
    before = dict(_cuda.LAUNCHES)
    kept = greedy_scan(kill, valid)
    assert _cuda.LAUNCHES == before
    order = torch.arange(kill.shape[-1]).expand(valid.shape)  # already in sorted order
    assert torch.equal(kept, greedy_keep(Suppression(order, kill, valid)))
    assert torch.equal(kept, greedy_scan_plain(kill, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernel_matches_plain(cuda, case):
    kill, valid = scan_case(case)
    want = greedy_scan_plain(kill, valid)
    n0 = _cuda.LAUNCHES["scan"]
    _cuda.reset_device_launches()
    got = greedy_scan(kill.to(cuda), valid.to(cuda))
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert _cuda.LAUNCHES["scan"] == n0 + 1 and _cuda.device_launches()["scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernel_on_a_misaligned_matrix_matches_plain(cuda, case):
    """The kill matrix one byte off its allocation: the packing reads it a
    byte at a time (16 bytes at a time only where it is 16-byte aligned
    and N is a multiple of 16)."""
    kill, valid = scan_case(case)
    shifted = torch.zeros(kill.numel() + 1, dtype=torch.bool, device=cuda)
    shifted[1:] = kill.reshape(-1).to(cuda)
    _cuda.reset_device_launches()
    got = greedy_scan(shifted[1:].view(kill.shape), valid.to(cuda))
    assert torch.equal(got.cpu(), greedy_scan_plain(kill, valid))
    assert _cuda.device_launches()["scan"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(6, 8, 8), (7, 9, 2), (1, 3, 2)])
def test_upsample_adjoint_equals_autograds_backward(shape, dtype):
    """`models/vgg16.bilinear_upsample`'s backward, the transpose of its
    resize weights, against autograd's own backward of `F.interpolate`
    (to rounding); as a forward the weights give `F.interpolate`."""
    h, w, f = shape
    x = torch.randn(2, 3, h, w, dtype=dtype, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn(2, 3, h * f, w * f, dtype=dtype, generator=torch.Generator().manual_seed(1))
    y = F.interpolate(x, size=(h * f, w * f), mode="bilinear", align_corners=False)
    (want,) = torch.autograd.grad(y, x, g)
    rows, cols = _resize_weights(h, h * f, "cpu", dtype), _resize_weights(w, w * f, "cpu", dtype)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    torch.testing.assert_close(rows @ x.detach() @ cols.t(), y.detach(), rtol=0, atol=tol)
    torch.testing.assert_close(rows.t() @ g @ cols, want, rtol=0,
                               atol=tol * float(want.abs().max()))
    xh = x.detach().permute(0, 2, 3, 1).requires_grad_(True)
    yh = bilinear_upsample(xh, f)
    torch.testing.assert_close(yh.detach(), y.detach().permute(0, 2, 3, 1), rtol=0, atol=0)
    (got,) = torch.autograd.grad(yh, xh, g.permute(0, 2, 3, 1))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=tol * float(want.abs().max()))


def autograd_upsample_grad(x, g):
    """Autograd's own backward of `F.interpolate` (NHWC in and out)."""
    xx = x.permute(0, 3, 1, 2).clone().requires_grad_(True)
    size = (g.shape[1], g.shape[2])
    y = F.interpolate(xx, size=size, mode="bilinear", align_corners=False)
    return torch.autograd.grad(y, xx, g.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)


@pytest.mark.cuda
def test_upsample_backward_on_the_card_is_deterministic(cuda):
    """`bilinear_upsample`'s gradient on the card: autograd's backward of
    `F.interpolate` on the CPU to rounding (fp64) and, in bf16, the same
    bits on every run."""
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(2, 60, 80, 16, dtype=torch.float64, generator=rng)
    g = torch.randn(2, 480, 640, 16, dtype=torch.float64, generator=rng)

    def grad(xx, gg):
        xx = xx.clone().requires_grad_(True)
        return torch.autograd.grad(bilinear_upsample(xx, 8), xx, gg)[0]

    torch.testing.assert_close(grad(x.to(cuda), g.to(cuda)).cpu(), autograd_upsample_grad(x, g),
                               rtol=0, atol=1e-12)
    xb, gb = x.to(cuda, torch.bfloat16), g.to(cuda, torch.bfloat16)
    first = grad(xb, gb)
    assert all(torch.equal(first, grad(xb, gb)) for _ in range(3))


@pytest.mark.cuda
def test_scan_kernel_refuses_bad_inputs(cuda):
    kill, valid = (t.to(cuda) for t in scan_case("n33"))
    with pytest.raises(ValueError):
        greedy_scan(kill.int(), valid)
    with pytest.raises(ValueError):
        greedy_scan(kill.transpose(-1, -2), valid)
    with pytest.raises(ValueError):
        greedy_scan(kill, valid[:, :-1])


def toy_train_step(device, batch, lib, model):
    """Loss and gradients of one fp32 train step at keep_prob 1 on `device`.
    The pose-row budget keeps only the prepended GT rows, so the pose loss
    does not hang on a label argmax near a tie; Hough still runs (its
    kernels on the card)."""
    from posecnn_torch.core.config import cfg_from_dict
    from posecnn_torch.engine.train import (
        _compose_losses_from_outputs,
        decompress_feed,
        loss_point_scale,
    )

    cfg = cfg_from_dict({"train": {"vertex_reg_2d": True, "pose_reg": True}})
    b = decompress_feed({k: torch.from_numpy(v).to(device) for k, v in batch.items()}, cfg)
    ext = torch.from_numpy(lib.extents).to(device)
    pts, sym = loss_point_scale(torch.from_numpy(lib.points[:, :64]).to(device), ext,
                                torch.from_numpy(lib.symmetry).to(device), True)
    model = model.to(device)
    model.zero_grad(set_to_none=True)
    out = model.train_forward(b["data"], ext, b["meta"], b["gt_poses"], b["gt_valid"])
    total, metrics = _compose_losses_from_outputs(out, b, cfg, pts, ext, sym)
    total.backward()
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One small fp32 train step (TF32 off) on the card against the CPU:
    every loss term within rtol 1e-4, every gradient within 1e-3 of its
    parameter's largest gradient entry. The images stay float (with the
    pool's σ = 8 noise): uint8 images clipped at 0 give neighbouring conv
    outputs that tie exactly on the CPU and differ by an ulp on the card,
    so a max-pool sends their gradient to another position."""
    import copy

    import numpy as np

    from posecnn_torch.cli.common import setup_device
    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator
    from posecnn_torch.models.posecnn import PoseCNN, init_weights

    setup_device("cuda")  # TF32 off
    lib = synthetic_class_library(C, 256)
    k = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=2,
                                  min_objects=2, max_objects=2, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.pooled_minibatch(2, max_gt=4, dense_vertex_targets=False)
    del batch["depth"]
    model = PoseCNN(C, num_units=8, fc_dim=32, hough_num_samples=S, max_objects=2,
                    gt_pose_rois=True, max_pose_rois=4)
    init_weights(model, 0)
    want_m, want_g = toy_train_step(torch.device("cpu"), batch, lib, copy.deepcopy(model))
    hk.LAUNCHES.update(flat=0, window=0)
    got_m, got_g = toy_train_step(cuda, batch, lib, model)
    assert hk.LAUNCHES["flat"] == 1 and hk.LAUNCHES["window"] == 1
    assert want_m["num_pose_rois"] == 4 and want_m["loss_pose"] > 0
    for key, value in want_m.items():
        assert got_m[key] == pytest.approx(value, rel=1e-4), key
    gaps = {name: float((got_g[name] - g).abs().max() / g.abs().max()) for name, g in want_g.items()}
    assert max(gaps.values()) < 1e-3, sorted(gaps.items(), key=lambda kv: -kv[1])[:8]


@pytest.mark.cuda
def test_kernels_match_plain_on_a_real_frame_rgbd_train_step(cuda, tmp_path):
    """One RGBD training step of `train_net`'s real-frame feed (a fabricated
    YCB-Video tree of 480×640 frames, read at scale 0.5, the yaml's batch
    of 2 and augmentation): flat and window launched once, and bit for bit
    against their plain versions on the step's own Hough inputs and on its
    batch's GT inputs."""
    import os

    from chip_smoke import Recorded, gt_hough_inputs, kernels_vs_plain, recording_hough
    from posecnn_torch.cli import train_net
    from posecnn_torch.data.fabricate import write_ycb_tree
    from posecnn_torch.engine.train import decompress_feed, make_train_step
    from posecnn_torch.models import posecnn as posecnn_module

    write_ycb_tree(str(tmp_path), sets=(("train", 2),), num_points=512)
    cfg = os.path.join(os.path.dirname(__file__), "..", "experiments", "cfgs", "lov_rgbd_2d.yaml")
    args = train_net.make_parser().parse_args(
        ["--device", "cuda", "--dataset", "lov", "--data_root", str(tmp_path), "--cfg", cfg,
         "--output", str(tmp_path / "out"), "--set", "train.scales_base=[0.5]",
         "train.fc_dim=64", "train.num_units=16"])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    try:
        batch = next(tr.batches)
    finally:
        tr.batches.close()
    assert len(tr.batches.workers) == 1 and "data_p" in batch
    step = make_train_step(tr.cfg, tr.model, tr.points, tr.extents, tr.symmetry)
    recorded = Recorded()
    record, original = recording_hough(recorded)
    posecnn_module.hough_voting = record
    hk.LAUNCHES.update(tile=0, flat=0, window=0)
    try:
        metrics = step(tr.state, batch)
    finally:
        posecnn_module.hough_voting = original
    assert hk.LAUNCHES["flat"] == 1 and hk.LAUNCHES["window"] == 1
    assert all(torch.isfinite(torch.as_tensor(v)) for v in metrics.values())
    label, vert, meta = recorded[0]
    inputs = {"step": (label, vert), "gt": gt_hough_inputs(tr, decompress_feed(batch, tr.cfg))}
    shapes, errs = kernels_vs_plain(tr.model.hough_kw, tr.extents, meta, inputs,
                                    "a real-frame RGBD step")
    assert shapes["gt"][1] > 0 and max(errs.values()) == 0.0
