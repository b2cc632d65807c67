"""Port parity at the edges of the vote: the port's plain vote versions
(the exhaustive vote and the coarse-to-fine pair) against the JAX
package's Pallas kernels (interpret mode), bit for bit, NaN where the
Pallas kernel gives NaN.

The inputs are `chip_smoke.vote_edge_case`'s, made with numpy from a
seed: S of 1, 37, 300 and 1100 samples, a sample at d = inf that is
tested in some cells and one that is never tested, a stride-1 grid
whose last row and column of (8, 128) tiles are ragged, a coarse grid
whose last 1024-cell tile is ragged, windows clamped at the bottom-right and
reaching past the grid, all slots dead, and the multi-instance greedy
pick of 32 windows per slot. `tests/test_torch_kernels.py` holds the
CUDA kernels to the same plain versions on the same inputs.

XLA on the CPU fuses `a + b * c` into one fused multiply-add wherever
the host has the instruction, so in interpret mode the Pallas kernels'
`acc_d + w * d` is rounded once, where the kernels' code rounds the
product and the sum each (as the port does, and as its CUDA kernels
must: their `_rn` intrinsics forbid the fusion). The reference
therefore runs in a child process whose XLA is capped at AVX, which has
no FMA (`--xla_cpu_max_isa=AVX`): every product and sum is then rounded
as the kernel is written. The option takes effect only when XLA's CPU
client is made, hence the process of its own.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_CASES, vote_edge_case
from posecnn_torch.ops import hough_kernels as thk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# the child: the three Pallas calls of every case, in interpret mode,
# saved to the .npz named by argv[1]
REFERENCE = """
import importlib, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
from chip_smoke import EDGE_CASES, vote_edge_case
jhp = importlib.import_module("posecnn_tpu.ops.hough_pallas")
out = {}
for case in EDGE_CASES:
    samples, bboxes, (h, w), opts = vote_edge_case(case)
    samples, bboxes = jnp.asarray(samples), jnp.asarray(bboxes)
    tile = jhp.hough_votes_pallas(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w,
                                  interpret=True)
    flat = jhp.hough_votes_flat(samples, bboxes, cell_stride=4, grid_h=-(-h // 4),
                                grid_w=-(-w // 4), interpret=True)
    win = jhp.hough_votes_c2f_windows(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w,
                                      interpret=True, **opts)
    for i, a in enumerate(tile):
        out[f"{case}/tile/{i}"] = np.asarray(a)
    for i, a in enumerate(flat):
        out[f"{case}/flat/{i}"] = np.asarray(a)
    for i, a in enumerate(win):
        out[f"{case}/windows/{i}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """case -> {"tile": (votes, dsum), "flat": (votes, dsum), "windows":
    (votes_w, dsum_w, oy, ox, enable)} from the JAX package, as numpy."""
    path = tmp_path_factory.mktemp("pallas") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    data = np.load(path)
    return {case: {kind: tuple(data[f"{case}/{kind}/{i}"] for i in range(n))
                   for kind, n in (("tile", 2), ("flat", 2), ("windows", 5))}
            for case in EDGE_CASES}


def coarse_kw(height, width):
    return dict(cell_stride=4, grid_h=-(-height // 4), grid_w=-(-width // 4))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_exhaustive_plain_equals_pallas(pallas, case):
    samples, bboxes, (h, w), _ = vote_edge_case(case)
    got = thk.hough_votes_exhaustive(torch.from_numpy(samples), torch.from_numpy(bboxes),
                                     cell_stride=1, grid_h=h, grid_w=w)
    for g, want in zip(got, pallas[case]["tile"]):
        assert g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want)  # NaN equals NaN


@pytest.mark.parametrize("case", EDGE_CASES)
def test_flat_plain_equals_pallas(pallas, case):
    samples, bboxes, (h, w), _ = vote_edge_case(case)
    got = thk.hough_votes_flat(torch.from_numpy(samples), torch.from_numpy(bboxes),
                               **coarse_kw(h, w))
    for g, want in zip(got, pallas[case]["flat"]):
        assert g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want)  # NaN equals NaN


@pytest.mark.parametrize("case", EDGE_CASES)
def test_c2f_windows_plain_equals_pallas(pallas, case):
    samples, bboxes, (h, w), opts = vote_edge_case(case)
    got = thk.hough_votes_c2f_windows(torch.from_numpy(samples), torch.from_numpy(bboxes),
                                      cell_stride=1, grid_h=h, grid_w=w, **opts)
    for g, want in zip(got, pallas[case]["windows"]):
        assert g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want)


def reached_tiles(samples, k, height, width):
    """(height, width) bool: the cells of the (8, 128) tiles that slot k's
    tested d = inf samples reach (their ±thr box, `hough_pallas.py:97-103`)."""
    x, y, d, thr, wgt = (samples[k, c].numpy() for c in (0, 1, 4, 6, 7))
    rows = np.arange(height) // thk.TILE_H * thk.TILE_H
    cols = np.arange(width) // thk.TILE_W * thk.TILE_W
    out = np.zeros((height, width), bool)
    for j in np.nonzero(np.isinf(d) & (wgt > 0))[0]:
        out |= (((y[j] + thr[j] >= rows) & (y[j] - thr[j] < rows + thk.TILE_H))[:, None]
                & ((x[j] + thr[j] >= cols) & (x[j] - thr[j] < cols + thk.TILE_W))[None])
    return out


def test_edge_cases_reach_their_edges():
    """Each case exercises the edge it is named for."""
    def run(case):
        samples, bboxes, (h, w), opts = vote_edge_case(case)
        samples, bboxes = torch.from_numpy(samples), torch.from_numpy(bboxes)
        tile = thk.hough_votes_exhaustive(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w)
        flat = thk.hough_votes_flat(samples, bboxes, **coarse_kw(h, w))
        win = thk.hough_votes_c2f_windows(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w,
                                          **opts)
        return samples, (h, w), tile, flat, win

    for case, s in (("s1", 1), ("s37", 37), ("s300", 300), ("s1100", 1100)):
        samples, _, (tv, _), (fv, _), (wv, *_) = run(case)
        assert samples.shape[2] == s and float(fv.max()) > 0 and float(wv.max()) > 0
        assert float(tv.max()) > 0

    # 38x43 coarse cells: two tiles, the second ragged; 43 is odd
    samples, (h, w), (tv, td), (fv, fd), (_, wd, *_) = run("inf_depth")
    assert coarse_kw(h, w)["grid_w"] % 2 and fv.shape[1] == 38 * 43 < 2 * thk.TILE
    nan = torch.isnan(fd[0])
    assert bool(nan[: thk.TILE].any()) and not bool(nan[thk.TILE:].any())
    assert bool(torch.isnan(wd[1]).any()) and not bool(torch.isnan(wd[2]).any())
    # 150x172 cells at stride 1: the last row and column of (8, 128) tiles
    # are ragged (150 = 18·8 + 6, 172 = 128 + 44), and the corner tile votes
    assert (h % thk.TILE_H, w - thk.TILE_W) == (6, 44)
    assert float(tv[:, h - h % thk.TILE_H:, thk.TILE_W:].max()) > 0
    # dsum is not finite exactly in the tiles a tested d = inf sample
    # reaches (NaN outside its cone), and finite wherever it is skipped
    assert bool(torch.isnan(td).any())
    for k in range(samples.shape[0]):
        want = reached_tiles(samples, k, h, w)
        assert want.any() == (k < 2) and not want.all()
        np.testing.assert_array_equal(~torch.isfinite(td[k]).numpy(), want)

    _, (h, w), _, _, (wv, wd, oy, ox, en) = run("short")
    assert h < thk.WINDOW and bool(en.any())
    assert bool((oy[en] == 0).all()) and bool((ox[en] == w - thk.WINDOW).any())
    assert float(wv.reshape(-1, thk.WINDOW, thk.WINDOW)[:, h:].abs().sum()) == 0
    # the d = inf sample of slot 0 is tested at its windows' cells past the grid
    past = wd.reshape(-1, en.shape[1], thk.WINDOW, thk.WINDOW)[:, :, h:]
    assert bool(torch.isnan(past[0][en[0]]).all()) and not bool(torch.isnan(past[1:]).any())

    _, _, (tv, td), (fv, fd), (wv, wd, _, _, en) = run("dead")
    assert not bool(en.any())
    assert all(float(t.abs().max()) == 0 for t in (tv, td, fv, fd, wv, wd))

    _, _, _, _, (wv, _, _, _, en) = run("multi")
    assert wv.shape[1] == 32 and 32 < int(en.sum()) < 3 * 32
