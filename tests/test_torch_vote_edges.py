"""Port parity at the edges of the coarse-to-fine vote: the port's plain
vote versions against the JAX package's Pallas kernels (interpret mode),
bit for bit, NaN where the Pallas kernel gives NaN.

The inputs are `chip_smoke.vote_edge_case`'s, made with numpy from a
seed: S of 1, 37, 300 and 1100 samples, a sample at d = inf that is
tested in some cells and one that is never tested, a coarse grid whose
last 1024-cell tile is ragged, windows clamped at the bottom-right and
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

# the child: both Pallas calls of every case, in interpret mode, saved
# to the .npz named by argv[1]
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
    flat = jhp.hough_votes_flat(samples, bboxes, cell_stride=4, grid_h=-(-h // 4),
                                grid_w=-(-w // 4), interpret=True)
    win = jhp.hough_votes_c2f_windows(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w,
                                      interpret=True, **opts)
    for i, a in enumerate(flat):
        out[f"{case}/flat/{i}"] = np.asarray(a)
    for i, a in enumerate(win):
        out[f"{case}/windows/{i}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """case -> {"flat": (votes, dsum), "windows": (votes_w, dsum_w, oy, ox, enable)}
    from the JAX package, as numpy."""
    path = tmp_path_factory.mktemp("pallas") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    data = np.load(path)
    return {case: {kind: tuple(data[f"{case}/{kind}/{i}"] for i in range(n))
                   for kind, n in (("flat", 2), ("windows", 5))} for case in EDGE_CASES}


def coarse_kw(height, width):
    return dict(cell_stride=4, grid_h=-(-height // 4), grid_w=-(-width // 4))


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


def test_edge_cases_reach_their_edges():
    """Each case exercises the edge it is named for."""
    def run(case):
        samples, bboxes, (h, w), opts = vote_edge_case(case)
        samples, bboxes = torch.from_numpy(samples), torch.from_numpy(bboxes)
        flat = thk.hough_votes_flat(samples, bboxes, **coarse_kw(h, w))
        win = thk.hough_votes_c2f_windows(samples, bboxes, cell_stride=1, grid_h=h, grid_w=w,
                                          **opts)
        return samples, (h, w), flat, win

    for case, s in (("s1", 1), ("s37", 37), ("s300", 300), ("s1100", 1100)):
        samples, _, (fv, _), (wv, *_) = run(case)
        assert samples.shape[2] == s and float(fv.max()) > 0 and float(wv.max()) > 0

    # 38x43 coarse cells: two tiles, the second ragged; 43 is odd
    _, (h, w), (fv, fd), (_, wd, *_) = run("inf_depth")
    assert coarse_kw(h, w)["grid_w"] % 2 and fv.shape[1] == 38 * 43 < 2 * thk.TILE
    nan = torch.isnan(fd[0])
    assert bool(nan[: thk.TILE].any()) and not bool(nan[thk.TILE:].any())
    assert bool(torch.isnan(wd[1]).any()) and not bool(torch.isnan(wd[2]).any())

    _, (h, w), _, (wv, wd, oy, ox, en) = run("short")
    assert h < thk.WINDOW and bool(en.any())
    assert bool((oy[en] == 0).all()) and bool((ox[en] == w - thk.WINDOW).any())
    assert float(wv.reshape(-1, thk.WINDOW, thk.WINDOW)[:, h:].abs().sum()) == 0
    # the d = inf sample of slot 0 is tested at its windows' cells past the grid
    past = wd.reshape(-1, en.shape[1], thk.WINDOW, thk.WINDOW)[:, :, h:]
    assert bool(torch.isnan(past[0][en[0]]).all()) and not bool(torch.isnan(past[1:]).any())

    _, _, (fv, fd), (wv, wd, _, _, en) = run("dead")
    assert not bool(en.any())
    assert all(float(t.abs().max()) == 0 for t in (fv, fd, wv, wd))

    _, _, _, (wv, _, _, _, en) = run("multi")
    assert wv.shape[1] == 32 and 32 < int(en.sum()) < 3 * 32
