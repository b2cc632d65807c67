"""Port parity: the coarse-to-fine vote at the tunings of the JAX repo's
c2f sweep (`experiments/bench_graph_phases.py:154-159`): coarse factor
4 or 8, 4 or 2 refine windows a slot.

The JAX side runs its Pallas kernels in interpret mode; the port's plain
versions run on the CPU. Tolerances are those of tests/test_torch_hough.py:
votes rtol 1e-5, dsum rtol 1e-5 / atol 1e-6, origins, enables and the
picked cell exact. The CUDA kernels are held to the plain versions at the
same tunings in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_torch import bench
from posecnn_torch.ops import hough_kernels as thk
from tests.test_hough_voting import H, W
from tests.test_torch_hough import jhp, packed_inputs

torch.set_num_threads(1)

TUNINGS = [(4, 4), (8, 4), (4, 2), (8, 2)]  # (coarse_factor, top_t)


def test_tunings_are_the_jax_sweeps():
    assert [(kw["coarse_factor"], kw["top_t"]) for _, kw in bench.C2F_TUNINGS] == TUNINGS
    assert [name for name, _ in bench.C2F_TUNINGS] == [
        "c2f_default_f4_t4", "c2f_f8_t4", "c2f_f4_t2", "c2f_f8_t2"]


@pytest.mark.parametrize("factor, top_t", TUNINGS)
@pytest.mark.parametrize("name", ["single", "two", "small_edge", "corner_three"])
def test_c2f_at_each_tuning_matches_jax(name, factor, top_t):
    samples, bboxes = packed_inputs(name)
    kw = dict(cell_stride=1, grid_h=H, grid_w=W, top_t=top_t, coarse_factor=factor)
    js, jb = jnp.asarray(samples), jnp.asarray(bboxes)
    ts, tb = torch.from_numpy(samples), torch.from_numpy(bboxes)
    j_win = jhp.hough_votes_c2f_windows(js, jb, interpret=True, **kw)
    t_win = thk.hough_votes_c2f_windows(ts, tb, **kw)
    assert t_win[0].shape == (samples.shape[0], top_t, thk.TILE)
    for got, want in zip(t_win[2:], j_win[2:]):  # origins and enable: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(t_win[0].numpy(), np.asarray(j_win[0]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_win[1].numpy(), np.asarray(j_win[1]), rtol=1e-5, atol=1e-6)

    jbest = jhp.hough_votes_c2f(js, jb, interpret=True, **kw)
    tbest = thk.hough_votes_c2f(ts, tb, **kw)
    np.testing.assert_allclose(tbest[0].numpy(), np.asarray(jbest[0]), rtol=1e-5)
    np.testing.assert_allclose(tbest[1].numpy(), np.asarray(jbest[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tbest[2].numpy(), np.asarray(jbest[2]))
    np.testing.assert_array_equal(tbest[3].numpy(), np.asarray(jbest[3]))


def test_default_tuning_is_unchanged():
    """The knobs' defaults are (top_t 4, coarse factor 4): the call without
    them gives the same bits as the call that names them."""
    samples, bboxes = (torch.from_numpy(a) for a in packed_inputs("two"))
    kw = dict(cell_stride=1, grid_h=H, grid_w=W)
    for a, b in zip(thk.hough_votes_c2f(samples, bboxes, **kw),
                    thk.hough_votes_c2f(samples, bboxes, top_t=4, coarse_factor=4, **kw)):
        assert torch.equal(a, b)
