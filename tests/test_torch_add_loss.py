"""Port parity: the ADD / ADD-S loss (posecnn_torch.ops.add_loss) and the
torch quaternion expansion against the JAX package's, value and
gradient (torch.autograd against jax.grad), and against the numpy mirror
of the reference CUDA kernel in tests/test_add_loss.py.

Tolerances: loss values rtol 1e-5; gradients rtol 1e-4 with an absolute
floor of 1e-6 of the gradient's largest entry; quat_to_mat rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops.add_loss import average_distance_loss as jax_add
from posecnn_tpu.utils.quaternion import quat_to_mat as jax_quat_to_mat
from posecnn_torch.ops.add_loss import average_distance_loss
from posecnn_torch.utils.quaternion import quat_normalize, quat_to_mat
from tests.test_add_loss import build_case, np_add_loss

torch.set_num_threads(1)


def make_case(name):
    """(pred, target, weight, points, symmetry, margin, num_valid) of a case."""
    rng = np.random.RandomState(11)
    margin, num_valid = 0.01, None
    if name == "mixed":  # plain and symmetric classes, a padded last row
        pred, tgt, wgt, pts, sym = build_case(rng, n=6, c=3, p=32, sym=(0, 1, 0))
    elif name == "symmetric":
        pred, tgt, wgt, pts, sym = build_case(rng, n=5, c=2, p=32, sym=(1, 1))
    elif name == "plain":
        pred, tgt, wgt, pts, sym = build_case(rng, n=5, c=2, p=32, sym=(0, 0))
    elif name == "rows_without_class":
        pred, tgt, wgt, pts, sym = build_case(rng, n=6, c=3, p=32, sym=(0, 1, 0))
        wgt[1:4] = 0.0  # three more rows with no active class
        num_valid = 2.0
    elif name == "hinge_inactive":  # prediction on target: every d² < margin
        _, tgt, wgt, pts, sym = build_case(rng, n=4, c=2, p=32, sym=(0, 1))
        pred = tgt + rng.randn(*tgt.shape).astype(np.float32) * 1e-4 * (wgt > 0)
    elif name == "hinge_partial":  # a margin inside the range of d²
        pred, tgt, wgt, pts, sym = build_case(rng, n=4, c=2, p=32, sym=(0, 1))
        margin = 0.004
    elif name == "nn_ties":  # a symmetric cloud with every point twice
        pred, tgt, wgt, pts, sym = build_case(rng, n=4, c=2, p=16, sym=(1, 1))
        pts = np.concatenate([pts, pts], axis=1)
    elif name == "raw_quaternions":  # unnormalised predictions and two active classes
        pred, tgt, wgt, pts, sym = build_case(rng, n=5, c=3, p=32, sym=(0, 1, 0))
        pred = pred * 1.7
        wgt[0, 8:12] = 1.0  # the first active class of row 0 still wins
    else:
        raise KeyError(name)
    return pred, tgt, wgt, pts, sym, margin, num_valid


CASES = ["mixed", "symmetric", "plain", "rows_without_class", "hinge_inactive",
         "hinge_partial", "nn_ties", "raw_quaternions"]


@pytest.mark.parametrize("name", CASES)
def test_value_and_gradient_match_jax(name):
    pred, tgt, wgt, pts, sym, margin, num_valid = make_case(name)

    def jax_loss(p):
        nv = None if num_valid is None else jnp.asarray(num_valid)
        return jax_add(p, jnp.asarray(tgt), jnp.asarray(wgt), jnp.asarray(pts),
                       jnp.asarray(sym), margin=margin, num_valid=nv)

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = average_distance_loss(
        x, torch.from_numpy(tgt), torch.from_numpy(wgt), torch.from_numpy(pts),
        torch.from_numpy(sym), margin=margin,
        num_valid=None if num_valid is None else torch.tensor(num_valid),
    )
    got.backward()
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-6 * max(np.abs(want_g).max(), 1e-12))
    if name == "hinge_inactive":
        assert float(want) == 0.0 and not want_g.any()
    else:
        assert float(want) > 0 and np.abs(want_g).max() > 0
    if name == "hinge_partial":
        assert 0 < (x.grad.numpy() != 0).sum()


@pytest.mark.parametrize("name", ["mixed", "rows_without_class", "hinge_partial"])
def test_value_matches_the_reference_kernel_mirror(name):
    pred, tgt, wgt, pts, sym, margin, num_valid = make_case(name)
    got = average_distance_loss(
        torch.from_numpy(pred), torch.from_numpy(tgt), torch.from_numpy(wgt),
        torch.from_numpy(pts), torch.from_numpy(sym), margin=margin,
        num_valid=torch.tensor(float(pred.shape[0])),
    )
    np.testing.assert_allclose(got.item(), np_add_loss(pred, tgt, wgt, pts, sym, margin),
                               rtol=2e-4, atol=1e-7)


def test_target_quaternion_gets_no_gradient():
    pred, tgt, wgt, pts, sym, margin, _ = make_case("mixed")
    q = torch.from_numpy(tgt).requires_grad_()
    loss = average_distance_loss(torch.from_numpy(pred), q, torch.from_numpy(wgt),
                                 torch.from_numpy(pts), torch.from_numpy(sym), margin=margin)
    assert not loss.requires_grad


def test_quat_to_mat_and_normalize_match_jax():
    q = np.random.RandomState(5).randn(7, 4).astype(np.float32) * 1.3
    np.testing.assert_allclose(quat_to_mat(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_quat_to_mat(jnp.asarray(q))), rtol=1e-6, atol=1e-7)
    n = quat_normalize(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(n, q / np.linalg.norm(q, axis=1, keepdims=True), rtol=1e-6)
