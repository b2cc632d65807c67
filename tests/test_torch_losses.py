"""Port parity: the training losses (posecnn_torch.ops.hard_label and
ops.losses) against the JAX package's, on inputs made from a seed.

Tolerances: hard_label and build_vertex_targets' class-feature pick are
exact (the JAX computation picks values, it does not round them): the
weights and log-depth channels bit for bit; the unit directions within
2.4e-7 (2 ulp of 1), since XLA:CPU contracts dx·dx + dy·dy into an FMA.
The losses are sums of the same fp32 terms in another order, held to
rtol 1e-6; their gradients to rtol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jhl = importlib.import_module("posecnn_tpu.ops.hard_label")
jl = importlib.import_module("posecnn_tpu.ops.losses")
from posecnn_torch.ops import losses as tl
from posecnn_torch.ops.hard_label import hard_label

torch.set_num_threads(1)
B, H, W, C = 2, 12, 16, 5


def prob_and_label(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, W, C).astype(np.float32) * 3.0
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    label = rng.randint(-1, C, (B, H, W)).astype(np.int32)  # -1: ignored pixels
    return logits, prob.astype(np.float32), label


@pytest.mark.parametrize("threshold", [1.0, 0.5, 0.05])
def test_hard_label_matches_jax(threshold):
    _, prob, label = prob_and_label(0)
    want = np.asarray(jhl.hard_label(jnp.asarray(prob), jnp.asarray(label), threshold))
    got = hard_label(torch.from_numpy(prob), torch.from_numpy(label), threshold)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < B * H * W


def test_cross_entropy_matches_jax_value_and_grad():
    logits, prob, label = prob_and_label(1)
    weights = np.array(jhl.hard_label(jnp.asarray(prob), jnp.asarray(label), 0.7))

    def jax_loss(x):
        return jl.loss_cross_entropy_single_frame(jax.nn.log_softmax(x, -1), jnp.asarray(weights))

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tl.loss_cross_entropy_single_frame(torch.log_softmax(x, -1), torch.from_numpy(weights))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_vertex_matches_jax_value_and_grad(sigma):
    rng = np.random.RandomState(2)
    pred = rng.randn(B, H, W, 3 * C).astype(np.float32)
    target = rng.randn(B, H, W, 3 * C).astype(np.float32) * 0.5
    weight = (rng.rand(B, H, W, 3 * C) > 0.6).astype(np.float32) * 10.0
    want, want_g = jax.value_and_grad(
        lambda p: jl.smooth_l1_loss_vertex(p, jnp.asarray(target), jnp.asarray(weight), sigma)
    )(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = tl.smooth_l1_loss_vertex(x, torch.from_numpy(target), torch.from_numpy(weight), sigma)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-9)


def test_build_vertex_targets_matches_jax():
    """Centres up to 600 px, labels out of range on both sides, an
    absent class: the gather must pick what the HIGHEST-precision
    product picks."""
    rng = np.random.RandomState(3)
    label = rng.randint(-1, C + 2, (B, H, W)).astype(np.int32)
    centers = rng.uniform(-50, 600, (B, C, 2)).astype(np.float32)
    log_z = rng.uniform(-1, 1, (B, C)).astype(np.float32)
    valid = rng.rand(B, C) > 0.3
    valid[:, 2] = False
    want = jl.build_vertex_targets(jnp.asarray(label), jnp.asarray(centers), jnp.asarray(log_z),
                                   jnp.asarray(valid), weight_inside=7.0)
    got = tl.build_vertex_targets(torch.from_numpy(label), torch.from_numpy(centers),
                                  torch.from_numpy(log_z), torch.from_numpy(valid),
                                  weight_inside=7.0)
    targets, weights = got[0].numpy(), got[1].numpy()
    want_t, want_w = np.asarray(want[0]), np.asarray(want[1])
    assert targets.shape == weights.shape == (B, H, W, 3 * C)
    np.testing.assert_array_equal(weights, want_w)
    np.testing.assert_array_equal(targets[..., 2::3], want_t[..., 2::3])  # log depth
    np.testing.assert_allclose(targets, want_t, rtol=0, atol=2.4e-7)
    assert want_w.any() and (want_t[..., 2::3] != 0).any()


def test_build_vertex_targets_matches_the_host_path():
    """The same maps as the generator's dense host targets (the contract
    the JAX version is held to in its own tests)."""
    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator

    lib = synthetic_class_library(C, 256)
    k = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=64, height=48, seed=5)
    sample = gen.render(dense_vertex_targets=True)
    t, w = tl.build_vertex_targets(
        torch.from_numpy(sample.label[None]), torch.from_numpy(sample.vertex_centers[None]),
        torch.from_numpy(sample.vertex_logz[None]), torch.from_numpy(sample.vertex_valid[None]),
    )
    np.testing.assert_allclose(t[0].numpy(), sample.vertex_targets, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(w[0].numpy(), sample.vertex_weights)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(9, 2).astype(np.float32) * 4.0
    labels = rng.randint(0, 2, 9).astype(np.int32)
    want = jl.softmax_cross_entropy_with_logits(jnp.asarray(logits), jnp.asarray(labels))
    got = tl.softmax_cross_entropy_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
