"""Port parity: the embedding losses (`ops/embedding_losses.py`) and the
voxel ops (`ops/voxel.py`) against the JAX package on the CPU, fp32.

- `triplet_loss` with JAX's own draw (anchors and the 8 candidates of
  `jax.random`, split as the JAX function splits its key) fed to the
  port: within 1e-6 relative, at several class mixes; the port's own
  `torch.Generator` draw gives a finite loss that falls to 0 on separated
  embeddings;
- `lifted_structured_loss` (the dense Gram form) and its gradient within
  1e-5 relative;
- `backproject` (features, labels, flags), `project` and `compute_label`
  on a batch of two frames with different cameras and poses, depth holes
  and voxels behind the camera: equal within 1e-6 (the same gathers and
  the same sums in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops import embedding_losses as jemb
from posecnn_tpu.ops import voxel as jvox
from posecnn_torch.ops import embedding_losses as temb
from posecnn_torch.ops import voxel as tvox

torch.set_num_threads(1)
N, DIM, T = 96, 5, 48
B, H, W, FEAT, LAB, G = 2, 20, 24, 4, 3, 8


def jax_draws(key, n, num_triplets):
    """The draw `posecnn_tpu.ops.embedding_losses.triplet_loss` makes."""
    ra, rp, rn = jax.random.split(key, 3)
    draws = (jax.random.randint(ra, (num_triplets,), 0, n),
             jax.random.randint(rp, (num_triplets, temb.CANDIDATES), 0, n),
             jax.random.randint(rn, (num_triplets, temb.CANDIDATES), 0, n))
    return [torch.from_numpy(np.array(d)).long() for d in draws]


@pytest.mark.parametrize("num_classes", [1, 2, 6])
def test_triplet_loss_matches_jax_on_its_draw(num_classes):
    rng = np.random.RandomState(num_classes)
    emb = rng.randn(N, DIM).astype(np.float32)
    labels = rng.randint(0, num_classes, N)
    key = jax.random.PRNGKey(7)
    want = float(jemb.triplet_loss(jnp.asarray(emb), jnp.asarray(labels), key,
                                   num_triplets=T, margin=0.5))
    got = float(temb.triplet_loss(torch.from_numpy(emb), torch.from_numpy(labels),
                                  draws=jax_draws(key, N, T), margin=0.5))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_triplet_loss_own_draw():
    labels = np.repeat([0, 1], N // 2)
    good = np.concatenate([np.tile([5.0, 0.0], (N // 2, 1)), np.tile([-5.0, 0.0], (N // 2, 1))])
    bad = np.random.RandomState(0).randn(N, 2)
    losses = []
    for emb in (good, bad):
        g = torch.Generator().manual_seed(0)
        losses.append(float(temb.triplet_loss(torch.tensor(emb, dtype=torch.float32),
                                              torch.from_numpy(labels), g, num_triplets=T)))
    assert losses[0] == 0.0 and np.isfinite(losses[1]) and losses[1] > 0


def test_lifted_structured_loss_and_gradient_match_jax():
    rng = np.random.RandomState(3)
    emb = rng.randn(N, DIM).astype(np.float32)
    labels = rng.randint(0, 4, N)
    want, want_g = jax.value_and_grad(
        lambda e: jemb.lifted_structured_loss(e, jnp.asarray(labels), margin=1.0))(
        jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_()
    got = temb.lifted_structured_loss(e, torch.from_numpy(labels), margin=1.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_g)).max())


def scene():
    """Two frames: their own intrinsics and world↔camera poses, a voxel
    grid around z = 1, depth with holes, random features and labels."""
    rng = np.random.RandomState(0)
    meta = np.zeros((B, 48), np.float32)
    for b in range(B):
        k = np.array([[30.0 + 5 * b, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
        a = 0.15 * b
        r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32)
        t = np.array([0.03 * b, -0.02, 0.05], np.float32)
        meta[b, :9], meta[b, 9:18] = k.ravel(), np.linalg.inv(k).ravel()
        meta[b, 18:30] = np.concatenate([r, t[:, None]], 1).ravel()
        meta[b, 30:42] = np.concatenate([r.T, (-r.T @ t)[:, None]], 1).ravel()
        meta[b, 42:45], meta[b, 45:48] = 0.1, [-0.4, -0.4, 0.6]
    # a few voxels sit behind the camera: projections that must be dropped
    meta[1, 47] = -0.2
    depth = (0.9 + 0.4 * rng.rand(B, H, W)).astype(np.float32)
    depth[0, :3] = 0.0
    depth[1, :, -4:] = 0.0
    feats = rng.rand(B, H, W, FEAT).astype(np.float32)
    labels = rng.rand(B, H, W, LAB).astype(np.float32)
    labels_3d = rng.rand(B, G, G, G, LAB).astype(np.float32)
    return feats, labels, labels_3d, depth, meta


@pytest.mark.parametrize("kernel_size", [0, 1])
def test_backproject_matches_jax(kernel_size):
    arrays = scene()
    want = jvox.backproject(*map(jnp.asarray, arrays), grid_size=G, kernel_size=kernel_size,
                            threshold=0.1)
    got = tvox.backproject(*map(torch.from_numpy, arrays), grid_size=G,
                           kernel_size=kernel_size, threshold=0.1)
    for name, g, w in zip(("data", "label", "flag"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    flag = np.asarray(want[2])
    assert 0 < flag.sum() < flag.size  # some voxels hit, some keep their labels


def test_project_and_compute_label_match_jax():
    _, _, labels_3d, depth, meta = scene()
    vox = np.random.RandomState(1).rand(B, G, G, G, LAB).astype(np.float32)
    want = np.asarray(jvox.project(jnp.asarray(vox), jnp.asarray(depth), jnp.asarray(meta)))
    got = tvox.project(torch.from_numpy(vox), torch.from_numpy(depth), torch.from_numpy(meta))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want != 0).any(-1).mean() < 1  # pixels inside and outside the grid
    want_l = np.asarray(jvox.compute_label(jnp.asarray(labels_3d), jnp.asarray(depth),
                                           jnp.asarray(meta)))
    got_l = tvox.compute_label(torch.from_numpy(labels_3d), torch.from_numpy(depth),
                               torch.from_numpy(meta))
    np.testing.assert_array_equal(got_l.numpy(), want_l)
