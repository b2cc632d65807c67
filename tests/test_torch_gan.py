"""Port parity: the GAN models (`posecnn_torch/models/gan.py`) and the GAN
train step (`engine/train.GanTrainStep`) against the JAX package on the CPU.

- `FeatureDiscriminator` at an even and an odd size (flax's asymmetric
  SAME padding at stride 2), and the DCGAN generator (flax's unflipped
  `ConvTranspose`, GroupNorm ε 1e-6, the NHWC Dense reshape) and
  discriminator, on JAX's weights carried by core/weights: within 1e-5
  of each output's largest entry; the key sets equal both ways;
- `gan_losses` within 1e-6 relative;
- the GAN step against `make_gan_train_step` on the dense and on the
  sparse vertex feed, at the GAN yaml's switches (seg + vertex) and
  rates, at keep_prob 1 (the JAX step fixes 0.5; its forward is run at 1
  here, since the port's dropout draws from `torch.Generator`s): one fp32
  step's losses within 1e-5 relative; then three steps in fp64 (the
  scores and vertex maps cast to fp32 in both models, as they are built),
  every loss within 1e-5 relative and every parameter of the generator
  and the discriminator within 1e-4 of its tensor's largest entry. In
  fp32 a ReLU or leaky-ReLU input within ~1e-6 of zero falls on either
  side in the two packages, and the step (vertex_w 10: the vertex loss
  doubles after the first update) carries that to ~1e-2 of the near-zero
  biases by step 3; in fp64 the two agree to ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_tpu.models import gan as jgan
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax, params_to_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models import gan as tgan
from posecnn_torch.models.posecnn import PoseCNN

torch.set_num_threads(1)
C, UNITS, H, W, B = 3, 8, 48, 64, 2
# shapenet_single_single_color_gan.yaml's switches and rates at toy widths
TRAIN = {"num_classes": C, "num_units": UNITS, "vertex_reg_2d": True, "pose_reg": False,
         "gan": True, "gan_weight": 0.1, "learning_rate": 2e-4, "vertex_w": 10.0}


def carried(jmodel, tmodel, *inputs, seed=0):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    flat = jckpt._flatten(params)
    tmodel.load_state_dict(params_from_jax(flat), strict=True)
    assert set(params_to_jax(tmodel.state_dict())) == set(flat)
    return params


def assert_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("size", [(24, 32), (23, 31)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_feature_discriminator_matches_flax(size):
    x = (np.random.RandomState(0).randn(2, *size, 3 * C + 3) * 50).astype(np.float32)
    jm, tm = jgan.FeatureDiscriminator(), tgan.FeatureDiscriminator(3 * C + 3)
    params = carried(jm, tm, x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, -(-size[0] // 4), -(-size[1] // 4), 1)
    assert_close(got, want, 1e-5)


def test_dcgan_pair_matches_flax():
    rng = np.random.RandomState(1)
    z = rng.randn(3, 16).astype(np.float32)
    jg, tg = jgan.DCGANGenerator(base_features=64), tgan.DCGANGenerator(16, base_features=64)
    params = carried(jg, tg, z)
    want = jax.jit(jg.apply)(params, jnp.asarray(z))
    got = tg(torch.from_numpy(z))
    assert got.shape == want.shape == (3, 64, 64, 3)
    assert_close(got, want, 1e-5)

    x = rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    jd, td = jgan.DCGANDiscriminator(base_features=16), tgan.DCGANDiscriminator(base_features=16)
    params = carried(jd, td, x, seed=2)
    want = jax.jit(jd.apply)(params, jnp.asarray(x))
    got = td(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 1)
    assert_close(got, want, 1e-5)


def test_gan_losses_match_jax():
    rng = np.random.RandomState(2)
    real, fake = (rng.randn(2, 6, 8, 1).astype(np.float32) * 4 for _ in range(2))
    want = jgan.gan_losses(jnp.asarray(real), jnp.asarray(fake))
    got = tgan.gan_losses(torch.from_numpy(real), torch.from_numpy(fake))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def toy_batch(dense):
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.minibatch(B, max_gt=8, dense_vertex_targets=dense)
    del batch["depth"]
    assert ("vertex_targets" in batch) == dense
    return batch, lib


def _losses_at_keep_prob_1(model, p, batch, cfg, points, extents, symmetry, drop_rng):
    """`engine/train._losses_with_vertex` with the forward at keep_prob 1."""
    out = model.apply(p, batch["data"], extents, batch["meta"], batch.get("gt_poses"),
                      batch.get("gt_valid"), train=True, keep_prob=1.0)
    total, metrics = jtrain._compose_losses_from_outputs(out, batch, cfg, points, extents,
                                                         symmetry)
    return total, metrics, out.vertex_pred


def run_both(dense, steps, f64):
    """`steps` GAN steps of each package from the same weights and batch:
    (JAX metrics a step, port metrics a step, JAX's final generator and
    discriminator state dicts, the port's)."""
    batch, lib = toy_batch(dense)
    jcfg, cfg = jax_cfg_from_dict({"train": TRAIN}), cfg_from_dict({"train": TRAIN})
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=32, pose_reg=False,
                        compute_dtype=jnp.float32)
    jdisc = jgan.FeatureDiscriminator()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ext = jnp.asarray(lib.extents)
    state = jtrain.create_gan_train_state(jcfg, jmodel, jdisc, jax.random.PRNGKey(0), jb, ext)
    model, disc = PoseCNN(C, num_units=UNITS, fc_dim=32, pose_reg=False), \
        tgan.FeatureDiscriminator(3 * C + 3)
    model.load_state_dict(params_from_jax(jckpt._flatten(state.params)), strict=True)
    disc.load_state_dict(params_from_jax(jckpt._flatten(state.d_params)), strict=True)
    dt = np.float64 if f64 else np.float32
    tdt = torch.float64 if f64 else torch.float32
    if f64:
        for mod in list(model.modules()) + list(disc.modules()):
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = tdt
        model, disc = model.double(), disc.double()
    host = {k: v.astype(dt) if v.dtype == np.float32 else v for k, v in batch.items()}
    geometry = [lib.points[:, :32], lib.extents, lib.symmetry]
    with jax.enable_x64(f64), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "_losses_with_vertex", _losses_at_keep_prob_1)
        if f64:
            jmodel = jmodel.clone(compute_dtype=jnp.float64)
            jdisc = jdisc.clone(compute_dtype=jnp.float64)
            state = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, state)
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        step = jtrain.make_gan_train_step(jcfg, jmodel, jdisc,
                                          *(jnp.asarray(a.astype(dt)) for a in geometry),
                                          donate=False)
        want = []
        for _ in range(steps):
            state, m = step(state, jb, jax.random.PRNGKey(0))
            want.append({k: float(v) for k, v in m.items()})
        jax_g = {k: np.asarray(v, np.float64) for k, v in
                 params_from_jax(jckpt._flatten(state.params)).items()}
        jax_d = {k: np.asarray(v, np.float64) for k, v in
                 params_from_jax(jckpt._flatten(state.d_params)).items()}
    tstate = ttrain.create_gan_train_state(cfg, model, disc)
    tstep = ttrain.make_gan_train_step(cfg, model, disc,
                                       *(torch.from_numpy(a).to(tdt) for a in geometry),
                                       keep_prob=1.0)
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    got = [{k: float(v) for k, v in tstep(tstate, tb).items()} for _ in range(steps)]
    assert tstate.step == steps
    return want, got, (jax_g, jax_d), (model.state_dict(), disc.state_dict())


@pytest.mark.parametrize("feed", ["dense", "sparse"])
def test_gan_step_losses_match_jax(feed):
    want, got, _, _ = run_both(feed == "dense", 1, f64=False)
    assert set(got[0]) == set(want[0]) == {"loss", "loss_cls", "loss_vertex", "loss_g_adv",
                                           "loss_d", "lr"}
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("feed", ["dense", "sparse"])
def test_gan_step_trajectory_matches_jax_in_fp64(feed):
    want, got, (jax_g, jax_d), (port_g, port_d) = run_both(feed == "dense", 3, f64=True)
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for jax_side, port_side in ((jax_g, port_g), (jax_d, port_d)):
        assert set(jax_side) == set(port_side)
        for name, w in jax_side.items():
            np.testing.assert_allclose(port_side[name].numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
