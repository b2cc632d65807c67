"""Port parity: the segmentation family (`FCN8`, `ResNet50Seg`) and its train
step against the JAX package on the CPU, fp32.

- the forward at 48×64 and at 40×72, where conv5_3 is 3×5 (odd: FCN8's
  SAME pool5 and both crops, ResNet50's asymmetric SAME stem and pool
  padding), with JAX's weights carried by core/weights: log-probs within
  1e-4, labels equal. ResNet50 runs at stage_sizes (1, 1, 1, 1) at both
  sizes and at its full (3, 4, 6, 3) once at 64×64. GroupNorm's variance
  is E[x²] − E[x]² in flax and a two-pass formula in torch: the two round
  apart by far less than the tolerance;
- checkpoints both ways: JAX params → `params_from_jax` → `params_to_jax`
  exact, and a port snapshot (`save_params`) restored by the JAX
  `restore_params` into its whole template, exact;
- the seg step (`make_seg_train_step`): every parameter's gradient within
  1e-3 of its largest entry, both packages in fp64 (see the test); FCN8
  with SGD momentum and ResNet50Seg with Adam, weight decay and clipping
  on, 3 fp32 steps each: the loss trajectory within 1e-4 relative.
"""

from typing import Any, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
import posecnn_tpu.models.resnet50 as jresnet
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.models.fcn8 import FCN8 as JaxFCN8
from posecnn_tpu.models.vgg16 import bilinear_upsample as jax_upsample
from posecnn_torch.core import checkpoint as tckpt
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax, params_to_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models import resnet50 as tresnet
from posecnn_torch.models.fcn8 import FCN8
from posecnn_torch.models.resnet50 import ResNet50Seg

torch.set_num_threads(1)
C, FC, UNITS, B = 4, 32, 8, 2
SIZES = ((48, 64), (40, 72))
SMALL = (1, 1, 1, 1)


class JaxResNet50Seg(jresnet.ResNet50Seg):
    """The JAX model with its trunk's `stage_sizes` exposed (its own
    `__call__` fixes (3, 4, 6, 3)); otherwise the same layers."""

    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        c3, c4 = jresnet.ResNet50Trunk(compute_dtype=self.compute_dtype,
                                       stage_sizes=self.stage_sizes, name="trunk")(x)
        s4 = nn.relu(nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype, name="score_c4")(c4))
        s3 = nn.relu(nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype, name="score_c3")(c3))
        s4_up = jax_upsample(s4, 2)[:, : s3.shape[1], : s3.shape[2], :]
        up = jax_upsample(s3 + s4_up, 8)
        logits = nn.Conv(self.num_classes, (1, 1), dtype=jnp.float32, name="score")(up)
        return jax.nn.log_softmax(logits, axis=-1), jnp.argmax(logits, -1).astype(jnp.int32)


def models(name, stage_sizes=SMALL):
    """(JAX model, port model) of one family at the test's widths, fp32."""
    if name == "fcn8":
        return JaxFCN8(num_classes=C, fc_dim=FC, compute_dtype=jnp.float32), FCN8(C, fc_dim=FC)
    return (JaxResNet50Seg(num_classes=C, num_units=UNITS, stage_sizes=stage_sizes),
            ResNet50Seg(C, num_units=UNITS, stage_sizes=stage_sizes))


def carried(name, x, stage_sizes=SMALL, seed=0):
    jm, tm = models(name, stage_sizes)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    return jm, tm, params


def images(h, w, seed=0):
    return (np.random.RandomState(seed).randn(B, h, w, 3) * 50).astype(np.float32)


def assert_forward_matches(jm, tm, params, x):
    want_lp, want_lab = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got_lp, got_lab = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


@pytest.mark.parametrize("name", ["fcn8", "resnet50_seg"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_jax(name, size):
    x = images(*size)
    assert_forward_matches(*carried(name, x), x)


def test_resnet50_full_depth_forward_matches_jax():
    x = images(64, 64, seed=1)
    assert_forward_matches(*carried("resnet50_seg", x, stage_sizes=(3, 4, 6, 3)), x)


@pytest.mark.parametrize("name", ["fcn8", "resnet50_seg"])
def test_checkpoints_round_trip_both_ways(name, tmp_path):
    x = images(48, 64)
    jm, tm, params = carried(name, x, seed=3)
    flat = jckpt._flatten(params)
    back = params_to_jax(params_from_jax(flat), tm.JAX_TRUNK)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # a port snapshot fills the JAX template whole
    path = str(tmp_path / "seg_iter_5.npz")
    tckpt.save_params(path, tm, step=5)
    template = jm.init(jax.random.PRNGKey(9), jnp.asarray(x))
    restored, step = jckpt.restore_params(path, template, verbose=False)
    assert step == 5
    for key, value in jckpt._flatten(restored).items():
        np.testing.assert_array_equal(np.asarray(value), flat[key], err_msg=key)


def seg_batch():
    lib = synthetic_class_library(C, 256)
    h, w = SIZES[0]
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=w, height=h, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    b = gen.minibatch(B, dense_vertex_targets=False)
    return {"data": b["data"], "label": b["label"].astype(np.int32)}


@pytest.mark.parametrize("name", ["fcn8", "resnet50_seg"])
def test_seg_step_gradients_match_jax(name, monkeypatch):
    """Every parameter's gradient of the seg loss, both packages in fp64
    (JAX under `jax.enable_x64`; the ResNet50 score layer stays fp32 in
    both, as the JAX model pins it). In fp32 a ReLU input within ~1e-6 of
    zero (one in ~1e5 at this size) can fall on either side in the two
    packages and move every gradient below it by ~1e-3; in fp64 the two
    agree on every kink. The GroupNorms, which the JAX model pins to fp32,
    run in fp64 on both sides (on their inputs rounded to fp32, as the
    model rounds them): flax's E[x²] − E[x]² differentiated in fp32
    cancels, by 10% of the stem's gradient at this size, where torch's
    two-pass GroupNorm does not."""
    orig_gn = jresnet.nn.GroupNorm

    def gn64(*args, dtype=None, **kw):
        return orig_gn(*args, dtype=jnp.float64, **kw)

    def group_norm64(x, layer, dtype):
        return torch.nn.functional.group_norm(x.float().double(), layer.num_groups,
                                              layer.weight, layer.bias, layer.eps).to(dtype)

    batch = seg_batch()
    jm, tm, params = carried(name, batch["data"], seed=5)
    monkeypatch.setattr(jresnet.nn, "GroupNorm", gn64)
    monkeypatch.setattr(tresnet, "group_norm", group_norm64)
    with jax.enable_x64(True):
        jm64 = jm.clone(compute_dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
        data, label = jnp.asarray(batch["data"], jnp.float64), jnp.asarray(batch["label"])

        def jloss(p):
            log_prob, _ = jm64.apply(p, data, train=True)
            onehot = jax.nn.one_hot(label, C, dtype=log_prob.dtype)
            return -jnp.sum(onehot * log_prob) / (jnp.sum(onehot) + 1e-10)

        want = {k: np.asarray(v, np.float64) for k, v in
                params_from_jax(jckpt._flatten(jax.grad(jloss)(p64))).items()}
    for mod in tm.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    tm = tm.double()
    cfg = cfg_from_dict({"network": name, "train": {"num_classes": C}})
    step = ttrain.make_seg_train_step(cfg, tm)
    total, _ = step.forward(ttrain.create_train_state(cfg, tm),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    step.backward(total)
    for pname, p in tm.named_parameters():
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()  # stage 4 feeds nothing
        w = want[pname]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-12),
                                   err_msg=pname)


@pytest.mark.parametrize("name,optimizer", [("fcn8", "momentum"), ("resnet50_seg", "adam")])
def test_seg_step_trajectory_matches_jax(name, optimizer):
    """Three fp32 steps of each package's seg step from the same weights:
    the losses within 1e-4 relative."""
    batch = seg_batch()
    train = {"num_classes": C, "optimizer": optimizer, "learning_rate": 1e-3, "momentum": 0.9,
             "weight_reg": 1e-4, "grad_clip": 5.0, "fc_dim": FC, "num_units": UNITS}
    top = {"network": name, "compute_dtype": "float32"}
    jcfg = jax_cfg_from_dict(dict(top, train=train))
    cfg = cfg_from_dict(dict(top, train=train))
    jm, tm, params = carried(name, batch["data"], seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                              jnp.zeros((), jnp.int32))
    jstep = jtrain.make_seg_train_step(jcfg, jm, donate=False)
    want = []
    for _ in range(3):
        state, metrics = jstep(state, jb, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    tstate = ttrain.create_train_state(cfg, tm)
    step = ttrain.make_seg_train_step(cfg, tm)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [float(step(tstate, tb)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tstate.step == 3 and got[-1] != got[0]
