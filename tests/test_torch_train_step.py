"""Port parity: the training step (posecnn_torch.models.posecnn.train_forward,
posecnn_torch.engine.train) against the JAX package on the CPU, fp32.

- the train-mode forward at keep_prob 1 against
  `model.apply(train=True, keep_prob=1.0)` (JAX Hough backend "xla", the
  port's "dense"), with the weights carried by core/weights;
- the loss terms and every parameter's gradient of
  `_compose_losses_from_outputs` against `jax.value_and_grad`;
- the optimizer against optax over 3 steps (momentum and adam, weight
  decay and clipping on and off), `lr_schedule` with `lr_step_offset`;
- dropout's keep rate, scale and determinism per (seed, step).

Tolerances: forward maps rtol 1e-4 / atol 1e-4 (as
tests/test_torch_posecnn.py); Hough rows as tests/test_torch_hough.py;
losses rtol 1e-4; gradients within 1e-3 of each parameter's largest
gradient entry (fp32 convolutions summed in another order through the
VGG16 trunk); parameters after each optimizer step rtol 1e-5 / atol 1e-6
(2e-5 of one step's learning rate: adam's divisions and the clip norm's
sum round in another order); learning rates rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.posecnn import PoseCNN, dropout

torch.set_num_threads(1)
C, UNITS, FC, S = 4, 8, 32, 64
H, W, B, MAX_GT = 64, 96, 2, 8
TRAIN = {"num_classes": C, "num_units": UNITS, "fc_dim": FC, "ims_per_batch": B,
         "vertex_reg_2d": True, "pose_reg": True, "gt_pose_rois": True, "symsize": 0,
         "hough_num_samples": S}


def toy_batch():
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.minibatch(B, max_gt=MAX_GT, dense_vertex_targets=False)
    del batch["depth"]
    return batch, lib


@pytest.fixture(scope="module")
def step_run():
    """JAX: forward outputs, loss terms and gradients at keep_prob 1. The
    port model with the same weights."""
    batch, lib = toy_batch()
    jcfg = jax_cfg_from_dict({"train": TRAIN})
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=S,
                        max_objects=2, gt_pose_rois=True, hough_backend="xla",
                        compute_dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ext = jnp.asarray(lib.extents)
    pts, sym = jtrain.loss_point_scale(jnp.asarray(lib.points[:, :64]), ext,
                                       jnp.asarray(lib.symmetry), jnp.asarray(True))
    params = jax.jit(lambda key: jmodel.init(key, jb["data"], ext, jb["meta"], train=False))(
        jax.random.PRNGKey(0))

    def loss_fn(p):
        out = jmodel.apply(p, jb["data"], ext, jb["meta"], jb["gt_poses"], jb["gt_valid"],
                           train=True, keep_prob=1.0)
        total, metrics = jtrain._compose_losses_from_outputs(out, jb, jcfg, pts, ext, sym)
        return total, (metrics, out)

    (_, (metrics, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2,
                    gt_pose_rois=True, hough_backend="dense")
    model.load_state_dict(params_from_jax(_flatten(params)), strict=True)
    return dict(batch=batch, lib=lib, out=out, metrics=metrics, model=model,
                grads=params_from_jax(_flatten(grads)), pts=np.array(pts), sym=np.array(sym))


def port_losses(r):
    cfg = cfg_from_dict({"train": TRAIN})
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    ext = torch.from_numpy(r["lib"].extents)
    r["model"].zero_grad(set_to_none=True)
    out = r["model"].train_forward(batch["data"], ext, batch["meta"], batch["gt_poses"],
                                   batch["gt_valid"], keep_prob=1.0)
    total, metrics = ttrain._compose_losses_from_outputs(
        out, batch, cfg, torch.from_numpy(r["pts"]), ext, torch.from_numpy(r["sym"]))
    return total, metrics, out


def test_train_forward_matches_jax(step_run):
    _, _, got = port_losses(step_run)
    want = step_run["out"]
    assert (got.label_2d.numpy() == np.asarray(want.label_2d)).all()
    for name in ("log_prob", "vertex_pred", "poses_pred", "poses_tanh"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert got.vertex_pred.shape == (B, H, W, 3 * C)
    for name in ("valid", "poses_target", "poses_weight", "domains"):
        np.testing.assert_array_equal(getattr(got.hough, name).numpy(),
                                      np.asarray(getattr(want.hough, name)), err_msg=name)
    for name in ("rois", "poses_init"):
        np.testing.assert_allclose(getattr(got.hough, name).numpy(),
                                   np.asarray(getattr(want.hough, name)), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    # GT rows first, then 9 rows per maximum
    assert got.hough.rois.shape[0] == MAX_GT + 9 * B * 2


def test_losses_and_gradients_match_jax(step_run):
    total, metrics, _ = port_losses(step_run)
    total.backward()
    want = step_run["metrics"]
    assert set(metrics) == set(want)
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert float(want["num_pose_rois"]) > 0 and float(want["loss_pose"]) > 0
    for name, p in step_run["model"].named_parameters():
        g, wg = p.grad.numpy(), step_run["grads"][name].numpy()
        scale = np.abs(wg).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-3 * scale, err_msg=name)


def optimizer_cfgs():
    for kind in ("momentum", "adam"):
        for wd in (0.0, 0.05):
            for clip in (0.0, 0.5):
                yield kind, wd, clip


@pytest.mark.parametrize("kind,weight_reg,grad_clip", list(optimizer_cfgs()))
def test_optimizer_matches_optax(kind, weight_reg, grad_clip):
    train = {"optimizer": kind, "learning_rate": 0.05, "momentum": 0.9, "gamma": 0.5,
             "stepsize": 2, "weight_reg": weight_reg, "grad_clip": grad_clip}
    rng = np.random.RandomState(9)
    shapes = {"conv": (3, 3, 2, 4), "dense": (5, 3), "bias": (4,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    jcfg = jax_cfg_from_dict({"train": train})
    opt = jtrain.create_optimizer(jcfg, params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttrain.create_optimizer(cfg_from_dict({"train": train}), list(tp.values()))
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())  # the update rewrites .grad in place
        topt.update()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    moved = max(np.abs(tp[k].numpy() - params[k]).max() for k in shapes)
    assert moved > 1e-3


@pytest.mark.parametrize("offset", [0, 3])
def test_lr_schedule_matches_optax(offset):
    train = {"learning_rate": 0.01, "gamma": 0.1, "stepsize": 4, "lr_step_offset": offset}
    want = jtrain.lr_schedule(jax_cfg_from_dict({"train": train}))
    got = ttrain.lr_schedule(cfg_from_dict({"train": train}))
    for count in range(10):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)
    assert got(4 - offset) == pytest.approx(0.001)


def test_dropout_keep_rate_scale_and_streams():
    x = torch.ones(200_000)
    gens = ttrain.dropout_generators(3, 7, "cpu")
    y = dropout(x, 0.5, gens[0])
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert dropout(x, 1.0, gens[1]) is x
    # the same (seed, step) gives the same masks; another step or stream does not
    again = dropout(x, 0.5, ttrain.dropout_generators(3, 7, "cpu")[0])
    assert torch.equal(again, y)
    other_step = dropout(x, 0.5, ttrain.dropout_generators(3, 8, "cpu")[0])
    other_stream = dropout(x, 0.5, ttrain.dropout_generators(3, 7, "cpu")[1])
    assert not torch.equal(other_step, y) and not torch.equal(other_stream, y)


def test_train_step_moves_the_parameters_and_counts_steps():
    batch, lib = toy_batch()
    cfg = cfg_from_dict({"train": dict(TRAIN, optimizer="adam", grad_clip=35.0)})
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2,
                    gt_pose_rois=True)
    from posecnn_torch.models.posecnn import init_weights

    init_weights(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_train_step(cfg, model, torch.from_numpy(lib.points[:, :64]),
                                  torch.from_numpy(lib.extents), torch.from_numpy(lib.symmetry))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        metrics = step(state, tb)
    assert state.step == 2 and state.opt.count == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert metrics["lr"] == pytest.approx(cfg.train.learning_rate)
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("override", [
    {"pose_reg": False}, {"vertex_reg_3d": True}, {"vertex_reg_2d": False, "pose_reg": False},
    {"gan": True}, {"max_host_rss_gb": 4.0}],
    ids=["seg_vertex", "vertex_3d", "seg_only", "gan", "host_rss_handoff"])
def test_switched_configurations_are_supported(override):
    """The head switches, the GAN step and the host-RSS handoff train
    (tests/test_torch_head_switches.py, tests/test_torch_gan.py and
    tests/test_torch_host_rss.py hold them to JAX)."""
    ttrain.check_supported(cfg_from_dict({"train": dict(TRAIN, **override)}))


def test_unsupported_configurations_raise():
    for override in ({"gan": True, "vertex_reg_2d": False, "vertex_reg_3d": False},):
        cfg = cfg_from_dict({"train": dict(TRAIN, **override)})
        with pytest.raises(NotImplementedError):
            ttrain.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="RGBX"):
        ttrain.check_supported(cfg_from_dict({"input": "RGBX", "train": TRAIN}))
    # the rest of the posecnn family trains (tests/test_torch_model_variants.py)
    for top, override in (({}, {"adapt": True}), ({}, {"matching": True}),
                          *(({"input": mode}, {}) for mode in ("RGBD", "DEPTH", "NORMAL"))):
        ttrain.check_supported(cfg_from_dict(dict(top, train=dict(TRAIN, **override))))
