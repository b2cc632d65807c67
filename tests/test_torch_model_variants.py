"""Port parity: the rest of the posecnn family against the JAX package on
the CPU, fp32: the RGBD dual tower, `DomainHead` behind gradient
reversal, the matching loss, the training step with each of them, their
checkpoints both ways, and `fastforward_opt_counts`.

- the RGBD eval forward against `PoseCNN(input_format="RGBD")`'s, with
  the weights carried by core/weights (JAX Hough backend "xla", the
  port's "dense"). The port runs the two towers as one trunk call on the
  (2B) batch: VGG16 has no batch statistics, so each image's features are
  those of its own call, which the forward's agreement with JAX's two
  calls shows;
- `DomainHead` logits and the gradient they send back through the
  reversal, and the reversal's backward, −λ·g;
- the matching loss and its gradient in the pose, per RoI (JAX vmaps
  `matching_loss`; the port batches the RoIs);
- a train step at keep_prob 1 for RGBD, adapt and matching: every loss
  term of `_compose_losses_from_outputs` and every parameter's gradient
  against `jax.value_and_grad`;
- an RGBD + domain-head checkpoint written by either package restored by
  the other, bit for bit;
- `fastforward_opt_counts` against the JAX function over 3 updates.

The JAX `DomainHead` is built by `PoseCNN` without the model's
compute_dtype (bf16 by default); the test subclasses it to fp32 like the
rest of its model, as the port's follows the model's dtype.

Tolerances are tests/test_torch_train_step.py's: forward maps rtol 1e-4
/ atol 1e-4; Hough rows as there; losses rtol 1e-4; gradients within 1e-3
of each parameter's largest gradient entry; parameters after optimizer
steps rtol 1e-5 / atol 1e-6. Matching losses rtol 1e-5, their pose
gradients within 1e-4 of the largest entry; domain logits rtol 1e-5.
"""

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
import posecnn_tpu.models.posecnn as jposecnn
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.ops.gradient_reversal import gradient_reversal as jax_gradient_reversal
from posecnn_tpu.ops.matching_loss import matching_loss as jax_matching_loss
from posecnn_torch.core import checkpoint as tckpt
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.posecnn import DomainHead, PoseCNN, init_weights
from posecnn_torch.ops.gradient_reversal import gradient_reversal
from posecnn_torch.ops.matching_loss import matching_loss

torch.set_num_threads(1)
C, UNITS, FC, S = 4, 8, 32, 64
H, W, B, MAX_GT = 64, 96, 2, 8
MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)
TRAIN = {"num_classes": C, "num_units": UNITS, "fc_dim": FC, "ims_per_batch": B,
         "vertex_reg_2d": True, "pose_reg": True, "gt_pose_rois": True, "symsize": 0,
         "hough_num_samples": S}
VARIANTS = {
    "rgbd": ({"input": "RGBD"}, {}),
    "adapt": ({}, {"adapt": True, "adapt_weight": 0.1}),
    "matching": ({}, {"matching": True}),
}


class DomainHead32(jposecnn.DomainHead):
    """The JAX head in fp32, like the rest of the test's JAX model."""

    compute_dtype: Any = jnp.float32


def toy_batch(rgbd):
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.minibatch(B, max_gt=MAX_GT, dense_vertex_targets=False)
    if rgbd:
        # the training feed's RGBD tower input from the render's depth
        batch["data_p"] = np.stack([
            np.tile((d / max(float(d.max()), 1e-6) * 255.0)[:, :, None], (1, 1, 3)) - MEANS
            for d in batch["depth"]]).astype(np.float32)
    del batch["depth"]
    return batch, lib


def models(variant):
    top, train = VARIANTS[variant]
    rgbd, adapt = top.get("input") == "RGBD", train.get("adapt", False)
    kw = dict(num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2,
              gt_pose_rois=True, adaptation=adapt, input_format="RGBD" if rgbd else "COLOR")
    jmodel = jposecnn.PoseCNN(num_classes=C, hough_backend="xla", compute_dtype=jnp.float32, **kw)
    return jmodel, PoseCNN(C, hough_backend="dense", **kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def step_run(request):
    """JAX: forward outputs, loss terms and gradients at keep_prob 1, and
    the port model with the same weights."""
    variant = request.param
    top, train = VARIANTS[variant]
    batch, lib = toy_batch("input" in top)
    jcfg = jax_cfg_from_dict(dict(top, train=dict(TRAIN, **train)))
    jmodel, model = models(variant)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ext = jnp.asarray(lib.extents)
    pts, sym = jtrain.loss_point_scale(jnp.asarray(lib.points[:, :128]), ext,
                                       jnp.asarray(lib.symmetry), jnp.asarray(True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jposecnn, "DomainHead", DomainHead32)
        params = jax.jit(lambda key: jmodel.init(key, jb["data"], ext, jb["meta"],
                                                 data_p=jb.get("data_p"), train=False))(
            jax.random.PRNGKey(0))

        def loss_fn(p):
            out = jmodel.apply(p, jb["data"], ext, jb["meta"], jb["gt_poses"], jb["gt_valid"],
                               data_p=jb.get("data_p"), train=True, keep_prob=1.0)
            total, metrics = jtrain._compose_losses_from_outputs(out, jb, jcfg, pts, ext, sym)
            return total, (metrics, out)

        (_, (metrics, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        eval_out = jax.jit(lambda p: jmodel.apply(p, jb["data"], ext, jb["meta"],
                                                  data_p=jb.get("data_p"), train=False))(params)
    model.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    return dict(variant=variant, batch=batch, lib=lib, out=out, eval_out=eval_out,
                metrics=metrics, model=model, grads=params_from_jax(jckpt._flatten(grads)),
                pts=np.array(pts), sym=np.array(sym), cfg=cfg_from_dict(dict(top, train=dict(
                    TRAIN, **train))))


def port_losses(r):
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    ext = torch.from_numpy(r["lib"].extents)
    r["model"].zero_grad(set_to_none=True)
    return ttrain.compute_losses(r["model"], batch, r["cfg"], torch.from_numpy(r["pts"]), ext,
                                 torch.from_numpy(r["sym"]), keep_prob=1.0)


def test_eval_forward_matches_jax(step_run):
    r = step_run
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    got = r["model"](batch["data"], torch.from_numpy(r["lib"].extents), batch["meta"],
                     data_p=batch.get("data_p"), full_vertex=True)
    want = r["eval_out"]
    assert (got.label_2d.numpy() == np.asarray(want.label_2d)).all()
    for name in ("log_prob", "vertex_pred", "poses_pred"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.hough.valid.numpy(), np.asarray(want.hough.valid))
    np.testing.assert_allclose(got.hough.rois.numpy(), np.asarray(want.hough.rois),
                               rtol=1e-5, atol=1e-4)
    assert (got.domain_logits is None) == (want.domain_logits is None)
    if want.domain_logits is not None:
        np.testing.assert_allclose(got.domain_logits.numpy(), np.asarray(want.domain_logits),
                                   rtol=1e-4, atol=1e-4)
    if r["variant"] == "rgbd":
        assert r["model"].seg_head.score_conv4.in_channels == 1024
        assert r["model"].pose_head.fc6.in_features == 7 * 7 * 1024


def test_train_step_losses_and_gradients_match_jax(step_run):
    r = step_run
    total, metrics = port_losses(r)
    total.backward()
    want = r["metrics"]
    assert set(metrics) == set(want)
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    extra = {"rgbd": None, "adapt": "loss_domain", "matching": "loss_match"}[r["variant"]]
    if extra:
        assert float(want[extra]) > 0, extra
    assert float(want["num_pose_rois"]) > 0
    for name, p in r["model"].named_parameters():
        g, wg = p.grad.numpy(), r["grads"][name].numpy()
        scale = np.abs(wg).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-3 * scale, err_msg=name)


def test_domain_head_and_gradient_reversal_match_jax():
    rng = np.random.RandomState(0)
    pooled = rng.randn(6, 3, 3, 16).astype(np.float32)
    cot = rng.randn(6, 2).astype(np.float32)
    jhead = DomainHead32(lambda_=0.01)
    params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(pooled), train=False)

    def f(x, p):
        return jnp.sum(jhead.apply(p, x, train=False) * cot)

    want = jhead.apply(params, jnp.asarray(pooled), train=False)
    want_grad = jax.grad(f)(jnp.asarray(pooled), params)
    flat = {f"params/domain_head/{k[len('params/'):]}": v
            for k, v in jckpt._flatten(params).items()}
    head = DomainHead(3 * 3 * 16)
    head.load_state_dict({k.removeprefix("domain_head."): v
                          for k, v in params_from_jax(flat).items()}, strict=True)
    x = torch.from_numpy(pooled).requires_grad_()
    got = head(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-8)
    # the reversal alone: identity forward, −λ·g backward, as the JAX vjp
    g = rng.randn(5, 7).astype(np.float32)
    v = torch.from_numpy(rng.randn(5, 7).astype(np.float32)).requires_grad_()
    y = gradient_reversal(v, 0.3)
    assert torch.equal(y, v)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(v.grad.numpy(), -0.3 * g)
    _, vjp = jax.vjp(lambda a: jax_gradient_reversal(a, 0.3), jnp.asarray(v.detach().numpy()))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_matching_loss_and_its_gradient_match_jax_per_roi():
    rng = np.random.RandomState(3)
    r, p, h, w = 5, 64, 12, 16
    q = rng.randn(r, 4).astype(np.float32)
    t = np.stack([rng.uniform(-0.05, 0.05, r), rng.uniform(-0.05, 0.05, r),
                  rng.uniform(0.6, 1.0, r)], 1).astype(np.float32)
    pts = (rng.randn(r, p, 3) * 0.04).astype(np.float32)
    k = np.tile(np.array([[18.0, 0, w / 2], [0, 18.0, h / 2], [0, 0, 1]], np.float32), (r, 1, 1))
    mask = (rng.rand(r, h, w) > 0.7).astype(np.float32)
    mask[:, 4:9, 5:11] = 1.0

    def jloss(qq, tt):
        return jax.vmap(jax_matching_loss)(qq, tt, jnp.asarray(mask), jnp.asarray(pts),
                                           jnp.asarray(k))

    want = jloss(jnp.asarray(q), jnp.asarray(t))
    wq, wt = jax.grad(lambda a, b: jnp.sum(jloss(a, b) * jnp.arange(1.0, r + 1)),
                      argnums=(0, 1))(jnp.asarray(q), jnp.asarray(t))
    tq, tt = torch.from_numpy(q).requires_grad_(), torch.from_numpy(t).requires_grad_()
    got = matching_loss(tq, tt, torch.from_numpy(mask), torch.from_numpy(pts), torch.from_numpy(k))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert 0 < float(got.detach().min()) and float(got.detach().max()) < 1
    (got * torch.arange(1.0, r + 1)).sum().backward()
    for g_, w_ in ((tq.grad, wq), (tt.grad, wt)):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=1e-4 * np.abs(w_).max())


def test_rgbd_domain_head_checkpoints_restore_both_ways(tmp_path):
    jmodel, model = models("rgbd")
    jmodel = jmodel.clone(adaptation=True)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, adaptation=True, input_format="RGBD")
    batch, lib = toy_batch(True)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(batch["data"]),
                         jnp.asarray(lib.extents), jnp.asarray(batch["meta"]),
                         data_p=jnp.asarray(batch["data_p"]), train=False)
    assert "domain_head" in params["params"]
    path = str(tmp_path / "jax_iter_5.npz")
    jckpt.save_params(path, params, step=5)
    assert tckpt.restore_params(path, model) == 5
    again = str(tmp_path / "port_iter_5.npz")
    tckpt.save_params(again, model, step=5)
    a, b = np.load(path), np.load(again)
    assert set(a.files) == set(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    init_weights(model, 9)
    tckpt.save_params(again, model, step=6)
    restored, step = jckpt.restore_params(again, params, verbose=False)
    assert step == 6
    got = params_from_jax(jckpt._flatten(jax.device_get(restored)))
    for name, value in model.state_dict().items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_fastforward_opt_counts_matches_jax(kind):
    train = {"optimizer": kind, "learning_rate": 0.5, "momentum": 0.9, "gamma": 0.1,
             "stepsize": 10, "weight_reg": 0.01, "grad_clip": 0.0}
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(3, 2).astype(np.float32), "b": rng.randn(2).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = jtrain.create_optimizer(jax_cfg_from_dict({"train": train}), params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jtrain.fastforward_opt_counts(opt.init(jp), 19)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttrain.fastforward_opt_counts(
        ttrain.create_optimizer(cfg_from_dict({"train": train}), list(tp.values())), 19)
    lrs = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        lrs.append(topt.update())
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # the staircase on the global step: 19 is decayed once, 20 and 21 twice
    np.testing.assert_allclose(lrs, [0.05, 0.005, 0.005], rtol=1e-6)
    assert topt.count == 22
