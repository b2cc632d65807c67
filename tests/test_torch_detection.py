"""Port: the detection family's model (`PoseCNNDet`), its losses, its
train step and its checkpoint, against the JAX package at a small size
(64×96 frames, 4 classes, fc_dim 32, 16 proposal slots, 3×3 anchors)
with the same weights and JAX's own target draws fed to the port.

Tolerances: the proposals' valid flags and the sampled rows' labels
equal, their coordinates within 1e-4 px (eval) and 1e-3 px (train, where
the RPN's deltas carry the trunk's rounding into them); RPN and head
outputs within 1e-4; loss terms and a 3-step trajectory within 1e-4
relative; each gradient tensor within 1e-3 of its norm (5e-3 in the
trunk's first three stages, see EARLY_TRUNK); the checkpoint
round trip exact.

The RoI head pools at sample positions computed from the RPN's deltas,
and JAX differentiates through them (floor, clamp and the per-bin max
have kinks there): the RCNN terms' gradient into rpn_bbox_pred and the
layers below it differs by up to 10% between JAX's own eager and jitted
runs of the same step. So below the pool the gradients are held on the
RPN terms, whose gradient is smooth, and the head's on the whole loss.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict  # REFERENCE's child reads
from posecnn_tpu.engine import train as jtrain  # these two through this module
from posecnn_tpu.models.detection import PoseCNNDet as JaxPoseCNNDet
from posecnn_tpu.models.detection import detection_losses as jax_detection_losses
from posecnn_torch.cli.train_net import det_targets
from posecnn_torch.core.checkpoint import restore_params, save_params
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import load_npz, params_from_jax, params_to_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.detection import PoseCNNDet, detection_losses
from posecnn_torch.ops.rpn import TargetNoise

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
C, FC, H, W = 4, 32, 64, 96
KW = dict(anchor_scales=(1, 2, 4), anchor_ratios=(0.5, 1.0, 2.0), fc_dim=FC, post_nms_topk=16,
          pre_nms_topk=100, rois_per_image=16, rpn_batchsize=32, rpn_positive_overlap=0.5,
          bg_thresh_lo=0.0)
# the trunk's first three stages: the port's own fp32 gradient there is
# 1.4e-3 to 2.8e-3 (in norm) from its fp64 gradient on these frames, as the
# CPU's convolutions round equal patches apart and the 2×2 max pools then
# pick other maxima; JAX's is 2e-6 to 2.7e-3 from it
EARLY_TRUNK = tuple(f"trunk.conv{s}_" for s in (1, 2, 3))
# parameters that no RoI sample position depends on
HEAD = ("fc6.", "fc7.", "cls_score.", "bbox_pred.", "pose_pred.", "rpn_cls_score.")
TRAIN = {"num_classes": C, "fc_dim": FC, "optimizer": "momentum", "learning_rate": 0.001,
         "momentum": 0.9, "weight_reg": 1e-4, "syn_height": H, "syn_width": W}


def scene_inputs():
    """Three rendered detection batches, the class library, and the ADD
    points (48 a class) and symmetry flags, class 1 made symmetric."""
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batches = [det_targets(gen.render(dense_vertex_targets=False)) for _ in range(3)]
    sym = np.asarray(lib.symmetry, np.float32).copy()
    sym[1] = 1.0  # one symmetric class: the ADD-S branch
    return batches, lib, np.ascontiguousarray(lib.points[:, :48]), sym


def target_uniforms(key, model, batch):
    """The four uniforms the JAX model draws from its key: the anchor
    targets' fg and bg keys, then the RoI sampling's."""
    n_anchors, n_rois = model.noise_shapes(H, W, batch["gt_boxes"].shape[0])
    r1, r2 = jax.random.split(key)
    a1, a2 = jax.random.split(r1)
    p1, p2 = jax.random.split(r2)
    draws = [jax.random.uniform(k_, (n,)) for k_, n in
             ((a1, n_anchors), (a2, n_anchors), (p1, n_rois), (p2, n_rois))]
    return TargetNoise(*(torch.from_numpy(np.array(d)) for d in draws))


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    batches, lib, pts, sym = scene_inputs()
    jmodel = JaxPoseCNNDet(num_classes=C, compute_dtype=jnp.float32, **KW)
    params = jax.jit(lambda key: jmodel.init(key, jnp.asarray(batches[0]["data"]), train=False))(
        jax.random.PRNGKey(0))
    model = PoseCNNDet(C, **KW)
    model.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    return dict(batches=batches, jmodel=jmodel, params=params, model=model, pts=pts, sym=sym)


def test_eval_forward_matches_jax(setup):
    b = setup["batches"][0]
    want = setup["jmodel"].apply(setup["params"], jnp.asarray(b["data"]), train=False)
    with torch.no_grad():
        got = setup["model"](torch.from_numpy(b["data"]))
    np.testing.assert_array_equal(got.proposals.valid.numpy(), np.asarray(want.proposals.valid))
    assert got.proposals.valid.sum() > 2
    np.testing.assert_allclose(got.proposals.rois.numpy(), np.asarray(want.proposals.rois),
                               rtol=0, atol=1e-4)
    for name in ("rpn_cls_logits", "rpn_bbox_pred", "cls_logits", "bbox_pred", "poses_pred"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_pose", [False, True])
def test_train_forward_losses_and_gradients_match_jax(setup, with_pose):
    b = setup["batches"][1]
    key = jax.random.PRNGKey(5)
    jmodel, params = setup["jmodel"], setup["params"]
    pose_args = (jnp.asarray(setup["pts"]), jnp.asarray(setup["sym"])) if with_pose else ()

    def loss_fn(p):
        out = jmodel.apply(p, *(jb(b)[k] for k in ("data", "gt_boxes", "gt_poses", "gt_valid")),
                           train=True, rng=key)
        metrics = jax_detection_losses(out, C, *pose_args)
        return metrics["loss"], (metrics, out)

    def rpn_loss_fn(p):
        metrics = loss_fn(p)[1][0]
        return metrics["rpn_cls"] + metrics["rpn_box"]

    (_, (want_m, want)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    rpn_grads = jax.jit(jax.grad(rpn_loss_fn))(params)
    model = setup["model"]
    model.zero_grad(set_to_none=True)
    t = tb(b)
    got = model(t["data"], t["gt_boxes"], t["gt_poses"], t["gt_valid"], train=True,
                noise=target_uniforms(key, model, b))
    pose_t = (torch.from_numpy(setup["pts"]), torch.from_numpy(setup["sym"])) if with_pose else ()
    got_m = detection_losses(got, C, *pose_t)
    names, params_t = zip(*model.named_parameters())
    got_rpn_g = torch.autograd.grad(got_m["rpn_cls"] + got_m["rpn_box"], params_t,
                                    retain_graph=True, allow_unused=True)
    got_m["loss"].backward()

    at, pt = got.anchor_targets, got.proposal_targets
    np.testing.assert_array_equal(at.labels.numpy(), np.asarray(want.anchor_targets.labels))
    assert (at.labels == 1).sum() > 0
    for name in ("labels", "valid"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(want.proposal_targets, name)),
                                      err_msg=name)
    # the same rows, their coordinates moved by the convolutions' rounding
    np.testing.assert_allclose(pt.rois.detach().numpy(), np.asarray(want.proposal_targets.rois),
                               rtol=0, atol=1e-3)
    assert (pt.labels > 0).sum() > 0
    for name in ("cls_logits", "bbox_pred", "poses_pred"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert set(got_m) == set(want_m) == ({"rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss"}
                                         | ({"loss_pose"} if with_pose else set()))
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    # the head's gradients of the whole loss; below the RoI pool the RPN
    # terms' (see the module's docstring)
    want_g = params_from_jax(jckpt._flatten(grads))
    want_rpn_g = params_from_jax(jckpt._flatten(rpn_grads))
    for name, p, rpn_g in zip(names, params_t, got_rpn_g):
        if name.startswith(HEAD):
            g, wg = p.grad, want_g[name].numpy()
        else:
            g, wg = rpn_g, want_rpn_g[name].numpy()
        if name.startswith("pose_pred.") and not with_pose:
            assert g is None and not wg.any(), name
            continue
        g = g.numpy()
        assert np.abs(wg).max() > 0, name
        tol = 5e-3 if name.startswith(EARLY_TRUNK) else 1e-3
        assert np.linalg.norm(g - wg) <= tol * np.linalg.norm(wg), name


# the child: the JAX det train step, three steps from its own init, the
# parameters before and after and the losses saved to the .npz of argv[1]
REFERENCE = """
import sys
sys.path[:0] = [sys.argv[2], sys.argv[2] + "/tests"]
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import test_torch_detection as T
batches, _, pts, sym = T.scene_inputs()
jcfg = T.jax_cfg_from_dict({"network": "posecnn_det", "train": T.TRAIN})
jmodel = T.JaxPoseCNNDet(num_classes=T.C, compute_dtype=jnp.float32, **T.KW)
params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["data"]), train=False)
step = T.jtrain.make_det_train_step(jcfg, jmodel, points=jnp.asarray(pts),
                                    symmetry=jnp.asarray(sym), donate=False)
state = T.jtrain.TrainState(params, T.jtrain.create_optimizer(jcfg, params).init(params),
                            jnp.zeros((), jnp.int32))
out = {"init/" + k: v for k, v in T.jckpt._flatten(params).items()}
rng = jax.random.PRNGKey(jcfg.rng_seed)
for i, b in enumerate(batches):
    state, m = step(state, T.jb(b), rng)
    for k, v in m.items():
        out[f"step{i}/{k}"] = np.asarray(v)
out.update({"final/" + k: v for k, v in T.jckpt._flatten(state.params).items()})
np.savez(sys.argv[1], **out)
"""


def test_three_det_train_steps_match_jax(tmp_path, monkeypatch):
    """SGD momentum with weight decay at lov_det.yaml's rate; each step's
    noise is JAX's draw from fold_in(PRNGKey(seed), step), fed to the
    port's step. The RCNN terms' gradient through the RoI sample positions
    has kinks (see the module's docstring), where XLA:CPU's FMA contraction
    moves JAX's own jitted trajectory 8% from its op-by-op one by step 3;
    so the JAX step runs in a child process whose XLA is capped at AVX (no
    FMA), as tests/test_torch_vote_edges.py runs its reference."""
    path = tmp_path / "det_steps.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(path)
    batches, _, pts, sym = scene_inputs()
    cfg = cfg_from_dict({"network": "posecnn_det", "train": TRAIN})
    model = PoseCNNDet(C, **KW)
    model.load_state_dict(params_from_jax({k[5:]: ref[k] for k in ref.files
                                           if k.startswith("init/")}), strict=True)
    noise = {}  # step → JAX's draw

    def fed_noise(n_anchors, n_rois, generator, device):
        return noise[generator.initial_seed()]

    # the step seeds its noise generator with the step number itself
    monkeypatch.setattr(ttrain, "det_noise_seed", lambda seed, step: step)
    monkeypatch.setattr(ttrain, "target_noise", fed_noise)
    state = ttrain.create_train_state(cfg, model)
    step = ttrain.make_det_train_step(cfg, model, torch.from_numpy(pts), torch.from_numpy(sym))
    rng = jax.random.PRNGKey(cfg.rng_seed)
    for i, b in enumerate(batches):
        noise[i] = target_uniforms(jax.random.fold_in(rng, i), model, b)
        got = step(state, tb(b))
        for k in ("rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss_pose", "loss", "lr"):
            np.testing.assert_allclose(float(got[k]), float(ref[f"step{i}/{k}"]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert state.step == 3 and float(ref["step2/loss"]) < float(ref["step0/loss"])
    final = params_from_jax({k[6:]: ref[k] for k in ref.files if k.startswith("final/")})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(final[name]).max())),
                                   err_msg=name)


def test_det_checkpoint_round_trip(setup, tmp_path):
    """The port's snapshot is the JAX layout: JAX's restore fills every
    leaf of its template from it, and both maps are exact inverses."""
    model = setup["model"]
    state = model.state_dict()
    flat = params_to_jax(state, PoseCNNDet.JAX_TRUNK)
    assert set(flat) == set(jckpt._flatten(setup["params"]))
    back = params_from_jax(flat)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    path = str(tmp_path / "det_iter_3.npz")
    save_params(path, model, step=3)
    restored, step = jckpt.restore_params(path, setup["params"], verbose=False)
    assert step == 3
    for k, v in jckpt._flatten(restored).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert set(load_npz(path)) == set(flat)
    other = PoseCNNDet(C, **KW)
    assert restore_params(path, other) == 3
    for k, v in other.state_dict().items():
        assert torch.equal(v, state[k]), k
