"""Port parity: the PoseCNN head switches (`vertex_reg`, `pose_reg`) against
the JAX package on the CPU, fp32.

Four switch settings, as the yamls set them: seg only (vertex_reg_2d and
pose_reg off), seg only with pose_reg on (the JAX model builds no pose
head without a vertex head), seg + 3D vertex (vertex_reg_3d, pose_reg off:
the same vertex head and term as 2D) and the full model. For each:

- the eval forward against `model.apply(train=False)` (JAX Hough backend
  "xla", the port's "dense"): log-probs and maps within 1e-4, labels
  equal, Hough rows as tests/test_torch_hough.py, and None where JAX's
  output is None;
- the train losses at keep_prob 1 against `_compose_losses_from_outputs`:
  the same terms within 1e-4 relative, every gradient within 1e-3 of its
  largest entry (fp32 convolutions summed in another order);
- the state dict's keys equal the JAX tree's, both ways.

Also the eval restore (`core/checkpoint.restore_for_eval`) of a seg-only
and a seg + vertex JAX checkpoint into the full model, and the refusals
of `engine/train.check_supported` over every yaml of experiments/cfgs:
exactly the GAN yaml without a vertex head, on which the JAX GAN step
fails too.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.models import FeatureDiscriminator as JaxFeatureDiscriminator
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.core import checkpoint as tckpt
from posecnn_torch.core.config import cfg_from_dict, cfg_from_file
from posecnn_torch.core.weights import params_from_jax, params_to_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.posecnn import PoseCNN, init_weights

torch.set_num_threads(1)
C, UNITS, FC, S = 4, 8, 32, 64
H, W, B, MAX_GT = 48, 64, 2, 8
TRAIN = {"num_classes": C, "num_units": UNITS, "fc_dim": FC, "ims_per_batch": B,
         "gt_pose_rois": True, "symsize": 0, "hough_num_samples": S}
SWITCHES = {
    "seg_only": {"vertex_reg_2d": False, "pose_reg": False},
    "seg_only_pose_flag": {"vertex_reg_2d": False, "pose_reg": True},
    "seg_vertex_3d": {"vertex_reg_2d": False, "vertex_reg_3d": True, "pose_reg": False},
    "full": {"vertex_reg_2d": True, "pose_reg": True},
}
CFG_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments", "cfgs")
# what the port refuses among the yamls, each a failure of the JAX package too
# (ROADMAP Queue 3): the GAN step without a vertex head
REFUSED = ["shapenet_single_color_gan.yaml"]


def toy_batch():
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.minibatch(B, max_gt=MAX_GT, dense_vertex_targets=False)
    del batch["depth"]
    return batch, lib


def models(vertex_reg, pose_reg):
    kw = dict(num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2,
              gt_pose_rois=True, vertex_reg=vertex_reg, pose_reg=pose_reg)
    return (JaxPoseCNN(num_classes=C, hough_backend="xla", compute_dtype=jnp.float32, **kw),
            PoseCNN(C, hough_backend="dense", **kw))


@pytest.fixture(scope="module", params=list(SWITCHES))
def run(request):
    """JAX: eval and train outputs, loss terms and gradients at keep_prob 1,
    and the port model with the same weights."""
    train = dict(TRAIN, **SWITCHES[request.param])
    vertex_reg = train.get("vertex_reg_2d", False) or train.get("vertex_reg_3d", False)
    batch, lib = toy_batch()
    jcfg = jax_cfg_from_dict({"train": train})
    jmodel, model = models(vertex_reg, train["pose_reg"])
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
    eval_out = jax.jit(lambda p: jmodel.apply(p, jb["data"], ext, jb["meta"], train=False))(
        params)
    flat = jckpt._flatten(params)
    model.load_state_dict(params_from_jax(flat), strict=True)
    return dict(name=request.param, batch=batch, lib=lib, out=out, eval_out=eval_out,
                metrics=metrics, model=model, flat=flat,
                grads=params_from_jax(jckpt._flatten(grads)), pts=np.array(pts),
                sym=np.array(sym), cfg=cfg_from_dict({"train": train}))


def test_eval_forward_matches_jax(run):
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    got = run["model"](batch["data"], torch.from_numpy(run["lib"].extents), batch["meta"],
                       full_vertex=True)
    want = run["eval_out"]
    assert (got.label_2d.numpy() == np.asarray(want.label_2d)).all()
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob), rtol=1e-4,
                               atol=1e-4)
    for name in ("vertex_pred", "hough", "poses_pred", "poses_tanh", "domain_logits"):
        assert (getattr(got, name) is None) == (getattr(want, name) is None), name
    if want.vertex_pred is not None:
        np.testing.assert_allclose(got.vertex_pred.numpy(), np.asarray(want.vertex_pred),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.hough.valid.numpy(), np.asarray(want.hough.valid))
        np.testing.assert_allclose(got.hough.rois.numpy(), np.asarray(want.hough.rois),
                                   rtol=1e-5, atol=1e-4)
    if want.poses_pred is not None:
        np.testing.assert_allclose(got.poses_pred.numpy(), np.asarray(want.poses_pred),
                                   rtol=1e-4, atol=1e-4)


def test_train_losses_and_gradients_match_jax(run):
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    ext = torch.from_numpy(run["lib"].extents)
    model = run["model"]
    model.zero_grad(set_to_none=True)
    total, metrics = ttrain.compute_losses(model, batch, run["cfg"], torch.from_numpy(run["pts"]),
                                           ext, torch.from_numpy(run["sym"]), keep_prob=1.0)
    total.backward()
    want = run["metrics"]
    assert set(metrics) == set(want)
    expected = {"seg_only": {"loss", "loss_cls"}, "seg_only_pose_flag": {"loss", "loss_cls"},
                "seg_vertex_3d": {"loss", "loss_cls", "loss_vertex"}}.get(run["name"])
    if expected is not None:
        assert set(want) == expected
    else:
        assert float(want["num_pose_rois"]) > 0
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    if model.vertex_head is None:
        return  # seg only: the gradients are held in fp64 below
    for name, p in model.named_parameters():
        g, wg = p.grad.numpy(), run["grads"][name].numpy()
        scale = np.abs(wg).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-3 * scale, err_msg=name)


@pytest.mark.parametrize("name", ["seg_only", "seg_only_pose_flag"])
def test_seg_only_gradients_match_jax_in_fp64(name):
    """The seg-only models' gradients, both packages in fp64 (the scores
    cast to fp32 before the softmax in both, as the models do): with the
    cross-entropy alone, a ReLU input within ~1e-6 of zero in the fp32
    trunk falls on either side in the two packages and moves conv1_1's
    gradient by ~1e-3 of its largest entry; in fp64 they agree on every
    kink (as tests/test_torch_seg_models.py holds the VGG16 trunk)."""
    train = dict(TRAIN, **SWITCHES[name])
    batch, lib = toy_batch()
    jmodel, model = models(False, train["pose_reg"])
    ext = jnp.asarray(lib.extents)
    params = jax.jit(lambda key: jmodel.init(key, jnp.asarray(batch["data"]), ext,
                                             jnp.asarray(batch["meta"]), train=False))(
        jax.random.PRNGKey(0))
    model.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    jcfg = jax_cfg_from_dict({"train": train})
    with jax.enable_x64(True):
        jm64 = jmodel.clone(compute_dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
              for k, v in batch.items()}

        def loss_fn(p):
            out = jm64.apply(p, jb["data"], ext, jb["meta"], jb["gt_poses"], jb["gt_valid"],
                             train=True, keep_prob=1.0)
            return jtrain._compose_losses_from_outputs(out, jb, jcfg, None, ext, None)[0]

        want = {k: np.asarray(v, np.float64) for k, v in
                params_from_jax(jckpt._flatten(jax.grad(loss_fn)(p64))).items()}
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    model = model.double()
    tb = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v)
          for k, v in batch.items()}
    total, _ = ttrain.compute_losses(model, tb, cfg_from_dict({"train": train}), None,
                                     torch.from_numpy(lib.extents), None, keep_prob=1.0)
    total.backward()
    for pname, p in model.named_parameters():
        w = want[pname]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12), err_msg=pname)


def test_train_forward_runs_hough_only_for_the_pose_head(run):
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    out = run["model"].train_forward(batch["data"], torch.from_numpy(run["lib"].extents),
                                     batch["meta"], batch["gt_poses"], batch["gt_valid"])
    has_pose = run["model"].pose_head is not None
    assert (out.hough is not None) == has_pose == (out.poses_pred is not None)
    assert (out.vertex_pred is None) == (run["model"].vertex_head is None)


def test_state_dict_keys_equal_the_jax_tree_both_ways(run):
    model, flat = run["model"], run["flat"]
    assert set(params_to_jax(model.state_dict())) == set(flat)
    assert set(params_from_jax(flat)) == set(model.state_dict())
    heads = {k.split("/")[1] for k in flat}
    want = {"VGG16Trunk_0", "seg_head"}
    want |= {"vertex_head"} if model.vertex_head is not None else set()
    want |= {"pose_head"} if model.pose_head is not None else set()
    assert heads == want


@pytest.mark.parametrize("switches,kept", [
    ({"vertex_reg": False, "pose_reg": False}, ["pose_head", "vertex_head"]),
    ({"vertex_reg": True, "pose_reg": False}, ["pose_head"]),
])
def test_eval_restore_keeps_the_heads_a_switched_checkpoint_lacks(switches, kept, tmp_path,
                                                                  capsys):
    """A JAX checkpoint of a switched model into the full eval model: the
    file's parameters restored exactly, the missing head groups at the
    model's seeded values and named; any other gap raises."""
    batch, lib = toy_batch()
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, compute_dtype=jnp.float32,
                        **switches)
    params = jax.jit(lambda key: jmodel.init(key, jnp.asarray(batch["data"]),
                                             jnp.asarray(lib.extents), jnp.asarray(batch["meta"]),
                                             train=False))(jax.random.PRNGKey(1))
    path = str(tmp_path / "switched_iter_7.npz")
    jckpt.save_params(path, params, step=7)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC)
    init_weights(model, 3)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    assert tckpt.restore_for_eval(path, model) == 7
    line = [s for s in capsys.readouterr().out.splitlines() if "kept the model" in s]
    assert len(line) == 1 and line[0].split(" has no ")[1].split(";")[0] == ", ".join(kept)
    restored = params_from_jax(jckpt._flatten(params))
    for k, v in model.state_dict().items():
        want = initial[k] if k.split(".")[0] in kept else restored[k]
        assert torch.equal(v, want), k
    with pytest.raises(RuntimeError, match="Missing key"):  # training's restore stays strict
        tckpt.restore_params(path, PoseCNN(C, num_units=UNITS, fc_dim=FC))

    flat = jckpt._flatten(params)
    for broken in (
        {k: v for k, v in flat.items() if "conv1_1" not in k},  # a trunk layer missing
        # a head the eval model does not have (no adaptation)
        dict(flat, **{"params/domain_head/fc9/kernel": np.zeros((2, 2), np.float32)}),
    ):
        np.savez(str(tmp_path / "broken.npz"), **broken)
        with pytest.raises(KeyError):
            tckpt.restore_for_eval(str(tmp_path / "broken.npz"), model)
    key = "params/seg_head/score_out/kernel"
    np.savez(str(tmp_path / "reshaped.npz"), **dict(flat, **{key: flat[key][..., :-1]}))
    with pytest.raises(RuntimeError, match="size mismatch"):
        tckpt.restore_for_eval(str(tmp_path / "reshaped.npz"), model)


def test_check_supported_refuses_exactly_what_jax_fails_on():
    """Every yaml of experiments/cfgs through the port's config reader and
    `check_supported`: the refusals are REFUSED, each with its reason."""
    files = sorted(glob.glob(os.path.join(CFG_DIR, "*.yaml")))
    assert len(files) == 98
    refused = {}
    for path in files:
        try:
            ttrain.check_supported(cfg_from_file(path))
        except NotImplementedError as err:
            refused[os.path.basename(path)] = str(err)
    assert sorted(refused) == REFUSED
    assert "train.gan without a vertex head" in refused[REFUSED[0]]


def test_jax_gan_step_fails_without_a_vertex_head():
    """The reference-side fault behind the refusal: the JAX GAN step scales
    the vertex map of a model that has none (`engine/train.py:516-519`)."""
    batch, lib = toy_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jax_cfg_from_dict({"train": dict(TRAIN, gan=True, vertex_reg_2d=False, pose_reg=False,
                                           learning_rate=2e-4)})
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, vertex_reg=False,
                        pose_reg=False, compute_dtype=jnp.float32)
    disc = JaxFeatureDiscriminator()
    ext = jnp.asarray(lib.extents)
    state = jtrain.create_gan_train_state(cfg, jmodel, disc, jax.random.PRNGKey(0), jb, ext)
    step = jtrain.make_gan_train_step(cfg, jmodel, disc, jnp.asarray(lib.points[:, :32]), ext,
                                      jnp.asarray(lib.symmetry), donate=False)
    with pytest.raises(TypeError, match="NoneType"):
        step(state, jb, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="without a vertex head"):
        ttrain.check_supported(cfg_from_dict({"train": dict(TRAIN, gan=True)}))
