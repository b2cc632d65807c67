"""The GAN, segmentation and video training steps compiled
(`engine/train.CompiledGanTrainStep`, `CompiledSegTrainStep`,
`CompiledVideoTrainStep`, the counterparts of their JAX steps'
`jax.jit(step_fn, donate_argnums=(0,))`) and `test_video`'s forward
compiled (`cli/test_video.video_labels` through `compile_static`, JAX's
`jax.jit(model.apply)`), on the CPU at the tiny sizes of
tests/test_torch_{seg_models,recurrent,gan}.py: FCN8 (4 classes, fc_dim
32, batch 2) and ResNet50Seg (num_units 8, stages (1, 1, 1, 1)) at 48×64,
RecurrentSegNet (3 classes, num_units 8, T = 3, batch 1) at 48×64, the GAN
(3 classes, num_units 8, seg + vertex, batch 2) at 48×64.

- On the CPU each compiled step runs its body eagerly; over 3 steps,
  across a step of the lr staircase, it equals its eager step bit for bit
  in every metric and lr, every parameter and buffer, and the optimizers'
  state (the GAN's discriminator Adam too), the GAN with dropout on.
- The same steps against JAX's jitted `make_*_train_step` from the same
  weights (`core/weights`), at those files' tolerances: FCN8 (momentum),
  ResNet50Seg (Adam, decay, clip) and RecurrentSegNet (momentum) in fp32,
  each step's loss within 1e-4 relative and lr equal; the GAN in fp64 at
  keep_prob 1 (its JAX forward run at 1, as test_torch_gan runs it), every
  loss within 1e-5 relative and every generator and discriminator
  parameter after 3 steps within 1e-4 of its tensor's largest entry. Each
  JAX reference runs once a module.
- `bench.snapshot` restores the GAN's generator, discriminator and both
  optimizers' state in place: the same addresses, the same values.
- After a first call no step builds a host constant or reads a tensor on
  the host (a CUDA graph captures neither), but for the CPU's Adam, which
  reads its step count on the host where the card's capturable Adam reads
  nothing.
- `train_net` builds the compiled step for each family's yaml.
- `test_video` through its compiled forward: every program call equal to
  the eager model's labels bit for bit, `video_eval.json` equal to a run
  with the program eager but for the seconds, and matching JAX's CLI as
  test_torch_seg_cli's `test_test_video_matches_jax_on_one_checkpoint`
  holds it.

The CUDA graphs run only on a card: the `cuda` tests hold replayed steps
to eager steps from one state at the gate's bars, count no CUDA kernel
launch a replay on the device, and hold the compiled video forward's
replays to its eager body (`python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_family_compiled.py`). JAX is
imported inside the fixtures and tests that use it: the card's machine
has none.
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

from posecnn_torch import bench
from posecnn_torch.cli import test_video, train_net
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models import FCN8, RecurrentSegNet, ResNet50Seg
from posecnn_torch.models.gan import FeatureDiscriminator
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.ops import _cuda
from test_torch_compiled_train import max_distance, one_step, state_of
from test_torch_det_compiled import host_reads

torch.set_num_threads(1)
H, W, STEPS, FC, UNITS = 48, 64, 3, 32, 8
CLASSES = {"fcn8": 4, "resnet50_seg": 4, "recurrent_seg": 3, "gan": 3}
SMALL, T = (1, 1, 1, 1), 3
# each family's optimizer as its parity file runs it, with a step of the
# lr staircase at count 2
STAIR = {"stepsize": 2, "gamma": 0.5}
SEG_TRAIN = {"learning_rate": 1e-3, "momentum": 0.9, "weight_reg": 1e-4, "grad_clip": 5.0,
             "fc_dim": FC, "num_units": UNITS, **STAIR}
CFGS = {
    "fcn8": {"network": "fcn8", "compute_dtype": "float32",
             "train": {"num_classes": 4, "optimizer": "momentum", **SEG_TRAIN}},
    "resnet50_seg": {"network": "resnet50_seg", "compute_dtype": "float32",
                     "train": {"num_classes": 4, "optimizer": "adam", **SEG_TRAIN}},
    "recurrent_seg": {"network": "recurrent_seg",
                      "train": {"num_classes": 3, "num_units": UNITS, "optimizer": "momentum",
                                "learning_rate": 1e-3, "momentum": 0.9, "weight_reg": 1e-4,
                                "grad_clip": 5.0, "num_steps": T, **STAIR}},
    # shapenet_single_single_color_gan.yaml's switches and rates at toy widths
    "gan": {"train": {"num_classes": 3, "num_units": UNITS, "vertex_reg_2d": True,
                      "pose_reg": False, "gan": True, "gan_weight": 0.1, "learning_rate": 2e-4,
                      "vertex_w": 10.0, **STAIR}},
}
FAMILIES = tuple(CFGS)
COMPILED = {"fcn8": ttrain.CompiledSegTrainStep, "resnet50_seg": ttrain.CompiledSegTrainStep,
            "recurrent_seg": ttrain.CompiledVideoTrainStep, "gan": ttrain.CompiledGanTrainStep}
EAGER = {"fcn8": ttrain.SegTrainStep, "resnet50_seg": ttrain.SegTrainStep,
         "recurrent_seg": ttrain.VideoTrainStep, "gan": ttrain.GanTrainStep}
NO_LAUNCH = {"tile": 0, "flat": 0, "window": 0, "scan": 0, "kabsch": 0,
             "pose_hyp": 0, "pose_refine": 0}


def generator(c, f, seed):
    lib = synthetic_class_library(c, 256)
    k = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=seed,
                                   min_objects=2, max_objects=3, point_colors=lib.colors,
                                   point_normals=lib.normals), lib


def family_data(family):
    """STEPS host batches of the family's feed and, for the GAN, the class
    library (the ADD points, extents and symmetry its losses take)."""
    c = CLASSES[family]
    if family == "recurrent_seg":
        gen, lib = generator(c, 60.0, 6)
        seqs = SyntheticSequenceGenerator(gen, num_steps=T)
        batches = [seqs.minibatch(1) for _ in range(STEPS)]
    elif family == "gan":
        gen, lib = generator(c, 90.0, 4)
        batches = [gen.minibatch(2, max_gt=8, dense_vertex_targets=False) for _ in range(STEPS)]
        for b in batches:
            del b["depth"]
        return batches, lib
    else:
        gen, lib = generator(c, 60.0, 4)
        batches = [gen.minibatch(2, dense_vertex_targets=False) for _ in range(STEPS)]
        batches = [{"data": b["data"], "label": b["label"]} for b in batches]
    for b in batches:  # JAX's one-hot takes int32 labels
        b["label"] = b["label"].astype(np.int32)
    return batches, lib


def tb(batch, device="cpu", dtype=None):
    """A host batch as tensors on `device` (its floats as `dtype`)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def new_models(family, states=None):
    """The family's models on seeded weights (the recurrent net's fusion
    gate drawn away from zero, so the warped state matters), or on
    `states` (state dicts, the model's first)."""
    c = CLASSES[family]
    if family == "fcn8":
        models = [FCN8(c, fc_dim=FC)]
    elif family == "resnet50_seg":
        models = [ResNet50Seg(c, num_units=UNITS, stage_sizes=SMALL)]
    elif family == "recurrent_seg":
        models = [RecurrentSegNet(c, num_units=UNITS)]
    else:
        models = [PoseCNN(c, num_units=UNITS, fc_dim=FC, pose_reg=False),
                  FeatureDiscriminator(3 * c + 3)]
    for i, m in enumerate(models):
        if states is None:
            init_weights(m, i)
        else:
            m.load_state_dict(states[i], strict=True)
    if states is None and family == "recurrent_seg":
        torch.nn.init.normal_(models[0].fusion.gate.weight, 0.0, 0.1,
                              generator=torch.Generator().manual_seed(2))
    return models


def port_step(family, cls=None, device="cpu", states=None, f64=False, keep_prob=0.5):
    """(step, state) of the family: its `make_*_train_step` (or `cls`)."""
    cfg = cfg_from_dict(CFGS[family])
    models = new_models(family, states)
    if f64:
        for m in models:
            for mod in m.modules():
                if hasattr(mod, "compute_dtype"):
                    mod.compute_dtype = torch.float64
        models = [m.double() for m in models]
    models = [m.to(device) for m in models]
    if family != "gan":
        make = cls or (ttrain.make_video_train_step if family == "recurrent_seg"
                       else ttrain.make_seg_train_step)
        return make(cfg, models[0]), ttrain.create_train_state(cfg, models[0])
    _, lib = family_data(family)
    geometry = [torch.from_numpy(a).to(device, torch.float64 if f64 else torch.float32)
                for a in (lib.points[:, :32], lib.extents, lib.symmetry)]
    step = (cls or ttrain.make_gan_train_step)(cfg, *models, *geometry, keep_prob=keep_prob)
    return step, ttrain.create_gan_train_state(cfg, *models)


@pytest.mark.parametrize("family", FAMILIES)
def test_compiled_step_on_the_cpu_equals_the_eager_step(family):
    batches, _ = family_data(family)
    eager, eager_state = port_step(family, cls=EAGER[family])
    compiled, compiled_state = port_step(family)
    assert type(compiled) is COMPILED[family] and not isinstance(eager, ttrain.CompiledStep)
    lrs = []
    for i, batch in enumerate(batches):
        want, got = eager(eager_state, tb(batch)), compiled(compiled_state, tb(batch))
        assert list(got) == list(want)
        assert got["lr"] == want["lr"] and isinstance(got["lr"], float)
        for k in want:
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), (i, k)
        lrs.append(got["lr"])
        for a, b in zip(state_of(compiled, compiled_state), state_of(eager, eager_state),
                        strict=True):
            assert torch.equal(a, b), i
    lr = CFGS[family]["train"]["learning_rate"]
    assert lrs == [lr, lr, lr / 2]  # the staircase's step at count 2
    assert compiled_state.step == eager_state.step == compiled_state.opt.count == STEPS
    if family == "gan":
        assert set(want) == {"loss", "loss_cls", "loss_vertex", "loss_g_adv", "loss_d", "lr"}
        d_steps = [compiled_state.d_opt.state[p]["step"] for p in compiled.disc.parameters()]
        assert all(float(s) == STEPS for s in d_steps)
    assert compiled.compiled.programs == {}  # no graph on the CPU: the call is its body


@pytest.fixture(scope="module")
def jax_seg_steps():
    """JAX's jitted seg step, 3 fp32 steps of FCN8 (momentum) and of
    ResNet50Seg (Adam) from test_torch_seg_models' carried weights: the
    initial weights in the port's layout and each step's loss and lr."""
    import jax
    import jax.numpy as jnp

    import posecnn_tpu.engine.train as jtrain
    import test_torch_seg_models as reference
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict

    runs = {}
    for family in ("fcn8", "resnet50_seg"):
        batches, _ = family_data(family)
        jcfg = jax_cfg_from_dict(CFGS[family])
        jm, tm, params = reference.carried(family, batches[0]["data"], seed=5)
        state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                                  jnp.zeros((), jnp.int32))
        jstep = jtrain.make_seg_train_step(jcfg, jm, donate=False)
        metrics = []
        for b in batches:
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.PRNGKey(0))
            metrics.append({"loss": float(m["loss"]), "lr": float(m["lr"])})
        runs[family] = (batches, tm.state_dict(), metrics)
    return runs


@pytest.fixture(scope="module")
def jax_video_steps():
    """JAX's jitted video step, 3 fp32 steps from test_torch_recurrent's
    carried weights (the fusion gate drawn away from zero)."""
    import jax
    import jax.numpy as jnp

    import posecnn_tpu.engine.train as jtrain
    import test_torch_recurrent as reference
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict

    batches, _ = family_data("recurrent_seg")
    jcfg = jax_cfg_from_dict(CFGS["recurrent_seg"])
    jm, tm, params = reference.carried(batches[0], seed=4)
    state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                              jnp.zeros((), jnp.int32))
    jstep = jtrain.make_video_train_step(jcfg, jm, CLASSES["recurrent_seg"], donate=False)
    metrics = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        metrics.append({"loss": float(m["loss"]), "lr": float(m["lr"])})
    return batches, tm.state_dict(), metrics


@pytest.mark.parametrize("family", ["fcn8", "resnet50_seg", "recurrent_seg"])
def test_compiled_seg_and_video_steps_match_jaxs_jitted_steps(family, request):
    """3 fp32 steps across the lr step from JAX's weights: each step's loss
    within 1e-4 relative of JAX's (test_torch_seg_models' and
    test_torch_recurrent's trajectory bar), lr equal."""
    if family == "recurrent_seg":
        batches, initial, want = request.getfixturevalue("jax_video_steps")
    else:
        batches, initial, want = request.getfixturevalue("jax_seg_steps")[family]
    step, state = port_step(family, states=[initial])
    assert type(step) is COMPILED[family]
    got = [step(state, tb(b)) for b in batches]
    np.testing.assert_allclose([float(m["loss"]) for m in got], [m["loss"] for m in want],
                               rtol=1e-4)
    assert [m["lr"] for m in got] == pytest.approx([m["lr"] for m in want], rel=1e-7)
    assert got[-1]["lr"] < got[0]["lr"] and state.step == STEPS


@pytest.fixture(scope="module")
def jax_gan_steps():
    """JAX's jitted GAN step, 3 fp64 steps with its forward at keep_prob 1
    (test_torch_gan's `_losses_at_keep_prob_1`) from its own init (jitted
    here: op by op it takes ~30 s): the initial generator and
    discriminator weights in the port's layout, each step's metrics, and
    the final weights."""
    import jax
    import jax.numpy as jnp

    import posecnn_tpu.engine.train as jtrain
    import test_torch_gan as reference
    from posecnn_tpu.core import checkpoint as jckpt
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
    from posecnn_tpu.models import PoseCNN as JaxPoseCNN
    from posecnn_tpu.models import gan as jgan
    from posecnn_torch.core.weights import params_from_jax

    batches, lib = family_data("gan")
    jcfg = jax_cfg_from_dict(CFGS["gan"])
    jmodel = JaxPoseCNN(num_classes=CLASSES["gan"], num_units=UNITS, fc_dim=FC, pose_reg=False,
                        compute_dtype=jnp.float32)
    jdisc = jgan.FeatureDiscriminator()
    state = jax.jit(partial(jtrain.create_gan_train_state, jcfg, jmodel, jdisc))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items()},
        jnp.asarray(lib.extents))

    def port_layout(params):
        return {k: np.asarray(v, np.float64) for k, v in
                params_from_jax(jckpt._flatten(params)).items()}

    initial = [params_from_jax(jckpt._flatten(p)) for p in (state.params, state.d_params)]
    geometry = [lib.points[:, :32], lib.extents, lib.symmetry]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "_losses_with_vertex", reference._losses_at_keep_prob_1)
        jmodel = jmodel.clone(compute_dtype=jnp.float64)
        jdisc = jdisc.clone(compute_dtype=jnp.float64)
        state = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, state)
        step = jtrain.make_gan_train_step(
            jcfg, jmodel, jdisc, *(jnp.asarray(a.astype(np.float64)) for a in geometry),
            donate=False)
        metrics = []
        for b in batches:
            jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
                  for k, v in b.items()}
            state, m = step(state, jb, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
        final = [port_layout(state.params), port_layout(state.d_params)]
    return batches, initial, metrics, final


def test_compiled_gan_steps_match_jaxs_jitted_step_in_fp64(jax_gan_steps):
    """The compiled GAN step (on the CPU, its body) in fp64 at keep_prob 1
    from JAX's weights: every loss and lr within 1e-5 relative, every
    parameter of the generator and the discriminator after 3 steps within
    1e-4 of its tensor's largest entry (test_torch_gan's bars)."""
    batches, initial, want, final = jax_gan_steps
    step, state = port_step("gan", states=initial, f64=True, keep_prob=1.0)
    assert type(step) is ttrain.CompiledGanTrainStep
    for i, b in enumerate(batches):
        got = step(state, tb(b, dtype=torch.float64))
        assert set(got) == set(want[i])
        for k in want[i]:
            np.testing.assert_allclose(float(got[k]), want[i][k], rtol=1e-5, err_msg=f"{i} {k}")
    assert want[-1]["lr"] < want[0]["lr"]
    for jax_side, module in zip(final, step.models()):
        port_side = module.state_dict()
        assert set(jax_side) == set(port_side)
        for name, w in jax_side.items():
            np.testing.assert_allclose(port_side[name].numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_snapshot_restores_the_gan_state_in_place():
    batches, _ = family_data("gan")
    step, state = port_step("gan")
    step(state, tb(batches[0]))
    disc = list(step.disc.state_dict(keep_vars=True).values())
    adam = ttrain.adam_state_tensors(state.d_opt)  # each parameter's step and two moments
    assert len(adam) == 3 * len(list(step.disc.parameters()))
    tensors = [*step.model.state_dict(keep_vars=True).values(), *disc,
               *state.opt.state_tensors(), *adam]
    assert [t.data_ptr() for t in tensors] == [t.data_ptr() for t in (
        *(t for m in step.models() for t in m.state_dict(keep_vars=True).values()),
        *state.state_tensors())]
    addresses = [t.data_ptr() for t in tensors]
    saved = [t.detach().clone() for t in tensors]
    restore = bench.snapshot(step, state)
    for b in batches[1:]:
        step(state, tb(b))
    assert state.step == STEPS
    for moved in (disc[0], adam[0], adam[-1], tensors[0]):
        i = next(j for j, t in enumerate(tensors) if t is moved)
        assert not torch.equal(moved, saved[i])
    restore()
    assert state.step == state.opt.count == 1
    after = [*(t for m in step.models() for t in m.state_dict(keep_vars=True).values()),
             *state.state_tensors()]
    assert [t.data_ptr() for t in after] == addresses
    for t, s in zip(after, saved, strict=True):
        assert torch.equal(t, s)
    assert all(float(state.d_opt.state[p]["step"]) == 1.0 for p in step.disc.parameters())


@pytest.mark.parametrize("family", FAMILIES)
def test_no_host_work_after_a_first_call(family, monkeypatch):
    """After a first call, a step builds no host constant and reads no
    tensor on the host (`host_reads`), but inside torch.optim's Adam,
    which on the CPU (neither fused nor capturable) reads its step count on
    the host; the card's Adam is capturable and reads it on the device."""
    batches, _ = family_data(family)
    step, state = port_step(family)
    step(state, tb(batches[0]))
    feed = tb(batches[1])
    made = host_reads(monkeypatch)
    adam_step = torch.optim.Adam.step

    def quiet(self, *args, **kwargs):
        before = len(made)
        out = adam_step(self, *args, **kwargs)
        del made[before:]
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", quiet)
    metrics = step(state, feed)
    assert made == []
    monkeypatch.undo()
    assert np.isfinite(float(metrics["loss"]))


TOY_SET = ["--set", "train.syn_height=48", "train.syn_width=64", "train.num_classes=3",
           "train.fc_dim=32", "train.num_units=8", "train.num_steps=3", "train.ims_per_batch=1"]
YAMLS = {"fcn8": ("rgbd_scene_single_color_fcn8.yaml", []),
         "resnet50_seg": ("rgbd_scene_single_color_fcn8.yaml", ["network=resnet50_seg"]),
         "recurrent_seg": ("lov_color_rnn.yaml", []),
         "gan": ("shapenet_single_single_color_gan.yaml", [])}
CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                       "cfgs")


@pytest.mark.parametrize("family", FAMILIES)
def test_train_net_builds_the_compiled_step(family):
    yaml, extra = YAMLS[family]
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--cfg", os.path.join(CFG_DIR, yaml), *TOY_SET, *extra])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    try:
        assert type(tr.step) is COMPILED[family]
        metrics = tr.step(tr.state, next(tr.batches))
    finally:
        tr.batches.close()
    assert np.isfinite(float(metrics["loss"])) and tr.state.step == 1


def test_test_video_through_its_compiled_forward(tmp_path, monkeypatch):
    """`test_video` on one JAX-written checkpoint (test_torch_seg_cli's):
    each call of the compiled forward (recorded) equal to the eager model's
    labels bit for bit; `video_eval.json` equal to a run with the program
    eager but for the seconds; IoU and surface points equal to the JAX
    CLI's, the tracked motion within 1e-4 m."""
    import test_torch_seg_cli as reference
    from posecnn_tpu.cli import test_video as jax_test_video
    from posecnn_tpu.core import checkpoint as jckpt

    model = reference.RUNS["recurrent_seg"][2]()
    params = reference.RUNS["recurrent_seg"][3](model)
    ckpt = str(tmp_path / "rnn_iter_1.npz")
    jckpt.save_params(ckpt, params, step=1)
    flags = ["--ckpt", ckpt, "--num_sequences", "2", "--num_steps", str(T), "--grid_size", "48",
             "--cfg", os.path.join(CFG_DIR, "lov_color_rnn.yaml"), *reference.TOY,
             "train.syn_tnear=0.4", "train.syn_tfar=0.9"]
    calls = []

    class Recording:
        def __init__(self, fn, inplace=()):
            self.fn, self.programs = fn, {}

        def __call__(self, *args, **kwargs):
            out = self.fn(*args, **kwargs)
            calls.append((self.fn, args, out))
            return out

    monkeypatch.setattr(test_video, "compile_static", Recording)
    got = test_video.main(["--device", "cpu", "--output", str(tmp_path / "compiled"), *flags])
    # the forward's calls; fuse_frame and track_camera are compiled too
    forwards = [c for c in calls if getattr(c[0], "func", None) is test_video.video_labels]
    assert len(forwards) == 2
    assert {getattr(fn, "__name__", None) for fn, _, _ in calls} == {
        None, "fuse_frame", "track_camera"}
    for fn, args, labels in forwards:
        with torch.no_grad():
            assert torch.equal(labels, fn.args[0](*args)[1])

    class Eager:
        def __init__(self, fn, inplace=()):
            self.fn = fn

        def __call__(self, *args, **kwargs):
            return self.fn(*args, **kwargs)

    monkeypatch.setattr(test_video, "compile_static", Eager)
    eager = test_video.main(["--device", "cpu", "--output", str(tmp_path / "eager"), *flags])

    def written(name):
        with open(tmp_path / name / "video_eval.json") as f:
            return [{k: v for k, v in r.items() if k != "seconds"} for r in json.load(f)]

    assert written("compiled") == written("eager") == [
        {k: v for k, v in r.items() if k != "seconds"} for r in eager]
    want = jax_test_video.main(["--output", str(tmp_path / "jax"), *flags])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["mean_iou"] == w["mean_iou"] and g["surface_points"] == w["surface_points"]
        np.testing.assert_allclose(g["tracked_motion_m"], w["tracked_motion_m"], rtol=0,
                                   atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_replayed_family_steps_equal_eager_steps_on_the_card(cuda, family):
    """5 consecutive compiled steps (the first the real step and the
    capture, then replays), each against three eager steps from the same
    state: the metrics bit for bit where the eager ones are; each gradient
    within the eager spread or 1e-2 of its largest entry from the nearest
    eager one; the optimizers run eagerly on the compiled step's gradients
    (the GAN's discriminator Adam too) give its parameters and state bit
    for bit. One graph, no CUDA kernel recorded in it."""
    batches, _ = family_data(family)
    step, state = port_step(family, device=cuda)
    held = [tb(b, cuda) for b in batches]
    for i, batch in enumerate((held * 2)[:5]):
        at = bench.snapshot(step, state)
        eagers = []
        for _ in range(3):
            at()
            eagers.append(one_step(step, state, batch, eager=True))
        at()
        metrics, grads, after = one_step(step, state, batch, eager=False)
        if all(max_distance(e[0], eagers[0][0]) == 0.0 for e in eagers):
            assert max_distance(metrics, eagers[0][0]) == 0.0, i
        for j, g in enumerate(grads):
            ref = [e[1][j] for e in eagers]
            near = min(max_distance([g], [r]) for r in ref)
            spread = max(max_distance([a], [b]) for a in ref for b in ref)
            assert near <= max(spread, 1e-2 * float(ref[0].abs().max())), (i, j, near, spread)
        keep = bench.snapshot(step, state)
        at()
        params = [p for mod in step.models() for p in mod.parameters()]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        state.opt.prepare()
        state.opt.descend()
        if family == "gan":
            state.d_opt.step()
        assert max_distance(state_of(step, state), after) == 0.0, i
        keep()
    (program,) = step.compiled.programs.values()
    assert program.launches == NO_LAUNCH


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_no_kernel_launch_a_replayed_family_step_on_the_card(cuda, family):
    batches, _ = family_data(family)
    step, state = port_step(family, device=cuda)
    batch = tb(batches[0], cuda)
    _cuda.LAUNCHES.update(dict.fromkeys(_cuda.LAUNCHES, 0))
    step(state, batch)  # the real step (eager) and the capture
    _cuda.reset_device_launches()
    for _ in range(3):
        step(state, batch)
    assert _cuda.LAUNCHES == NO_LAUNCH
    assert _cuda.device_launches() == NO_LAUNCH


@pytest.mark.cuda
def test_compiled_video_forward_replays_its_eager_body_on_the_card(cuda):
    """`test_video`'s program: three sequences replay one graph, each equal
    to the eager model's labels bit for bit, no CUDA kernel in it."""
    from posecnn_torch.utils.graph import compile_static

    batches, _ = family_data("recurrent_seg")
    (model,) = new_models("recurrent_seg")
    model = model.to(cuda).eval()
    fn = partial(test_video.video_labels, model)
    forward = compile_static(fn)
    with torch.no_grad():
        for b in batches:
            blobs = [tb(b, cuda)[k] for k in ("image", "depth", "meta")]
            got = forward(*blobs).clone()
            assert torch.equal(got, fn(*blobs))
    (program,) = forward.programs.values()
    assert program.launches == NO_LAUNCH
