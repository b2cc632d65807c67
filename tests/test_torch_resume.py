"""Port: resuming a training run (`cli/train_net --ckpt` / `--resume`) as the
JAX CLI resumes it (`posecnn_tpu/cli/train_net.py`), family by family, on the
CPU at toy sizes.

For posecnn (momentum and Adam), detection, FCN8, RecurrentSegNet and the
GAN: the port writes one snapshot at step 2 (weights seeded apart from the
trainer's own, so the restore shows); JAX's resumed state is built as its
CLI builds it (`restore_params` into the model's init, `opt.init`, the step,
`train.lr_step_offset`), the port's through `train_net.build_trainer(--ckpt
…)`; both take the same two batches (numpy, seeded) at keep_prob 1 (the JAX
forward run at 1 where its step fixes 0.5), the port with its compiled step
(on the CPU its body) and, for posecnn, its eager step from the same state.
Held equal at every update: the global step before it, the applied rate
(`schedule(count)` on the optimizer's count) and the logged `lr`, the update
count after it (and every Adam `step` of the port), and the parameters.
The staircase is stepsize 3, gamma 0.5, so that a resume which continued
(or restarted) the wrong count would apply or log another rate.

Parameters are held as each update's move, `p_after − p_before`, against
JAX's, tensor by tensor in norm: within 1e-3 of the norm of JAX's move
(`MOVE_TOL`; the detection step's second move within 5e-2, `DET_MOVE_TOL`:
its RCNN terms differentiate through the RoI sample positions, whose kinks
tests/test_torch_detection.py documents; measured 3.1e-4 and 1.2e-2). An
Adam move is weighted entry by entry by JAX's √ν̂, the size of the
gradients behind it: Adam's first update moves every entry ±lr whatever
its gradient's size, so an entry whose gradient is near zero moves either
way under fp32 rounding (3.5e-3 and 1.8e-2 of the plain norm; weighted
9.7e-6 and 4.8e-4). The old resume, Adam's count fast-forwarded to the
step, moved each entry 0.64× as far: 0.36 off in either norm. Losses
within 1e-4 relative (1e-5 for the GAN), rates to 1e-7 relative, steps and
counts equal: the bars of the families' step-against-JAX tests
(tests/test_torch_{compiled_train,family_compiled,det_compiled,gan}.py).

The JAX references of the detection (XLA capped at AVX, as
tests/test_torch_detection.py runs it), FCN8 and RecurrentSegNet resumes
and of JAX's CLI run in child processes, started with the module beside
its in-process cases (`jax_children`): ~105 s for the module on this
CPU, where one process took ~180 s.

The CLI case runs JAX's `train_net.main` and the port's across `--resume`
(a 2-step pass, then `--iters 4`), each with `--backgrounds` on a glob of
frames the test writes: `metrics.jsonl`'s `iter` and `lr` and the
snapshot names equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_torch import bench
from posecnn_torch.cli import train_net
from posecnn_torch.core.checkpoint import save_params
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.posecnn import init_weights

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
STEP0, MOVE_TOL = 2, 1e-3
STAIR = ["train.stepsize=3", "train.gamma=0.5"]


def optax_counts(opt_state) -> int:
    """The update count of an optax chain's state (every `count` field,
    which must agree)."""
    counts = {int(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if any(getattr(k, "name", None) == "count" for k in path)}
    assert len(counts) == 1, counts
    return counts.pop()


def applied_rate(opt) -> float:
    """The rate the port's last update applied: the device rate (momentum,
    and Adam on a card) or the CPU Adam's float."""
    if opt.trace is None and not isinstance(opt.opt.param_groups[0]["lr"], torch.Tensor):
        return opt.opt.param_groups[0]["lr"]
    return float(opt.lr)


def port_trainer(tmp_path, ckpt, sets, *flags):
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--output", str(tmp_path), "--ckpt", ckpt, *flags, "--set", *sets])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    tr.batches.close()
    return tr


def write_snapshot(path, model, seed=7):
    """The port's snapshot at STEP0 of `model` on weights of `seed`."""
    init_weights(model, seed)
    save_params(str(path), model, step=STEP0)
    return str(path)


def port_run(step, state, batches, models):
    """Per update: (step before, applied rate, logged lr, count after, the
    Adam steps after, loss, {name: move})."""
    out = []
    for b in batches:
        before = {n: p.detach().clone() for m in models for n, p in named(m)}
        at = state.step
        m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        adam = state.opt.opt
        adam_steps = {float(adam.state[p]["step"]) for p in state.opt.params} if adam else None
        out.append(dict(step=at, applied=applied_rate(state.opt), lr=m["lr"],
                        count=state.opt.count, adam_steps=adam_steps, loss=float(m["loss"]),
                        moves={n: (p.detach() - before[n]).double().numpy()
                               for mod in models for n, p in named(mod)}))
    return out


def named(model):
    prefix = "disc." if model.__class__.__name__ == "FeatureDiscriminator" else ""
    return [(prefix + n, p) for n, p in model.named_parameters()]


def adam_scale(opt_state, count):
    """√ν̂ of an optax chain's Adam state in the port's layout ({} without
    Adam): the size of the gradients that drove each entry's move."""
    import optax

    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            nu = jax_port_layout(s.nu)
            return {k: np.sqrt(v.astype(np.float64) / (1 - 0.999 ** count))
                    for k, v in nu.items()}
    return {}


def jax_record(state_before, state_after, metrics, jcfg, params_of):
    count = optax_counts(state_before.opt_state)
    before, after = params_of(state_before), params_of(state_after)
    return dict(step=int(state_before.step), applied=float(jtrain.lr_schedule(jcfg)(count)),
                lr=float(metrics["lr"]), count=optax_counts(state_after.opt_state),
                loss=float(metrics["loss"]),
                moves={n: after[n].astype(np.float64) - before[n].astype(np.float64)
                       for n in after},
                scale=adam_scale(state_after.opt_state, count + 1))


SCALARS = ("step", "applied", "lr", "count", "loss")


def save_records(records, out):
    """A child's records, as an .npz at `out`."""
    flat = {}
    for i, rec in enumerate(records):
        flat.update({f"{i}/{k}": rec[k] for k in SCALARS})
        for part in ("moves", "scale"):
            flat.update({f"{i}/{part}/{k}": v for k, v in rec[part].items()})
    np.savez(out, **flat)


def load_records(path):
    ref = np.load(path)
    n = 1 + max(int(k.split("/")[0]) for k in ref.files)
    return [{**{k: ref[f"{i}/{k}"].item() for k in SCALARS},
             **{part: {k.split("/", 2)[2]: ref[k] for k in ref.files
                       if k.startswith(f"{i}/{part}/")} for part in ("moves", "scale")}}
            for i in range(n)]


def assert_same_trajectory(got, want, loss_rtol, move_tol, expect):
    """`got` (the port's updates) against `want` (JAX's): the step, rates
    and counts equal, the loss within `loss_rtol`, each move within
    `move_tol` of JAX's in norm. `expect` is the (steps, applied, logged)
    the family's resume must give."""
    assert [g["step"] for g in got] == [w["step"] for w in want] == expect[0]
    np.testing.assert_allclose([g["applied"] for g in got], [w["applied"] for w in want],
                               rtol=1e-7)
    np.testing.assert_allclose([g["lr"] for g in got], [w["lr"] for w in want], rtol=1e-7)
    np.testing.assert_allclose([w["applied"] for w in want], expect[1], rtol=1e-7)
    np.testing.assert_allclose([w["lr"] for w in want], expect[2], rtol=1e-7)
    assert [g["count"] for g in got] == [w["count"] for w in want] == [1, 2]
    for g in got:
        assert g["adam_steps"] in (None, {float(g["count"])})
    np.testing.assert_allclose([g["loss"] for g in got], [w["loss"] for w in want],
                               rtol=loss_rtol)
    worst = {}
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g["moves"]) == set(w["moves"])
        for name, wm in w["moves"].items():
            scale = w["scale"].get(name, 1.0)
            norm = np.linalg.norm(wm * scale)
            err = np.linalg.norm((g["moves"][name] - wm) * scale)
            worst[(i, name)] = err / max(norm, 1e-30)
            assert norm > 0 or err == 0, (i, name)
    tols = move_tol if isinstance(move_tol, tuple) else (move_tol, move_tol)
    bad = {k: v for k, v in worst.items() if v > tols[k[0]]}
    assert not bad, bad


def scene_generator(c, h, w, f, seed=4):
    lib = synthetic_class_library(c, 256)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    return SyntheticSceneGenerator(lib.points, lib.extents, k, width=w, height=h, seed=seed,
                                   min_objects=2, max_objects=3, point_colors=lib.colors,
                                   point_normals=lib.normals), lib


def jax_port_layout(params):
    return {k: v.numpy() for k, v in params_from_jax(jckpt._flatten(params)).items()}


# ---------------------------------------------------------------- posecnn

PC, PH, PW, PB = 4, 48, 64, 2
POSECNN = [f"train.num_classes={PC}", f"train.syn_height={PH}", f"train.syn_width={PW}",
           "train.fc_dim=32", "train.num_units=8", f"train.ims_per_batch={PB}",
           "train.vertex_reg_2d=True", "train.pose_reg=True", "train.gt_pose_rois=True",
           "train.hough_num_samples=64", "train.add_num_points=64", "train.hough_backend=xla",
           "compute_dtype=float32", "train.symsize=3", *STAIR]
# momentum at the rate of test_torch_compiled_train's trajectory test
KINDS = {"momentum": ["train.optimizer=momentum", "train.learning_rate=0.00001"],
         "adam": ["train.optimizer=adam", "train.learning_rate=0.001", "train.grad_clip=35.0"]}


# the detection reference: the JAX side of test_torch_detection's scenes
DET_MOVE_TOL = 5e-2
DET = ["network=posecnn_det", "anchor_scales=[1,2,4]", "anchor_ratios=[0.5,1.0,2.0]",
       "train.num_classes=4", "train.fc_dim=32", "train.syn_height=64", "train.syn_width=96",
       "train.rpn_pre_nms_top_n=100", "train.rpn_post_nms_top_n=16", "train.batch_size=16",
       "train.rpn_batchsize=32", "train.rpn_positive_overlap=0.5", "train.bg_thresh_lo=0.0",
       "train.optimizer=momentum", "train.learning_rate=0.001", "train.weight_reg=0.0001",
       "compute_dtype=float32", *STAIR]
# the CLI case: the posecnn family at toy size, Adam
CLI = [f"train.num_classes={PC}", f"train.syn_height={PH}", f"train.syn_width={PW}",
       "train.fc_dim=32", "train.num_units=8", f"train.ims_per_batch={PB}",
       "train.vertex_reg_2d=True", "train.pose_reg=True", "train.gt_pose_rois=True",
       "train.hough_num_samples=64", "train.add_num_points=64", "compute_dtype=float32",
       "train.display=1", "train.snapshot_iters=2", "train.snapshot_prefix=toy",
       "train.optimizer=adam", "train.learning_rate=0.001", *STAIR]


def cli_flags(root):
    return ["--backgrounds", str(root / "bg" / "*.png"), "--set", *CLI]


def cli_log(out):
    """(iterations, learning rates) of `out`'s metrics.jsonl and its
    snapshots' names."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    return ([m["iter"] for m in logged], [m["lr"] for m in logged],
            sorted(f for f in os.listdir(out) if f.endswith(".npz")))


def jax_cli(root):
    """JAX's `train_net.main` on `root`'s frames: 2 iterations, then
    `--resume --iters 4`, into `root`/jax (its init jitted: op by op it
    takes ~30 s, and the case compares no weight)."""
    from posecnn_tpu.cli import train_net as jax_train_net

    root = Path(root)
    init = jtrain.create_train_state
    jtrain.create_train_state = lambda cfg, model, rng, batch, extents: jax.jit(
        lambda r, b, e: init(cfg, model, r, b, e))(rng, batch, extents)
    for argv in (["--iters", "2"], ["--iters", "4", "--resume"]):
        jax_train_net.main(["--output", str(root / "jax"), "--data_root", str(root / "empty"),
                            *argv, *cli_flags(root)])


# the children: a reference function of this module run in a process of
# its own (the detection one with XLA capped at AVX, test_torch_detection's
# reason), its arguments after the repository's root
CHILD = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_resume as R
getattr(R, sys.argv[2])(*sys.argv[3:])
"""


class Children(dict):
    """The JAX references that run in child processes, started together
    when the module starts and run beside its in-process cases; `wait`
    gives a child's output once it has ended well."""

    def __init__(self, root):
        super().__init__()
        self.root, self.procs = root, {}

    def start(self, name, fn, args, output, **env):
        log = open(self.root / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(ROOT), fn, *map(str, args)], cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu", **env), stdout=log,
            stderr=subprocess.STDOUT)
        self.procs[name] = (proc, log, output)

    def wait(self, name):
        proc, log, output = self.procs[name]
        rc = proc.wait(timeout=600)
        log.close()
        assert rc == 0, (self.root / f"{name}.log").read_text()[-3000:]
        return output

    def stop(self):
        for proc, log, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


@pytest.fixture(scope="module", autouse=True)
def jax_children(tmp_path_factory):
    """The detection, segmentation and video references and JAX's CLI
    across --resume, each in a child process started with the module: their
    snapshots, the background frames and an empty data root written
    first."""
    from PIL import Image

    from posecnn_torch.models import PoseCNNDet

    root = tmp_path_factory.mktemp("resume_children")
    cfg = train_net.load_config(train_net.make_parser().parse_args(["--set", *DET]))
    det_ckpt = write_snapshot(root / "det_iter_2.npz",
                              PoseCNNDet.from_config(cfg, cfg.train.num_classes, train=True))
    os.makedirs(root / "bg")
    os.makedirs(root / "empty")
    for i in range(2):
        frame = np.random.RandomState(i).randint(0, 256, (PH, PW, 3), np.uint8)
        Image.fromarray(frame).save(root / "bg" / f"{i}.png")
    children = Children(root)
    children["det_ckpt"] = det_ckpt
    avx = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    children.start("det", "det_records", [det_ckpt, root / "det_records.npz"],
                   root / "det_records.npz", XLA_FLAGS=avx)
    # JAX's CLI keeps its compilation cache where POSECNN_JAX_CACHE says
    children.start("cli", "jax_cli", [root], root / "jax",
                   POSECNN_JAX_CACHE=str(root / "jax_cache"))
    for family in SEG:
        children[f"{family}_ckpt"] = ckpt = seg_snapshot(family, root)
        children.start(family, "seg_records", [family, ckpt, root / f"{family}.npz"],
                       root / f"{family}.npz")
    yield children
    children.stop()


@pytest.fixture(scope="module")
def posecnn_data():
    """Two batches of toy scenes (class 2 symmetric, so that SYMSIZE 3
    switches ADD-S on between the resumed steps 2 and 3) and the class
    library."""
    gen, lib = scene_generator(PC, PH, PW, 60.0)
    lib.symmetry[2] = 1.0
    batches = []
    for _ in range(2):
        b = gen.minibatch(PB, max_gt=8, dense_vertex_targets=False)
        del b["depth"]
        batches.append(b)
    return batches, lib


def jax_cfg(cfg, sets):
    """The JAX package's cfg with the keys of `sets` (`key=value` or
    `train.key=value`) at the values the port's `cfg` parsed for them."""
    out = {"train": {}}
    for key in (s.split("=")[0] for s in sets):
        if key.startswith("train."):
            out["train"][key[len("train."):]] = getattr(cfg.train, key[len("train."):])
        else:
            value = getattr(cfg, key)
            out[key] = list(value) if isinstance(value, tuple) else value
    return jax_cfg_from_dict(out)


def jax_posecnn_resume(kind, cfg, ckpt, batches, lib):
    """The JAX posecnn trainer resumed from `ckpt` as its CLI resumes it
    (`posecnn_tpu/cli/train_net.py:739-775`: the parameters restored into
    the init, the optimizer fresh, the step and `lr_step_offset` at the
    snapshot's), two steps at keep_prob 1."""
    from posecnn_tpu.models import PoseCNN as JaxPoseCNN

    jcfg = jax_cfg(cfg, POSECNN + KINDS[kind])
    jmodel = JaxPoseCNN(num_classes=PC, num_units=8, fc_dim=32, compute_dtype=jnp.float32,
                        vertex_reg=True, pose_reg=True, hough_num_samples=64,
                        max_objects=max(1, jcfg.train.max_rois // PB // 9),
                        gt_pose_rois=True, hough_backend="xla")
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ext = jnp.asarray(lib.extents)
    # (jitted here: op by op the init takes ~30 s; its values are replaced)
    state = jax.jit(lambda key: jtrain.create_train_state(jcfg, jmodel, key, jbatches[0], ext))(
        jax.random.PRNGKey(jcfg.rng_seed))
    params, step0 = jckpt.restore_params(ckpt, state.params, verbose=False)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               lr_step_offset=step0))
    state = jtrain.TrainState(params=params, opt_state=state.opt_state, step=jnp.asarray(step0))

    def keep_all(model, params, batch, cfg, points, extents, symmetry, dropout_rng=None):
        batch = jtrain.decompress_feed(batch, cfg)
        out = model.apply(params, batch["data"], extents, batch["meta"], batch.get("gt_poses"),
                          batch.get("gt_valid"), data_p=batch.get("data_p"), train=True,
                          keep_prob=1.0, dropout_rng=dropout_rng)
        return jtrain._compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry)

    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "compute_losses", keep_all)
        step = jtrain.make_train_step(jcfg, jmodel, jnp.asarray(lib.points[:, :64]), ext,
                                      jnp.asarray(lib.symmetry), donate=False)
        for jb in jbatches:
            new, m = step(state, jb, jax.random.PRNGKey(jcfg.rng_seed))
            records.append(jax_record(state, new, m, jcfg,
                                      lambda s: jax_port_layout(s.params)))
            state = new
    return records


@pytest.mark.parametrize("kind", list(KINDS))
def test_posecnn_resume_matches_jax(kind, posecnn_data, tmp_path):
    from posecnn_torch.models import PoseCNN

    batches, lib = posecnn_data
    sets = POSECNN + KINDS[kind]
    ckpt = write_snapshot(tmp_path / "toy_iter_2.npz",
                          PoseCNN(PC, num_units=8, fc_dim=32, vertex_reg=True, pose_reg=True))
    tr = port_trainer(tmp_path, ckpt, sets)
    assert tr.state.step == tr.cfg.train.lr_step_offset == STEP0 and tr.state.opt.count == 0
    assert all(not t.any() for t in tr.state.state_tensors())
    geometry = [torch.from_numpy(a) for a in (lib.points[:, :64], lib.extents, lib.symmetry)]
    want = jax_posecnn_resume(kind, tr.cfg, ckpt, batches, lib)
    lr = float(dict(s.split("=") for s in KINDS[kind])["train.learning_rate"])
    expect = ([2, 3], [lr, lr / 2], [lr, lr / 2])  # the staircase at global steps 2, 3
    for cls in (ttrain.CompiledTrainStep, ttrain.TrainStep):
        step = cls(tr.cfg, tr.model, *geometry, keep_prob=1.0)
        restore = bench.snapshot(step, tr.state)
        got = port_run(step, tr.state, batches, [tr.model])
        assert_same_trajectory(got, want, 1e-4, MOVE_TOL, expect)
        restore()


# ----------------------------------------------------------- detection

def jax_det_model(jcfg, c):
    """The detection model as the JAX CLI builds it
    (`posecnn_tpu/cli/train_net.py:82-104`)."""
    from posecnn_tpu.models.detection import PoseCNNDet as JaxPoseCNNDet

    t = jcfg.train
    norm_on = t.bbox_normalize_targets
    return JaxPoseCNNDet(
        num_classes=c, fc_dim=t.fc_dim, compute_dtype=jnp.dtype(jcfg.compute_dtype),
        anchor_scales=jcfg.anchor_scales, anchor_ratios=jcfg.anchor_ratios,
        pre_nms_topk=t.rpn_pre_nms_top_n, post_nms_topk=t.rpn_post_nms_top_n,
        rois_per_image=t.batch_size, rpn_nms_thresh=t.rpn_nms_thresh,
        rpn_positive_overlap=t.rpn_positive_overlap, rpn_negative_overlap=t.rpn_negative_overlap,
        rpn_clobber_positives=t.rpn_clobber_positives, rpn_batchsize=t.rpn_batchsize,
        rpn_fg_fraction=t.rpn_fg_fraction, fg_fraction=t.fg_fraction, fg_thresh=t.fg_thresh,
        bg_thresh_hi=t.bg_thresh_hi, bg_thresh_lo=t.bg_thresh_lo,
        bbox_normalize_means=tuple(t.bbox_normalize_means) if norm_on else None,
        bbox_normalize_stds=tuple(t.bbox_normalize_stds) if norm_on else None)


def det_records(ckpt, out):
    """The JAX detection trainer resumed from `ckpt` as its CLI resumes it
    (`:140-149`: the parameters only, a fresh optimizer, step 0), two steps
    on test_torch_detection's scenes; the records saved to `out`."""
    import test_torch_detection as D

    batches, _, pts, sym = D.scene_inputs()
    args = train_net.make_parser().parse_args(["--device", "cpu", "--set", *DET])
    jcfg = jax_cfg(train_net.load_config(args), DET)
    jmodel = jax_det_model(jcfg, D.C)
    jb = [D.jb(b) for b in batches[:2]]
    params = jax.jit(lambda key: jmodel.init(key, jb[0]["data"], jb[0]["gt_boxes"],
                                             jb[0]["gt_poses"], jb[0]["gt_valid"], train=True,
                                             rng=jax.random.PRNGKey(1)))(
        jax.random.PRNGKey(jcfg.rng_seed))
    params, _ = jckpt.restore_params(ckpt, params, verbose=False)
    state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                              jnp.zeros((), jnp.int32))
    step = jtrain.make_det_train_step(jcfg, jmodel, points=jnp.asarray(pts),
                                      symmetry=jnp.asarray(sym), donate=False)
    records = []
    for b in jb:
        new, m = step(state, b, jax.random.PRNGKey(jcfg.rng_seed))
        records.append(jax_record(state, new, m, jcfg, lambda st: jax_port_layout(st.params)))
        state = new
    save_records(records, out)


def test_detection_resume_matches_jax(jax_children, tmp_path, monkeypatch):
    import test_torch_detection as D
    from posecnn_torch.models import PoseCNNDet

    batches, _, pts, sym = D.scene_inputs()
    tr = port_trainer(tmp_path, jax_children["det_ckpt"], DET)
    assert isinstance(tr.model, PoseCNNDet) and tr.state.step == tr.state.opt.count == 0
    assert tr.cfg.train.lr_step_offset == 0
    want = load_records(jax_children.wait("det"))
    # JAX's draws from fold_in(PRNGKey(seed), step) fed to the port's step,
    # whose noise generator is seeded with the step itself
    rng = jax.random.PRNGKey(tr.cfg.rng_seed)
    noise = {i: D.target_uniforms(jax.random.fold_in(rng, i), tr.model, b)
             for i, b in enumerate(batches[:2])}
    monkeypatch.setattr(ttrain, "det_noise_seed", lambda seed, step: step)
    monkeypatch.setattr(ttrain, "target_noise",
                        lambda n_anchors, n_rois, generator, device:
                        noise[generator.initial_seed()])
    step = ttrain.make_det_train_step(tr.cfg, tr.model, torch.from_numpy(pts),
                                      torch.from_numpy(sym))
    got = port_run(step, tr.state, batches[:2], [tr.model])
    # parameters only: the step, the count and the staircase start again;
    # the second move through the RoI sample positions' kinks
    assert_same_trajectory(got, want, 1e-4, (MOVE_TOL, DET_MOVE_TOL),
                           ([0, 1], [1e-3] * 2, [1e-3] * 2))


# ------------------------------------------ segmentation and video (fp32)

SEG_TRAIN = ["train.optimizer=momentum", "train.learning_rate=0.001", "train.momentum=0.9",
             "train.weight_reg=0.0001", "train.grad_clip=5.0", "train.fc_dim=32",
             "train.num_units=8", "train.syn_height=48", "train.syn_width=64",
             "compute_dtype=float32", *STAIR]
SEG = {"fcn8": ["network=fcn8", "train.num_classes=4", "train.ims_per_batch=2", *SEG_TRAIN],
       "recurrent_seg": ["network=recurrent_seg", "train.num_classes=3", "train.num_steps=2",
                         "train.ims_per_batch=1", *SEG_TRAIN]}


def seg_batches(family, cfg):
    t = cfg.train
    gen, _ = scene_generator(t.num_classes, t.syn_height, t.syn_width, 60.0, seed=6)
    if family == "recurrent_seg":
        seqs = SyntheticSequenceGenerator(gen, num_steps=t.num_steps)
        batches = [seqs.minibatch(t.ims_per_batch) for _ in range(2)]
    else:
        batches = [{k: b[k] for k in ("data", "label")}
                   for b in (gen.minibatch(t.ims_per_batch, dense_vertex_targets=False)
                             for _ in range(2))]
    for b in batches:  # JAX's one-hot takes int32 labels
        b["label"] = b["label"].astype(np.int32)
    return batches


def jax_seg_resume(family, cfg, ckpt, batches):
    """The JAX seg or video trainer resumed from `ckpt` as its CLI resumes it
    (`posecnn_tpu/cli/train_net.py:196-202`, `:273-279`: the parameters
    only, a fresh optimizer, step 0), two steps."""
    from posecnn_tpu.core.registry import MODELS as JAX_MODELS
    from posecnn_tpu.models.recurrent import RecurrentSegNet as JaxRecurrentSegNet

    jcfg = jax_cfg(cfg, SEG[family])
    c = jcfg.train.num_classes
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    if family == "recurrent_seg":
        jmodel = JaxRecurrentSegNet(num_classes=c, num_units=jcfg.train.num_units)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(jcfg.rng_seed), jb[0]["image"],
                                      jb[0]["depth"], jb[0]["meta"])
        step = jtrain.make_video_train_step(jcfg, jmodel, c, donate=False)
    else:
        jmodel = JAX_MODELS.get(family)(num_classes=c, compute_dtype=jnp.float32,
                                        fc_dim=jcfg.train.fc_dim)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(jcfg.rng_seed), jb[0]["data"])
        step = jtrain.make_seg_train_step(jcfg, jmodel, donate=False)
    params, _ = jckpt.restore_params(ckpt, params, verbose=False)
    state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                              jnp.zeros((), jnp.int32))
    records = []
    for b in jb:
        new, m = step(state, b, jax.random.PRNGKey(jcfg.rng_seed))
        records.append(jax_record(state, new, m, jcfg, lambda st: jax_port_layout(st.params)))
        state = new
    return records


def seg_snapshot(family, root):
    """The port's snapshot of the family's model, at step 2."""
    from posecnn_torch.core.registry import MODELS

    t = train_net.load_config(train_net.make_parser().parse_args(["--set", *SEG[family]])).train
    width = {"fc_dim": t.fc_dim} if family == "fcn8" else {"num_units": t.num_units}
    return write_snapshot(Path(root) / f"{family}_iter_2.npz",
                          MODELS.get(family)(t.num_classes, **width))


def seg_records(family, ckpt, out):
    """`jax_seg_resume`'s records, saved to `out` (a child's entry)."""
    cfg = train_net.load_config(train_net.make_parser().parse_args(["--set", *SEG[family]]))
    save_records(jax_seg_resume(family, cfg, ckpt, seg_batches(family, cfg)), out)


@pytest.mark.parametrize("family", list(SEG))
def test_seg_and_video_resume_matches_jax(family, jax_children, tmp_path):
    tr = port_trainer(tmp_path, jax_children[f"{family}_ckpt"], SEG[family])
    assert tr.state.step == tr.state.opt.count == tr.cfg.train.lr_step_offset == 0
    batches = seg_batches(family, tr.cfg)
    want = load_records(jax_children.wait(family))
    got = port_run(tr.step, tr.state, batches, [tr.model])
    # parameters only: the step, the count and the staircase start again
    assert_same_trajectory(got, want, 1e-4, MOVE_TOL, ([0, 1], [1e-3] * 2, [1e-3] * 2))


# -------------------------------------------------------------------- GAN

GAN = ["train.num_classes=3", "train.num_units=8", "train.fc_dim=32", "train.syn_height=48",
       "train.syn_width=64", "train.ims_per_batch=2", "train.vertex_reg_2d=True",
       "train.pose_reg=False", "train.gan=True", "train.gan_weight=0.1",
       "train.learning_rate=0.0002", "train.vertex_w=10.0", "train.add_num_points=32",
       "compute_dtype=float32", *STAIR]


def _gan_losses_at_keep_prob_1(model, p, batch, cfg, points, extents, symmetry, drop_rng):
    """`engine/train._losses_with_vertex` with the forward at keep_prob 1."""
    out = model.apply(p, batch["data"], extents, batch["meta"], batch.get("gt_poses"),
                      batch.get("gt_valid"), train=True, keep_prob=1.0)
    total, metrics = jtrain._compose_losses_from_outputs(out, batch, cfg, points, extents,
                                                         symmetry)
    return total, metrics, out.vertex_pred


def jax_gan_resume(cfg, ckpt, batches, lib):
    """The JAX GAN trainer resumed from `ckpt` as its CLI resumes it
    (`posecnn_tpu/cli/train_net.py:702-715`: the generator restored into
    the init, both optimizers fresh, the step at the snapshot's, no
    offset), two steps: the records and the discriminator's initial
    weights in the port's layout."""
    from posecnn_tpu.models import PoseCNN as JaxPoseCNN
    from posecnn_tpu.models import gan as jgan

    jcfg = jax_cfg(cfg, GAN)
    t = jcfg.train
    jmodel = JaxPoseCNN(num_classes=t.num_classes, num_units=t.num_units, fc_dim=t.fc_dim,
                        compute_dtype=jnp.float32, vertex_reg=True, pose_reg=False,
                        max_objects=max(1, t.max_rois // t.ims_per_batch // 9))
    jdisc = jgan.FeatureDiscriminator()
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ext = jnp.asarray(lib.extents)
    state = jax.jit(lambda key: jtrain.create_gan_train_state(jcfg, jmodel, jdisc, key, jb[0],
                                                              ext))(
        jax.random.PRNGKey(jcfg.rng_seed))
    gparams, step0 = jckpt.restore_params(ckpt, state.params, verbose=False)
    state = state._replace(params=gparams, step=jnp.asarray(step0))
    d_init = params_from_jax(jckpt._flatten(state.d_params))

    def params_of(st):
        return {**jax_port_layout(st.params),
                **{"disc." + k: v for k, v in jax_port_layout(st.d_params).items()}}

    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "_losses_with_vertex", _gan_losses_at_keep_prob_1)
        step = jtrain.make_gan_train_step(jcfg, jmodel, jdisc, jnp.asarray(lib.points[:, :32]),
                                          ext, jnp.asarray(lib.symmetry), donate=False)
        for b in jb:
            new, m = step(state, b, jax.random.PRNGKey(jcfg.rng_seed))
            records.append(jax_record(state, new, m, jcfg, params_of))
            state = new
    return records, d_init


def test_gan_resume_matches_jax(tmp_path):
    from posecnn_torch.models import PoseCNN

    cfg = train_net.load_config(train_net.make_parser().parse_args(["--set", *GAN]))
    t = cfg.train
    ckpt = write_snapshot(tmp_path / "gan_iter_2.npz",
                          PoseCNN(t.num_classes, num_units=t.num_units, fc_dim=t.fc_dim,
                                  vertex_reg=True, pose_reg=False))
    tr = port_trainer(tmp_path, ckpt, GAN)
    disc = tr.step.disc
    assert isinstance(tr.state, ttrain.GanTrainState) and tr.state.step == STEP0
    assert tr.state.opt.count == tr.cfg.train.lr_step_offset == 0 and not tr.state.d_opt.state
    gen, lib = scene_generator(t.num_classes, t.syn_height, t.syn_width, 90.0)
    batches = []
    for _ in range(2):
        b = gen.minibatch(t.ims_per_batch, max_gt=8, dense_vertex_targets=False)
        del b["depth"]
        batches.append(b)
    want, d_init = jax_gan_resume(tr.cfg, ckpt, batches, lib)
    disc.load_state_dict(d_init, strict=True)  # both packages' fresh discriminator alike
    geometry = [torch.from_numpy(a) for a in (lib.points[:, :32], lib.extents, lib.symmetry)]
    step = ttrain.CompiledGanTrainStep(tr.cfg, tr.model, disc, *geometry, keep_prob=1.0)
    got = port_run(step, tr.state, batches, [tr.model, disc])
    # the step continued on a fresh count with no offset: the staircase
    # applied at counts 0, 1 and logged at the global steps 2, 3
    lr = t.learning_rate
    assert_same_trajectory(got, want, 1e-5, MOVE_TOL, ([2, 3], [lr, lr], [lr, lr / 2]))


# ------------------------------------------------- the CLIs across --resume

def test_train_net_resume_matches_jaxs_cli(jax_children):
    """Both CLIs train 2 iterations, then `--resume --iters 4`, each with
    `--backgrounds` on the frames the fixture wrote: the same iterations
    and learning rates logged, the same snapshots written."""
    runs = {"jax": cli_log(jax_children.wait("cli"))}
    out = str(jax_children.root / "port")
    for argv in (["--iters", "2"], ["--iters", "4", "--resume"]):
        assert train_net.main(["--device", "cpu", "--output", out, *argv,
                               *cli_flags(jax_children.root)]) == 0
    runs["port"] = cli_log(out)
    assert runs["port"][0] == runs["jax"][0] == [1, 2, 3, 4]
    # the staircase on the global step across the resume: steps 0-2, then 3
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], rtol=1e-7)
    np.testing.assert_allclose(runs["jax"][1], [1e-3, 1e-3, 1e-3, 5e-4], rtol=1e-7)
    assert runs["port"][2] == runs["jax"][2] == ["toy_iter_2.npz", "toy_iter_4.npz"]


def test_gan_cli_resume_numbers_the_pass_from_1(tmp_path):
    """A GAN run resumed at step 2 (JAX's `_generic_loop`): iterations and
    snapshots numbered 1.. of the pass, the final snapshot at `--iters`,
    the step continued to 4, the staircase logged at the global step."""
    from posecnn_torch.models import PoseCNN

    cfg = train_net.load_config(train_net.make_parser().parse_args(["--set", *GAN]))
    t = cfg.train
    ckpt = write_snapshot(tmp_path / "gan_iter_2.npz",
                          PoseCNN(t.num_classes, num_units=t.num_units, fc_dim=t.fc_dim,
                                  vertex_reg=True, pose_reg=False))
    out = tmp_path / "run"
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--output", str(out), "--ckpt", ckpt, "--iters", "2", "--set", *GAN,
         "train.display=1", "train.snapshot_iters=1", "train.snapshot_prefix=toy"])
    state = train_net.main_run(args, train_net.load_config(args), 2)
    assert state.step == 4 and state.opt.count == 2
    with open(out / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [m["iter"] for m in logged] == [1, 2]
    np.testing.assert_allclose([m["lr"] for m in logged], [2e-4, 1e-4], rtol=1e-7)
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "toy_iter_1.npz", "toy_iter_2.npz"]
    assert int(np.load(out / "toy_iter_2.npz")["__step__"]) == 2
