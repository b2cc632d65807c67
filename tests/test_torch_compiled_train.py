"""The posecnn training step compiled (`engine/train.CompiledTrainStep`,
the counterpart of the JAX step's `jax.jit(step_fn, donate_argnums=(0,))`)
on the CPU, at the tiny sizes of tests/test_torch_train_step.py.

- On the CPU the compiled step runs its body eagerly; over 3 steps it
  equals the eager `TrainStep` bit for bit (losses, every metric, every
  parameter, the optimizer's state, lr), with dropout on: adam, and
  momentum across a staircase boundary of lr and the SYMSIZE switch.
- The same 3 steps at keep_prob 1 against JAX's
  `jax.jit(make_train_step(...))` (its Hough on "pallas_c2f", the Pallas
  kernels in interpret mode) from the same weights (`core/weights`), with
  test_torch_train_step's tolerances: every metric of every step rtol
  1e-4; each parameter's first move, −lr·(gradient + decay), within 1e-3
  of its largest entry, as the gradients are within 1e-3 of theirs. (The
  later moves carry the two packages' fp32 gradients through ReLU and
  hard-label kinks that a last-bit difference flips, up to ~1e-2 of a
  tensor's largest entry by step 3; the fp64 trajectory tests of other
  families avoid them, but the pose head's fc8 runs in fp32.)
- The constants the step used to build on the host every call are device
  buffers made once, equal to the literal lists; a step builds no host
  constant.
- `bench.snapshot`'s restore writes in place: every parameter, buffer and
  optimizer state tensor keeps its address (a graph reads them there).
- A re-seeded persistent generator draws what a fresh one does.

The CUDA graphs run only on a card: the `cuda` tests hold a replayed step
to the eager one over 5 steps, a replay's dropout masks to fresh
generators', and count one flat and one window launch a replay on the
device (`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_compiled_train.py`). The JAX side is imported inside the
fixture that uses it: the card's machine has no JAX.
"""

import numpy as np
import pytest
import torch

from posecnn_torch import bench
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models.posecnn import PoseCNN, dropout, init_weights
from posecnn_torch.ops import hough_voting
from posecnn_torch.utils.graph import device_constant

torch.set_num_threads(1)
C, UNITS, FC, S = 4, 8, 32, 64
H, W, B, MAX_GT, STEPS = 64, 96, 2, 8, 3
TRAIN = {"num_classes": C, "num_units": UNITS, "fc_dim": FC, "ims_per_batch": B,
         "vertex_reg_2d": True, "pose_reg": True, "gt_pose_rois": True, "symsize": 0,
         "hough_num_samples": S}
# momentum across a staircase step of lr (count 2) and the SYMSIZE switch (step 2)
KINDS = {"adam": {"optimizer": "adam", "grad_clip": 35.0},
         "momentum": {"optimizer": "momentum", "learning_rate": 1e-5, "gamma": 0.5,
                      "stepsize": 2, "symsize": 2}}


def toy_data():
    """STEPS batches of the toy scenes (sparse vertex feed) and the class
    library, class 2 symmetric so that the SYMSIZE switch changes the loss."""
    lib = synthetic_class_library(C, 256)
    lib.symmetry[2] = 1.0
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batches = []
    for _ in range(STEPS):
        batch = gen.minibatch(B, max_gt=MAX_GT, dense_vertex_targets=False)
        del batch["depth"]
        batches.append(batch)
    return batches, lib


def port_step(kind, lib, cls=None, keep_prob=0.5, state_dict=None, device="cpu"):
    """(step, state) of the toy model, seeded weights or `state_dict`."""
    cfg = cfg_from_dict({"train": dict(TRAIN, **KINDS[kind])})
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2,
                    gt_pose_rois=True)
    if state_dict is None:
        init_weights(model, 0)
    else:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device)
    args = [torch.from_numpy(a).to(device)
            for a in (lib.points[:, :64], lib.extents, lib.symmetry)]
    step = (cls or ttrain.make_train_step)(cfg, model, *args, keep_prob=keep_prob)
    return step, ttrain.create_train_state(cfg, model)


def state_of(step, state):
    """Every parameter and buffer of the modules the step trains and every
    optimizer state tensor, copied."""
    return [t.detach().clone() for t in (
        *(t for m in step.models() for t in m.state_dict().values()), *state.state_tensors())]


@pytest.mark.parametrize("kind", list(KINDS))
def test_compiled_step_on_the_cpu_equals_the_eager_step(kind):
    batches, lib = toy_data()
    eager, eager_state = port_step(kind, lib, cls=ttrain.TrainStep)
    compiled, compiled_state = port_step(kind, lib)
    assert isinstance(compiled, ttrain.CompiledTrainStep)
    lrs = []
    for i, batch in enumerate(batches):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        want, got = eager(eager_state, tb), compiled(compiled_state, tb)
        assert set(got) == set(want)
        assert got["lr"] == want["lr"] and isinstance(got["lr"], float)
        for k in want:
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), (i, k)
        lrs.append(got["lr"])
        for a, b in zip(state_of(compiled, compiled_state), state_of(eager, eager_state)):
            assert torch.equal(a, b), i
    assert compiled_state.step == eager_state.step == STEPS
    assert compiled_state.opt.count == eager_state.opt.count == STEPS
    if kind == "momentum":
        assert lrs == [1e-5, 1e-5, 5e-6]  # the staircase's step at count 2
    # no graph on the CPU: the compiled call is its body
    assert compiled.compiled.programs == {}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted momentum step, 3 steps at keep_prob 1 from its init:
    the initial parameters in the port's layout, then each step's metrics
    and parameters."""
    import jax
    import jax.numpy as jnp

    import posecnn_tpu.engine.train as jtrain
    from posecnn_tpu.core.checkpoint import _flatten
    from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
    from posecnn_tpu.models import PoseCNN as JaxPoseCNN
    from posecnn_torch.core.weights import params_from_jax

    batches, lib = toy_data()
    jcfg = jax_cfg_from_dict({"train": dict(TRAIN, **KINDS["momentum"])})
    jmodel = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, hough_num_samples=S,
                        max_objects=2, gt_pose_rois=True, hough_backend="pallas_c2f",
                        compute_dtype=jnp.float32)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ext = jnp.asarray(lib.extents)
    state = jtrain.create_train_state(jcfg, jmodel, jax.random.PRNGKey(0), jbatches[0], ext)
    initial = params_from_jax(_flatten(state.params))

    def keep_all(model, params, batch, cfg, points, extents, symmetry, dropout_rng=None):
        # `compute_losses` with keep_prob 1 where the JAX step fixes 0.5
        batch = jtrain.decompress_feed(batch, cfg)
        out = model.apply(params, batch["data"], extents, batch["meta"], batch.get("gt_poses"),
                          batch.get("gt_valid"), data_p=batch.get("data_p"), train=True,
                          keep_prob=1.0, dropout_rng=dropout_rng)
        return jtrain._compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry)

    metrics, params = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "compute_losses", keep_all)
        step = jtrain.make_train_step(jcfg, jmodel, jnp.asarray(lib.points[:, :64]), ext,
                                      jnp.asarray(lib.symmetry), donate=False)
        for jb in jbatches:
            state, m = step(state, jb, jax.random.PRNGKey(jcfg.rng_seed))
            metrics.append({k: float(v) for k, v in m.items()})
            params.append(params_from_jax(_flatten(state.params)))
    return dict(batches=batches, lib=lib, initial=initial, metrics=metrics, params=params)


def test_compiled_steps_match_jaxs_jitted_step(jax_steps):
    r = jax_steps
    step, state = port_step("momentum", r["lib"], keep_prob=1.0, state_dict=r["initial"])
    for i, batch in enumerate(r["batches"]):
        got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = r["metrics"][i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, err_msg=f"{i} {k}")
        if i > 0:
            continue
        for name, p in step.model.named_parameters():
            moved = r["params"][0][name].numpy() - r["initial"][name].numpy()
            scale = np.abs(moved).max()
            assert scale > 0, name
            np.testing.assert_allclose(p.detach().numpy() - r["initial"][name].numpy(), moved,
                                       rtol=0, atol=1e-3 * scale, err_msg=name)
    assert [m["lr"] for m in r["metrics"]] == pytest.approx([1e-5, 1e-5, 5e-6])


def test_step_constants_are_device_buffers_made_once(monkeypatch):
    """The box corners, the jitters, the identity quaternion and the pixel
    means are the literal lists the step built per call before; made
    once, not inference tensors; after a first step, a step builds no
    host constant (`torch.tensor`), which a CUDA graph could not capture."""
    corners = [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1], [-1, 1, 1], [-1, 1, -1],
               [-1, -1, 1], [-1, -1, -1]]
    jitters = [[0.0, 0.0], [-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0], [0.0, -1.0],
               [-1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]
    means = (102.9801, 115.9465, 122.7717)
    for values, literal in ((hough_voting._CORNER_SIGNS, corners),
                            (hough_voting._JITTERS, jitters),
                            (hough_voting._IDENTITY_QUAT, [[1.0, 0.0, 0.0, 0.0]]),
                            (cfg_from_dict({}).pixel_means, means)):
        with torch.inference_mode():
            made = device_constant(values, "cpu")
        assert torch.equal(made, torch.tensor(literal, dtype=torch.float32))
        assert made.dtype == torch.float32 and not made.is_inference()
        assert device_constant(values, torch.device("cpu")) is made
    batches, lib = toy_data()
    step, state = port_step("adam", lib)
    feeds = []
    for batch in batches[:2]:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        # the compact uint8 feed, whose pixel means the step adds back
        tb["data"] = torch.from_numpy(np.clip(batch["data"] + np.float32(means), 0, 255)
                                      .astype(np.uint8))
        feeds.append(tb)
    step(state, feeds[0])
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: made.append(a) or real(*a, **k))
    metrics = step(state, feeds[1])
    assert made == [] and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("kind", list(KINDS))
def test_restore_writes_the_state_in_place(kind):
    batches, lib = toy_data()
    step, state = port_step(kind, lib)
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    step(state, tb)
    tensors = [*step.model.state_dict(keep_vars=True).values(), *state.opt.state_tensors()]
    addresses = [t.data_ptr() for t in tensors]
    saved = [t.detach().clone() for t in tensors]
    restore = bench.snapshot(step, state)
    for _ in range(2):
        step(state, tb)
    assert state.step == 3 and not torch.equal(tensors[0], saved[0])
    restore()
    assert state.step == state.opt.count == 1
    after = [*step.model.state_dict(keep_vars=True).values(), *state.opt.state_tensors()]
    assert [t.data_ptr() for t in after] == addresses
    for t, s in zip(after, saved):
        assert torch.equal(t, s)


def test_fastforward_writes_adams_step_in_place():
    batches, lib = toy_data()
    step, state = port_step("adam", lib)
    step(state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    steps = [state.opt.opt.state[p]["step"] for p in state.opt.params]
    ttrain.fastforward_opt_counts(state.opt, 7)
    assert state.opt.count == 7
    assert all(state.opt.opt.state[p]["step"] is t and float(t) == 7.0
               for p, t in zip(state.opt.params, steps))


def test_a_reseeded_generator_draws_what_a_fresh_one_does():
    g = torch.Generator()
    torch.rand(100, generator=g)  # a used stream
    x = torch.ones(50, 60)
    for step in (0, 5, 6):
        for stream, seed in enumerate(ttrain.dropout_seeds(3, step)):
            g.manual_seed(seed)
            fresh = ttrain.dropout_generators(3, step, "cpu")[stream]
            assert torch.equal(dropout(x, 0.5, g), dropout(x, 0.5, fresh)), (step, stream)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def max_distance(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b) if x.numel())


def one_step(step, state, batch, eager: bool):
    """One step (eagerly through `step.eager`): (its metrics, each gradient
    of the trained modules as the update used it, the state after it)."""
    m = step.eager(state, batch) if eager else step(state, batch)
    metrics = [torch.as_tensor(m[k], dtype=torch.float64, device="cpu").reshape(1)
               for k in sorted(m)]
    grads = [p.grad.detach().clone() for mod in step.models() for p in mod.parameters()]
    return metrics, grads, state_of(step, state)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_replayed_steps_equal_eager_steps_on_the_card(cuda, kind):
    """5 consecutive compiled steps (the first the real step and the
    capture, then replays), each against three eager steps from the same
    state: the metrics bit for bit where the eager ones are; each gradient
    within the eager spread or 1e-2 of its largest entry (bf16 ulps moved
    by adds in a device-dependent order) from the nearest eager one; the
    optimizer run eagerly on the compiled step's gradients gives its
    parameters and state bit for bit."""
    batches, lib = toy_data()
    step, state = port_step(kind, lib, device=cuda)
    held = [{k: torch.from_numpy(v).to(cuda) for k, v in b.items()} for b in batches]
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
        for p, g in zip(step.model.parameters(), grads):
            p.grad = g.clone()
        state.opt.prepare()
        state.opt.descend()
        assert max_distance(state_of(step, state), after) == 0.0, i
        keep()
    # one graph a SYMSIZE phase: momentum's switch at step 2 makes a second
    assert len(step.compiled.programs) == (2 if kind == "momentum" else 1)
    for program in step.compiled.programs.values():
        assert program.launches == {"tile": 0, "flat": 1, "window": 1, "scan": 0, "kabsch": 0,
                                    "pose_hyp": 0, "pose_refine": 0}


@pytest.mark.cuda
def test_replayed_dropout_masks_equal_fresh_generators_on_the_card(cuda):
    from posecnn_torch.utils.graph import compile_step

    gens = [torch.Generator(device=cuda) for _ in range(5)]
    x = torch.ones(64, 96, device=cuda)
    masks = []

    def body(batch):
        masks.clear()  # the capture's call leaves its tensors, which each replay rewrites
        masks.extend(dropout(batch["x"], 0.5, g) != 0 for g in gens)
        return {"kept": torch.stack([m.float().mean() for m in masks]).sum()}

    compiled = compile_step(body, generators=gens)
    for step in range(4):  # the real call and the capture, then replays
        for g, seed in zip(gens, ttrain.dropout_seeds(3, step)):
            g.manual_seed(seed)
        compiled({"x": x})
        if step == 0:
            continue  # the masks are the capture's, not yet written
        fresh = ttrain.dropout_generators(3, step, cuda)
        for i, (m, g) in enumerate(zip(masks, fresh)):
            assert torch.equal(m, dropout(x, 0.5, g) != 0), (step, i)
    assert len(compiled.programs) == 1


@pytest.mark.cuda
def test_one_flat_and_one_window_launch_a_replayed_step_on_the_card(cuda):
    from posecnn_torch.ops import hough_kernels as hk

    batches, lib = toy_data()
    step, state = port_step("adam", lib, device=cuda)
    tb = {k: torch.from_numpy(v).to(cuda) for k, v in batches[0].items()}
    hk.LAUNCHES.update(dict.fromkeys(hk.LAUNCHES, 0))
    step(state, tb)  # the real step (eager) and the capture
    assert hk.LAUNCHES == {"tile": 0, "flat": 1, "window": 1, "scan": 0, "kabsch": 0,
                           "pose_hyp": 0, "pose_refine": 0}
    hk.reset_device_launches()
    for _ in range(3):
        step(state, tb)
    assert hk.LAUNCHES == {"tile": 0, "flat": 1, "window": 1, "scan": 0, "kabsch": 0,
                           "pose_hyp": 0, "pose_refine": 0}  # replays call no wrapper
    counted = hk.device_launches()
    assert (counted["flat"], counted["window"], counted["tile"]) == (3, 3, 0)
