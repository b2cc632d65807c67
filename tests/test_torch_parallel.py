"""Port parity: data and tensor parallelism (posecnn_torch/parallel) against
one process and against JAX's global-batch step, on the CPU over gloo.

- `create_mesh` lays ranks on the (data, model) grid as JAX's
  `create_mesh` lays conftest's 8 virtual CPU devices (8×1, 4×2, 2×4), and
  raises JAX's two errors;
- `make_sharded_device_put` gives each data rank the rows JAX's
  `batch_sharding` places on its device (`addressable_shards`), and the
  ranks' renumbered GT rows together are the global set, on a batch whose
  images hold different numbers of objects;
- one step on 2 and 4 spawned ranks (`parallel/dryrun.run_ranks`; ranks
  spawned, one torch thread each, a `file://` rendezvous) against one
  process on the same global batch and weights: adam and momentum, and a
  step with the `max_pose_rois` cap cutting, the GT RoIs prepended and the
  matching and domain terms on; the loss and every term within 1e-5, the
  applied gradients within 1e-4 of each parameter's largest entry, every
  updated parameter within 1e-6 (the `MULTICHIP_r05` bar is 3.81e-6 and
  7.41e-8; after an adam step, where the gradient is not at its rounding
  error: see the test), the reported metrics identical on every rank;
- the same steps' global loss and gradients against JAX's
  `jax.value_and_grad` of `model.apply(train=True, keep_prob=1.0)` on the
  global batch, on one device and with the batch sharded over a virtual
  mesh (JAX Hough "xla", the port's "dense"), at tests/test_torch_train_step.py's
  tolerances (losses rtol 1e-4; gradients within 1e-3 of each parameter's
  largest entry);
- DP2×TP2 (`dryrun_multichip(4, device="cpu")`) against one process at the
  same bars, also with the global-norm clip cutting (on the spawn of the
  4-rank data-parallel steps), and the fc6/fc7 shard and gather functions
  round-tripping a JAX checkpoint;
- the GAN step at 2 ranks against one process;
- a world of one: a step with no mesh and one with a world-1 mesh leave
  bit-identical parameters.

Keep-prob 1 throughout: the ranks' dropout streams differ from one
process's by design (ROADMAP, "Random draws").
"""

from dataclasses import replace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
import posecnn_tpu.models.posecnn as jposecnn
from posecnn_tpu.core.checkpoint import _flatten
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.parallel.mesh import batch_sharding, replicated
from posecnn_tpu.parallel.mesh import create_mesh as jax_create_mesh
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.pipeline import make_sharded_device_put
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.models.gan import FeatureDiscriminator
from posecnn_torch.parallel.dryrun import (
    StepCase,
    dryrun_case,
    dryrun_multichip,
    parity,
    run_ranks,
    step_once,
)
from posecnn_torch.parallel.mesh import Mesh, create_mesh, gather_fc_state, shard_fc_state

torch.set_num_threads(1)
C, UNITS, FC, S = 4, 8, 32, 64
H, W, B, MAX_GT = 64, 96, 4, 16
TRAIN = {"num_classes": C, "num_units": UNITS, "fc_dim": FC, "ims_per_batch": B,
         "vertex_reg_2d": True, "pose_reg": True, "gt_pose_rois": True, "symsize": 0,
         "hough_num_samples": S, "weight_reg": 1e-4}
MODEL = dict(num_units=UNITS, fc_dim=FC, hough_num_samples=S, max_objects=2, gt_pose_rois=True)
# against one process; a term also within 1e-7 of its size (its fp32
# rounding: the GAN's adversarial term is ~220, whose ulp is 1.5e-5)
DLOSS, DPARAM, TERM_RTOL = 1e-5, 1e-6, 1e-7
# the cases each spawn of ranks runs: the GAN step at 2 ranks only
RANK_CASES = {2: ("adam", "momentum", "capped", "gan"), 4: ("adam", "momentum", "capped")}


class DomainHead32(jposecnn.DomainHead):
    """The JAX head in fp32, like the rest of the test's JAX model."""

    compute_dtype: Any = jnp.float32


def global_batch(seed=4):
    """B images holding 3, 1, 3 and 1 objects (seed 4), sparse vertex feed."""
    lib = synthetic_class_library(C, 256)
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=W, height=H, seed=seed,
                                  min_objects=1, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = gen.minibatch(B, max_gt=MAX_GT, dense_vertex_targets=False)
    del batch["depth"]
    return batch, lib


def case_train(name, batch):
    """The cfg's train section of a case; the capped one keeps 3 rows past
    the valid GT rows, so its cut falls among the Hough rows."""
    if name == "capped":
        return dict(TRAIN, optimizer="adam", matching=True, adapt=True, adapt_weight=0.1,
                    max_pose_rois=int(batch["gt_valid"].sum()) + 3)
    return dict(TRAIN, optimizer=name, grad_clip=0.5 if name == "adam" else 0.0)


def gan_case(batch, lib):
    """The GAN step (seg + vertex generator, fp32 discriminator), seeded."""
    from posecnn_torch.models.posecnn import PoseCNN

    train = {"num_classes": C, "num_units": UNITS, "ims_per_batch": B, "vertex_reg_2d": True,
             "pose_reg": False, "gan": True, "gan_weight": 0.5, "optimizer": "adam",
             "weight_reg": 1e-4}
    model = PoseCNN(C, num_units=UNITS, pose_reg=False)
    init_weights(model, 0)
    disc = FeatureDiscriminator(3 * C + 3)
    init_weights(disc, 1)
    return StepCase(cfg={"train": train}, num_classes=C,
                    model_kw=dict(num_units=UNITS, pose_reg=False), state=model.state_dict(),
                    batch=batch, points=lib.points[:, :64], extents=lib.extents,
                    symmetry=lib.symmetry, disc_state=disc.state_dict())


@pytest.fixture(scope="module")
def cases():
    """Each case's JAX global-batch loss and gradients (one device, and the
    batch sharded over a 2-device mesh; adam's and momentum's are one
    forward) and its port `StepCase` on the same weights; the GAN case
    is the port's alone."""
    batch, lib = global_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ext = jnp.asarray(lib.extents)
    points = lib.points[:, :64]
    pts, sym = jtrain.loss_point_scale(jnp.asarray(points), ext, jnp.asarray(lib.symmetry),
                                       jnp.asarray(True))
    mesh = jax_create_mesh(num_data=2)
    sharded = {k: jax.device_put(v, replicated(mesh) if k in ("gt_poses", "gt_valid")
                                 else batch_sharding(mesh)) for k, v in jb.items()}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jposecnn, "DomainHead", DomainHead32)
        for name in ("adam", "capped"):
            train = case_train(name, batch)
            capped = name == "capped"
            jmodel = jposecnn.PoseCNN(num_classes=C, hough_backend="xla",
                                      compute_dtype=jnp.float32, adaptation=capped,
                                      max_pose_rois=train.get("max_pose_rois", 0), **MODEL)
            jcfg = jax_cfg_from_dict({"train": train})
            params = jax.jit(lambda key: jmodel.init(key, jb["data"], ext, jb["meta"],
                                                     train=False))(jax.random.PRNGKey(0))

            def loss_fn(p, b, jmodel=jmodel, jcfg=jcfg):
                o = jmodel.apply(p, b["data"], ext, b["meta"], b["gt_poses"], b["gt_valid"],
                                 train=True, keep_prob=1.0)
                return jtrain._compose_losses_from_outputs(o, b, jcfg, pts, ext, sym)

            grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            (_, metrics), grads = grad_fn(params, jb)
            (_, metrics_sharded), grads_sharded = grad_fn(params, sharded)
            state = params_from_jax(_flatten(params))
            out[name] = dict(
                jax=({k: float(v) for k, v in metrics.items()},
                     params_from_jax(_flatten(grads))),
                jax_sharded=({k: float(v) for k, v in metrics_sharded.items()},
                             params_from_jax(_flatten(grads_sharded))),
                case=StepCase(cfg={"train": train}, num_classes=C,
                              model_kw=dict(MODEL, hough_backend="dense", adaptation=capped,
                                            max_pose_rois=train.get("max_pose_rois", 0)),
                              state=state, batch=batch, points=points, extents=lib.extents,
                              symmetry=lib.symmetry))
    out["momentum"] = dict(out["adam"], case=replace(
        out["adam"]["case"], cfg={"train": case_train("momentum", batch)}))
    out["gan"] = {"case": gan_case(batch, lib)}
    return out


@pytest.fixture(scope="module")
def one_process(cases):
    return {name: step_once(c["case"], "cpu") for name, c in cases.items()}


def tp_clip_case():
    """The dry run's step at 4 images with momentum and the global-norm
    clip cutting."""
    case = dryrun_case(4)
    return replace(case, cfg={"train": dict(case.cfg["train"], optimizer="momentum",
                                            grad_clip=0.5)})


@pytest.fixture(scope="module")
def two_ranks(cases):
    names = RANK_CASES[2]
    results = run_ranks([([cases[name]["case"] for name in names], 2, 1)],
                        devices=["cpu"] * 2, backend="gloo", num_threads=1)
    return dict(zip(names, results[0]))


@pytest.fixture(scope="module")
def four_ranks(cases):
    """The 4-rank data-parallel steps and, on the same ranks, the DP2×TP2
    clip case (its `StepCase` under "tp_clip_case")."""
    names, tp_case = RANK_CASES[4], tp_clip_case()
    dp, tp = run_ranks([([cases[name]["case"] for name in names], 4, 1), ([tp_case], 2, 2)],
                       devices=["cpu"] * 4, backend="gloo", num_threads=1)
    return dict(zip(names, dp), tp_clip=tp[0], tp_clip_case=tp_case)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    n = request.param
    results = request.getfixturevalue("two_ranks" if n == 2 else "four_ranks")
    return n, {name: results[name] for name in RANK_CASES[n]}


@pytest.mark.parametrize("num_data,num_model", [(8, 1), (4, 2), (2, 4), (-1, 2)])
def test_create_mesh_grid_matches_jax(num_data, num_model):
    want = jax_create_mesh(num_data=num_data, num_model=num_model)
    got = create_mesh(num_data, num_model, world=8)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.grid, ids - ids.min())
    assert got.shape == dict(want.shape)
    for rank in range(got.grid.size):
        mesh = Mesh(got.grid, rank=rank)
        assert got.grid[mesh.data_index, mesh.model_index] == rank


@pytest.mark.parametrize("num_data,num_model", [(-1, 3), (4, 4)])
def test_create_mesh_errors_match_jax(num_data, num_model):
    with pytest.raises(ValueError) as want:
        jax_create_mesh(num_data=num_data, num_model=num_model)
    with pytest.raises(ValueError) as got:
        create_mesh(num_data, num_model, world=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_put_matches_jax_batch_sharding(n):
    batch, _ = global_batch()
    counts = np.bincount(batch["gt_poses"][batch["gt_valid"], 0].astype(int), minlength=B)
    assert len(set(counts)) > 1, counts  # images with different numbers of objects
    mesh = jax_create_mesh(num_data=n)
    gathered = []
    for key, v in batch.items():
        if key in ("gt_poses", "gt_valid"):
            continue
        shards = jax.device_put(jnp.asarray(v), batch_sharding(mesh)).addressable_shards
        by_device = {s.device.id: np.asarray(s.data) for s in shards}
        for d in range(n):
            got = make_sharded_device_put(Mesh(np.arange(n)[:, None], rank=d),
                                          device="cpu")(batch)
            np.testing.assert_array_equal(got[key].numpy(), by_device[mesh.devices[d, 0].id],
                                          err_msg=key)
    for d in range(n):
        got = make_sharded_device_put(Mesh(np.arange(n)[:, None], rank=d), device="cpu")(batch)
        rows, valid = got["gt_poses"].numpy(), got["gt_valid"].numpy()
        assert rows.shape == batch["gt_poses"].shape and valid.shape == batch["gt_valid"].shape
        assert (rows[valid, 0] < B // n).all()
        rows = rows[valid].copy()
        rows[:, 0] += d * B // n
        gathered.append(rows)
    np.testing.assert_array_equal(np.concatenate(gathered),
                                  batch["gt_poses"][batch["gt_valid"]])


def assert_step_matches(name, want, got, case):
    """`got` (N ranks) against `want` (one process): the terms, the
    gradients applied and the parameters after the step."""
    assert set(got.metrics) == set(want.metrics), name
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) <= DLOSS + TERM_RTOL * abs(v), (name, k)
    # every rank reports the global values
    for other in got.per_rank_metrics:
        assert other == got.metrics, name
    train = case.cfg["train"]
    state = dict(case.state, **{f"disc.{k}": v for k, v in (case.disc_state or {}).items()})
    for key, wg in want.grads.items():
        scale = float(wg.abs().max())
        # a convolution's gradient sums ~1e5 pixel terms that cancel, in
        # another order on each rank: within 1e-4 of the largest entry
        assert float((got.grads[key] - wg).abs().max()) <= 1e-4 * scale, (name, key)
        dparam = (got.params[key] - want.params[key]).abs()
        if train["optimizer"] == "adam":
            # adam's first update is lr·g/(|g| + 1e-8): where the applied
            # gradient (decay included) is near its rounding error (the
            # batch summed in another order moves it by ~1e-7 of the
            # largest entry) its sign, and so the update, can flip by up
            # to 2·lr; the parameters are held where it is not
            decay = 0.0 if key.startswith("disc.") else train["weight_reg"]
            decayed = wg + decay * state[key] * (state[key].ndim > 1)
            dparam = dparam[decayed.abs() > 1e-4 * scale]
        assert dparam.numel() == 0 or float(dparam.max()) <= DPARAM, (name, key)
    assert max(float((got.params[k] - v).abs().max()) for k, v in state.items()) > 1e-4


def test_ranks_match_one_process(ranks, one_process, cases):
    n, results = ranks
    for name, got in results.items():
        assert_step_matches(f"{name} at {n} ranks", one_process[name], got, cases[name]["case"])


@pytest.mark.parametrize("side", ["jax", "jax_sharded"])
def test_ranks_match_jax_global_batch(ranks, cases, side):
    n, results = ranks
    for name in ("adam", "momentum", "capped"):
        got = results[name]
        want_metrics, want_grads = cases[name][side]
        assert set(got.metrics) - {"lr"} == set(want_metrics), name
        for k, v in want_metrics.items():
            np.testing.assert_allclose(got.metrics[k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} {k}")
        assert want_metrics["num_pose_rois"] > 0
        for key, wg in want_grads.items():
            scale = float(wg.abs().max())
            assert scale > 0, key
            np.testing.assert_allclose(got.grads[key].numpy(), wg.numpy(), rtol=0,
                                       atol=1e-3 * scale, err_msg=f"{name} {key}")


def test_cap_cuts_among_the_hough_rows(cases):
    """The capped case's cap falls past the GT rows: JAX keeps `cap` rows,
    some of them Hough rows, and the domain and matching terms count."""
    metrics, _ = cases["capped"]["jax"]
    cap = cases["capped"]["case"].cfg["train"]["max_pose_rois"]
    assert metrics["num_rois"] == cap
    assert metrics["loss_domain"] > 0 and metrics["loss_match"] > 0


def test_tensor_parallel_dryrun_matches_one_process():
    result = dryrun_multichip(4, device="cpu")
    assert (result["num_data"], result["num_model"]) == (2, 2)
    assert result["dloss"] <= DLOSS and result["dparam"] <= DPARAM


def test_tensor_parallel_clip_counts_each_shard_once(four_ranks):
    """DP2×TP2 with momentum and the global-norm clip cutting: the norm sums
    the fc6/fc7 shards' squares over the model group."""
    want = step_once(four_ranks["tp_clip_case"], "cpu")
    dloss, dparam = parity(want, four_ranks["tp_clip"])
    assert dloss <= DLOSS and dparam <= DPARAM, (dloss, dparam)
    assert max(float(g.norm()) for g in want.grads.values()) > 0.5  # the clip cuts


def test_fc_shards_round_trip_a_jax_checkpoint(cases):
    state = cases["adam"]["case"].state
    shards = [shard_fc_state(state, r, 2) for r in range(2)]
    for name in ("fc6", "fc7"):
        key = f"pose_head.{name}.weight"
        assert shards[0][key].shape[0] == FC // 2
        # the shard is the flax kernel's columns under P(None, 'model')
        np.testing.assert_array_equal(shards[1][key].numpy().T,
                                      state[key].numpy().T[:, FC // 2:])
    back = gather_fc_state(shards)
    assert set(back) == set(state)
    for key, v in state.items():
        assert torch.equal(back[key], v), key


def test_gan_step_ranks_match_one_process(two_ranks, one_process, cases):
    got = two_ranks["gan"]
    assert {"loss_g_adv", "loss_d"} <= set(got.metrics)
    assert any(k.startswith("disc.") for k in got.grads)
    assert_step_matches("gan at 2 ranks", one_process["gan"], got, cases["gan"]["case"])


def test_world_of_one_is_bit_identical(cases):
    case = cases["capped"]["case"]
    plain = step_once(case, torch.device("cpu"))
    mesh = create_mesh(world=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    meshed = step_once(case, torch.device("cpu"), mesh)
    assert meshed.metrics == plain.metrics
    for k, v in plain.params.items():
        assert torch.equal(meshed.params[k], v), k
