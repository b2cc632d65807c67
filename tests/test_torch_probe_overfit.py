"""Port parity: the single-batch pose-overfit probe
(`posecnn_torch/cli/probe_overfit.py`, the counterpart of
`experiments/probe_overfit_pose.py`) on the CPU, at a tiny size.

The port's probe runs 3 steps of each of two configs (adam, momentum)
from the same seeded weights at 64×64 with narrow heads (fc_dim 64,
num_units 8) and keep_prob 1, on a fabricated YCB-Video root. A JAX
computation of the same pose loss (the probe's `loss_fn`, pose-only,
Hough on JAX's "xla" backend, the GT RoIs prepended) on the same batch,
from the port's initial weights carried through `params_to_jax`, with
optax's optimizers at unit rate scaled by lr as the probe does, gives
each step's pose loss, rotation error, |tanh|, pose-head gradient norm
and weighted-row count; the port's history (rounded to 4 decimals, as
JAX's probe writes it) holds them within 2e-4 relative and 1e-4
absolute, the rotation error within 0.002°: fp32 rounding after a few
updates. The JSON holds JAX's keys, and `--assert_below` sets the exit
code.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posecnn_tpu.data.datasets import YCBVideoDataset as JaxYCB
from posecnn_tpu.engine.train import loss_point_scale
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_tpu.ops.add_loss import average_distance_loss
from posecnn_torch.cli import probe_overfit
from posecnn_torch.core.weights import params_to_jax
from posecnn_torch.data.fabricate import write_ycb_tree

torch.set_num_threads(1)
SETS = ["train.fc_dim=64", "train.num_units=8", "train.add_num_points=64",
        "train.hough_num_samples=64", "train.max_pose_rois=4"]
SWEEP = (("adam", 0.0003), ("momentum", 0.001))
ITERS = 3
JAX_RESULT_KEYS = {"opt", "lr", "iters", "fresh_batches", "full_loss", "keep_prob",
                   "final_rot_err", "min_rot_err", "history"}
METRICS = ("loss_pose", "rot_err", "tanh_abs", "num_w", "g_pose", "loss")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("ycb")
    write_ycb_tree(str(path), sets=(("train", 1),), height=48, width=64, num_points=256)
    return str(path)


def argv(root, out, *extra):
    return ["--device", "cpu", "--data_root", root, "--height", "64", "--width", "64",
            "--iters", str(ITERS), "--log_every", "1", "--out", str(out), *extra,
            "--set", *SETS]


@pytest.fixture(scope="module")
def port_run(root, tmp_path_factory):
    out = tmp_path_factory.mktemp("probe") / "probe.json"
    sweep = ",".join(f"{o}:{lr}" for o, lr in SWEEP)
    assert probe_overfit.main(argv(root, out, "--sweep", sweep)) == 0
    with open(out) as f:
        return json.load(f)


def nested(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def jax_history(root):
    """The probe's pose loss and metrics, 3 steps a config, in JAX."""
    args = probe_overfit.make_parser().parse_args(argv(root, "unused"))
    cfg = probe_overfit.load_config(args)
    probe = probe_overfit.build_probe(args, cfg, torch.device("cpu"))
    t = cfg.train
    params0 = nested(params_to_jax(probe.model.state_dict()))
    batch = {k: jnp.asarray(v.numpy()) for k, v in probe.batch.items()}
    model = JaxPoseCNN(num_classes=22, num_units=t.num_units, fc_dim=t.fc_dim,
                       compute_dtype=jnp.float32, vertex_reg=True, pose_reg=True,
                       threshold_label=t.threshold_label, vote_threshold=t.voting_threshold,
                       hough_num_samples=t.hough_num_samples, max_objects=8,
                       max_pose_rois=t.max_pose_rois, gt_pose_rois=True, hough_backend="xla")
    # the ADD points from JAX's reader of the same root, scaled by JAX
    ds = JaxYCB(root, "train")
    idx = np.linspace(0, ds.points.shape[1] - 1, t.add_num_points).astype(int)
    extents = jnp.asarray(ds.extents)
    pts_eff, sym_eff = loss_point_scale(jnp.asarray(ds.points[:, idx]), extents,
                                        jnp.asarray(np.asarray(ds.symmetry, np.float32)),
                                        jnp.asarray(True))

    def loss_fn(params):
        out = model.apply(params, batch["data"], extents, batch["meta"], batch["gt_poses"],
                          batch["gt_valid"], train=True, keep_prob=1.0, dropout_rng=None)
        w = out.hough.poses_weight
        weighted = (jnp.max(w, axis=1) > 0) & out.hough.valid
        num_w = jnp.sum(weighted.astype(jnp.float32))
        lp = average_distance_loss(out.poses_pred, out.hough.poses_target, w, pts_eff, sym_eff,
                                   margin=0.01, num_valid=num_w)
        dot = jnp.abs(jnp.sum(out.poses_pred * out.hough.poses_target, axis=1))
        ang = 2.0 * jnp.arccos(jnp.clip(dot, 0.0, 1.0)) * 180.0 / jnp.pi
        mean_ang = jnp.sum(jnp.where(weighted, ang, 0.0)) / jnp.maximum(num_w, 1.0)
        sat = jnp.sum(jnp.abs(out.poses_tanh) * w) / jnp.maximum(jnp.sum(w), 1.0)
        return lp, {"loss_pose": lp, "rot_err": mean_ang, "tanh_abs": sat, "num_w": num_w,
                    "loss": lp}

    txs = {"momentum": optax.sgd(1.0, momentum=0.9), "adam": optax.adam(1.0)}
    histories = []
    for opt_name, lr in SWEEP:
        tx = txs[opt_name]

        @jax.jit
        def step(params, opt_state, tx=tx, lr=lr):
            (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            metrics["g_pose"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                             jax.tree_util.tree_leaves(grads["params"]
                                                                       ["pose_head"])))
            updates, opt_state = tx.update(grads, opt_state, params)
            updates = jax.tree_util.tree_map(lambda u: lr * u, updates)
            return optax.apply_updates(params, updates), opt_state, metrics

        params, opt_state, hist = params0, tx.init(params0), []
        for _ in range(ITERS):
            params, opt_state, metrics = step(params, opt_state)
            hist.append({k: float(v) for k, v in metrics.items()})
        histories.append(hist)
    return histories


def test_probe_json_holds_jax_keys(port_run):
    assert [(r["opt"], r["lr"]) for r in port_run] == list(SWEEP)
    for r in port_run:
        assert JAX_RESULT_KEYS <= set(r) and r["ms_per_step"] > 0
        assert [h["iter"] for h in r["history"]] == [1, 2, 3]
        assert set(METRICS) <= set(r["history"][0])
        assert r["final_rot_err"] == r["history"][-1]["rot_err"]
        assert r["min_rot_err"] == min(h["rot_err"] for h in r["history"])
    # both configs start from the same weights on the same batch
    assert port_run[0]["history"][0] == port_run[1]["history"][0]


def test_probe_losses_equal_jax(port_run, root):
    for got, want in zip(port_run, jax_history(root)):
        for g, w in zip(got["history"], want):
            assert g["num_w"] == w["num_w"] == 2
            for key in ("loss_pose", "loss", "tanh_abs", "g_pose"):
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-4, err_msg=key)
            np.testing.assert_allclose(g["rot_err"], w["rot_err"], rtol=0, atol=2e-3)


def test_guard_sets_the_exit_code(port_run, root, tmp_path):
    floor = min(r["min_rot_err"] for r in port_run)
    assert probe_overfit.main(argv(root, tmp_path / "a.json", "--iters", "1",
                                   "--sweep", "adam:0.0003", "--assert_below", "1")) == 1
    assert probe_overfit.main(argv(root, tmp_path / "b.json", "--iters", "1",
                                   "--sweep", "adam:0.0003",
                                   "--assert_below", str(floor + 50))) == 0
