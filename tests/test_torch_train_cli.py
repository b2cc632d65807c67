"""Port: the training CLI (posecnn_torch.cli.train_net) at toy size on the
CPU, snapshots both ways between the packages, and the carried feed
(`pooled_minibatch`, `compact_feed`, `Prefetcher`) against the JAX
package's for the same seed.

Checkpoints are held bit for bit (a copy in another layout); the feed
arrays bit for bit, with the JAX package's native splat library off as
in tests/test_torch_synthetic.py.
"""

import json
import os
import threading
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.data.native as jnative
import posecnn_tpu.data.pipeline as jpipe
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator as JaxGenerator
from posecnn_tpu.models import PoseCNN as JaxPoseCNN
from posecnn_torch.cli import common, train_net
from posecnn_torch.core import checkpoint as tckpt
from posecnn_torch.core.weights import load_npz, params_from_jax
from posecnn_torch.data import pipeline as tpipe
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.models.posecnn import PoseCNN, init_weights

torch.set_num_threads(1)
C, UNITS, FC = 4, 8, 32
TOY = ["train.syn_height=64", "train.syn_width=96", f"train.num_classes={C}",
       f"train.fc_dim={FC}", f"train.num_units={UNITS}", "train.ims_per_batch=2",
       "train.vertex_reg_2d=True", "train.pose_reg=True", "train.gt_pose_rois=True",
       "train.hough_num_samples=64", "train.add_num_points=64", "train.display=1",
       "train.optimizer=adam", "train.grad_clip=35.0", "train.syn_pool_size=6",
       "train.snapshot_iters=2", "train.snapshot_prefix=toy"]


def run_cli(out_dir, iters, *extra):
    argv = ["--device", "cpu", "--iters", str(iters), "--output", str(out_dir), "--set",
            *TOY, *extra]
    args = train_net.make_parser().parse_args(argv)
    return train_net.main_run(args, train_net.load_config(args), iters), args


def read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    state, _ = run_cli(out, 2)
    return out, state


def test_cli_trains_and_writes_metrics_and_snapshots(trained):
    out, state = trained
    assert state.step == 2
    lines = read_metrics(out)
    assert [m["iter"] for m in lines] == [1, 2]
    for m in lines:
        for k in ("loss", "loss_cls", "loss_vertex", "loss_pose", "loss_qmag", "lr"):
            assert np.isfinite(m[k]), (k, m)
        assert m["num_pose_rois"] > 0
    assert os.path.exists(out / "toy_iter_2.npz")


def test_resume_continues_numbering_with_a_fresh_optimizer(trained, tmp_path):
    out, _ = trained
    state, _ = run_cli(tmp_path, 3, "train.stepsize=1", "train.gamma=0.5",
                       "--ckpt", str(out / "toy_iter_2.npz"))
    # the JAX CLI's resume: a fresh optimizer (count 0, zero moments) that
    # took one update, Adam's step 1 (its first, fully bias-corrected), the
    # global step continued from 2
    assert state.step == 3 and state.opt.count == 1
    assert all(float(state.opt.opt.state[p]["step"]) == 1 for p in state.opt.params)
    lines = read_metrics(tmp_path)
    assert [m["iter"] for m in lines] == [3]
    # the staircase follows the global step through lr_step_offset = 2:
    # 0.001 · 0.5^2 at step 2, applied at count 0 and logged at step 2
    assert state.opt.schedule(0) == lines[0]["lr"] == pytest.approx(0.001 * 0.25)
    assert os.path.exists(tmp_path / "toy_iter_3.npz")


def test_reinit_rerandomizes_only_the_named_module(trained, tmp_path):
    out, _ = trained
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--set", *TOY, "--ckpt", str(out / "toy_iter_2.npz"),
         "--reinit", "pose_head"])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    tr.batches.close()
    fresh = PoseCNN(C, num_units=UNITS, fc_dim=FC)
    init_weights(fresh, tr.cfg.rng_seed)
    saved = params_from_jax(load_npz(str(out / "toy_iter_2.npz")))
    for name, value in tr.model.state_dict().items():
        want = fresh.state_dict()[name] if name.startswith("pose_head.") else saved[name]
        torch.testing.assert_close(value, want, rtol=0, atol=0, msg=name)
    assert tr.state.step == tr.cfg.train.lr_step_offset == 2 and tr.state.opt.count == 0


@lru_cache(maxsize=1)
def jax_template():
    model = JaxPoseCNN(num_classes=C, num_units=UNITS, fc_dim=FC, compute_dtype=jnp.float32)
    x = jnp.zeros((1, 64, 96, 3))
    return jax.jit(lambda key: model.init(key, x, jnp.ones((C, 3)) * 0.1, jnp.zeros((1, 48)),
                                          train=False))(jax.random.PRNGKey(1))


def test_port_snapshot_restores_in_jax(trained):
    out, _ = trained
    path = str(out / "toy_iter_2.npz")
    restored, step = jckpt.restore_params(path, jax_template(), verbose=False)
    assert step == 2
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC)
    assert tckpt.restore_params(path, model) == 2
    got = params_from_jax(jckpt._flatten(jax.device_get(restored)))
    for name, value in model.state_dict().items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)
    assert jckpt.read_ckpt_meta(path)["quat_activation"] == "linear"


def test_jax_snapshot_restores_in_port(tmp_path):
    params = jax_template()
    path = str(tmp_path / "jax_iter_7.npz")
    jckpt.save_params(path, params, step=7)
    model = PoseCNN(C, num_units=UNITS, fc_dim=FC)
    assert tckpt.restore_params(path, model) == 7
    want = params_from_jax(jckpt._flatten(params))
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)
    # and back: the port writes the JAX file's arrays
    again = str(tmp_path / "port_iter_7.npz")
    tckpt.save_params(again, model, step=7)
    a, b = np.load(path), np.load(again)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshot_naming_and_pruning(tmp_path):
    assert tckpt.snapshot_path("d", "p", "x", 5) == jckpt.snapshot_path("d", "p", "x", 5)
    for i in (1, 2, 3, 10):
        (tmp_path / f"p_iter_{i}.npz").write_bytes(b"")
    tckpt.prune_snapshots(str(tmp_path), "p", keep=2)
    assert sorted(os.listdir(tmp_path)) == ["p_iter_10.npz", "p_iter_3.npz"]


def generators():
    lib = synthetic_class_library(C, 256)
    k = np.array([[75.0, 0, 48], [0, 75.0, 32], [0, 0, 1]], np.float32)
    kw = dict(width=96, height=64, seed=11, min_objects=2, max_objects=3,
              point_colors=lib.colors, point_normals=lib.normals)
    # the port's numpy path, for JAX's with its library off
    return (SyntheticSceneGenerator(lib.points, lib.extents, k, native=False, **kw),
            JaxGenerator(lib.points, lib.extents, k, **kw))


def test_pooled_minibatch_and_compact_feed_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    gen_t, gen_j = generators()
    pm = (102.9801, 115.9465, 122.7717)
    for _ in range(3):  # the first call fills the pool, then 1 fresh render a call
        got = gen_t.pooled_minibatch(3, max_gt=8, dense_vertex_targets=False, pool_size=4,
                                     fresh=1)
        want = gen_j.pooled_minibatch(3, max_gt=8, dense_vertex_targets=False, pool_size=4,
                                      fresh=1)
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        cg, cw = tpipe.compact_feed(got, pm), jpipe.compact_feed(want, pm)
        assert set(cg) == set(cw) and "depth" not in cg and cg["data"].dtype == np.uint8
        for key in cg:
            np.testing.assert_array_equal(cg[key], cw[key], err_msg=key)
    assert len(gen_t._pool) == 4


def test_prefetcher_gives_each_worker_its_own_producer():
    # each producer waits for the consumer to take a batch of the other
    # worker's, so both ids come out whatever the threads' scheduling:
    # worker 0 starts after a batch of worker 1's was taken, and worker 1
    # goes on past its first batch after one of worker 0's was taken
    made, taken = [], {0: threading.Event(), 1: threading.Event()}

    def factory(worker_id):
        def make_batch():
            if worker_id == 0 or 1 in made:
                assert taken[1 - worker_id].wait(60), f"worker {worker_id} starved"
            made.append(worker_id)
            return {"worker": worker_id}

        return make_batch

    pre = tpipe.Prefetcher(make_batch_factory=factory, queue_size=2, num_workers=2)
    try:
        seen = []
        for _ in range(20):
            worker = next(pre)["worker"]
            taken[worker].set()
            seen.append(worker)
    finally:
        pre.close()
    assert seen[:2] == [1, 0] and set(seen) == {0, 1} and set(made) == {0, 1}
    assert pre.gets == 20 and 0 <= pre.dry <= 20 and len(pre.produce_seconds) >= 20
    assert not any(w.is_alive() for w in pre.workers)


def test_backgrounds_the_caller_asked_for_are_read_or_raise(tmp_path):
    from PIL import Image

    good = tmp_path / "bg_0.png"
    Image.fromarray(np.full((8, 12, 3), (10, 20, 30), np.uint8)).save(good)
    pool = common.load_backgrounds(str(tmp_path / "bg_*.png"), (4, 6))
    assert pool.shape == (1, 4, 6, 3) and tuple(pool[0, 0, 0]) == (30.0, 20.0, 10.0)  # BGR
    (tmp_path / "bg_1.png").write_bytes(b"not an image")
    with pytest.raises(OSError, match="bg_1.png"):
        common.load_backgrounds(str(tmp_path / "bg_*.png"), (4, 6))
    with pytest.raises(FileNotFoundError):
        common.load_backgrounds(str(tmp_path / "none_*.png"), (4, 6))


def test_prefetcher_raises_a_worker_failure_instead_of_waiting():
    def factory(worker_id):
        def make_batch():
            raise ValueError(f"render failed in worker {worker_id}")

        return make_batch

    pre = tpipe.Prefetcher(factory, queue_size=2, num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed") as info:
            next(pre)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        pre.close()
    assert not any(w.is_alive() for w in pre.workers)
