"""Port parity: the host-RSS handoff of the training loop
(`engine/train.train_loop`, `train.max_host_rss_gb`), on the CPU.

JAX's loop (`posecnn_tpu/engine/train.py:446-458`) checks the host's RSS
at each display iteration and, past the limit, snapshots at that
iteration and returns. Both loops are driven on the same schedule of RSS
readings with their steps stubbed, and must log, snapshot and stop at the
same iterations. Then the port's `train_net` at a tiny size: a limit
under the process's RSS snapshots at iteration 1 and ends cleanly, and
`--resume` with the handoff off continues from that snapshot to
iteration 3. Only the posecnn step hands off: the detection, GAN,
segmentation and video loops do not check, as in JAX.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posecnn_tpu.engine.train as jtrain
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg
from posecnn_torch.cli import train_net
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.engine import train as ttrain

torch.set_num_threads(1)
TOY = ["train.syn_height=48", "train.syn_width=64", "train.num_classes=4", "train.fc_dim=32",
       "train.num_units=8", "train.ims_per_batch=1", "train.vertex_reg_2d=True",
       "train.pose_reg=True", "train.gt_pose_rois=True", "train.hough_num_samples=64",
       "train.add_num_points=32", "train.display=1", "train.snapshot_iters=100",
       "train.snapshot_prefix=toy"]


def readings(values):
    """An RSS reader that returns `values` in turn, then the last one."""
    values = list(values)

    def read():
        return values.pop(0) if len(values) > 1 else values[0]

    return read


@pytest.mark.parametrize("limit,rss,display", [(5.0, [1.0, 2.0, 6.0, 7.0], 1),
                                               (5.0, [6.0], 2), (0.0, [9.0], 1),
                                               (5.0, [1.0], 1)])
def test_loop_hands_off_where_jax_does(monkeypatch, limit, rss, display):
    overrides = {"train": {"max_host_rss_gb": limit, "display": display, "snapshot_iters": 3}}
    runs = []
    for pkg in ("jax", "port"):
        snaps, logs = [], []
        read = readings(rss)
        if pkg == "jax":
            monkeypatch.setattr(jtrain, "_host_rss_gb", read)
            monkeypatch.setattr(jtrain, "make_train_step", lambda *a, **k: (
                lambda state, batch, rng: (state._replace(step=state.step + 1), {"loss": 1.0})))
            state = jtrain.TrainState(params={}, opt_state=None, step=jnp.asarray(0))
            state = jtrain.train_loop(jax_cfg(overrides), None, state, iter(range(99)), None,
                                      None, None, max_iters=8,
                                      log_fn=lambda it, m: logs.append(it),
                                      snapshot_fn=lambda it, s: snaps.append(it))
            runs.append((snaps, logs, int(state.step)))
        else:
            monkeypatch.setattr(ttrain, "host_rss_gb", read)

            class Step:  # the posecnn step's loop
                host_rss_handoff = True
                continues_numbering = True

                def __call__(self, state, batch):
                    state.step += 1
                    return {"loss": torch.tensor(1.0)}

            state = ttrain.TrainState(opt=None)
            state = ttrain.train_loop(cfg_from_dict(overrides), None, state, iter(range(99)),
                                      None, None, None, max_iters=8,
                                      log_fn=lambda it, m: logs.append(it),
                                      snapshot_fn=lambda it, s: snaps.append(it), step=Step())
            runs.append((snaps, logs, state.step))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("name", ["GanTrainStep", "DetTrainStep", "SegTrainStep",
                                  "VideoTrainStep"])
def test_only_the_posecnn_step_hands_off(name):
    assert ttrain.TrainStep.host_rss_handoff is True
    assert getattr(ttrain, name).host_rss_handoff is False


def test_the_other_loops_run_past_the_limit(monkeypatch):
    monkeypatch.setattr(ttrain, "host_rss_gb", lambda: 99.0)

    class Step:  # another family's loop
        host_rss_handoff = False
        continues_numbering = False

        def __call__(self, state, batch):
            state.step += 1
            return {"loss": torch.tensor(1.0)}

    cfg = cfg_from_dict({"train": {"max_host_rss_gb": 1.0, "display": 1}})
    state = ttrain.train_loop(cfg, None, ttrain.TrainState(opt=None), iter(range(9)), None, None,
                              None, max_iters=4, log_fn=lambda it, m: None, step=Step())
    assert state.step == 4


def run_cli(out_dir, iters, *flags, sets=()):
    args = train_net.make_parser().parse_args(
        ["--device", "cpu", "--iters", str(iters), "--output", str(out_dir), *flags,
         "--set", *TOY, *sets])
    return train_net.main_run(args, train_net.load_config(args), iters)


def test_train_net_hands_off_and_resumes(tmp_path, capsys):
    limit = ttrain.host_rss_gb() / 2  # under the process's RSS from the first step
    assert limit > 0
    state = run_cli(tmp_path, 3, sets=[f"train.max_host_rss_gb={limit}"])
    out = capsys.readouterr().out
    assert state.step == 1 and "snapshotting and exiting for a clean resume" in out
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "*.npz"))) == [
        "toy_iter_1.npz"]
    state = run_cli(tmp_path, 3, "--resume")
    out = capsys.readouterr().out
    assert "--resume: using" in out and "toy_iter_1.npz" in out
    assert state.step == 3 and "snapshotting" not in out
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(line)["iter"] for line in f] == [1, 2, 3]
    assert os.path.exists(tmp_path / "toy_iter_3.npz")
    assert np.isfinite(np.load(tmp_path / "toy_iter_3.npz")["__step__"])
