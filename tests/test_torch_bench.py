"""The port's benches (`posecnn_torch/bench.py`) and their loop
(`posecnn_torch/utils/graph.py`) on the CPU.

The timing protocol's arithmetic on a fake clock; each subcommand's exit
without a card; a short `train` loop against hand-run `TrainStep` calls
with the same loss·1e-20 perturbation, and its restore to one state
before each timed run; the `phases` models against the
JAX script's switches; the loop body's checksum against JAX's; and
`capture_loop`'s refusal of CPU tensors. The CUDA graph itself runs only
on a card: the `cuda` test holds its replay to the eager forward bit for
bit there (`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_bench.py`).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from posecnn_torch import bench
from posecnn_torch.entry import NUM_CLASSES, flagship_model, forward_fn, make_inputs
from posecnn_torch.utils.graph import capture_loop, checksum, eager_loop

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=4, height=48, width=64, fc_dim=32, num_units=8, hough_num_samples=32)


def test_differenced_median_on_a_fake_clock():
    """Each run of n bodies costs a fixed 7 s plus 0.25 s a body on one
    clock and 3 s plus 0.5 s a body on the other, with one slow run: the
    protocol's result is each clock's per-body cost, and it warms both
    counts first."""
    calls = []
    slow = {3: 10.0}  # the 4th call overall runs 10 s long

    def run(n):
        calls.append(n)
        extra = slow.get(len(calls) - 1, 0.0)
        return 7.0 + 0.25 * n + extra, 3.0 + 0.5 * n

    per_body = bench.differenced_median(run, 5, 45)
    assert calls == [5, 45] + [5, 45] * 3
    assert per_body == pytest.approx((0.25, 0.5))


@pytest.mark.parametrize("command", ["infer", "phases", "train"])
def test_each_command_without_a_card_exits_nonzero(command, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([command]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_bench_command_exits_nonzero_here():
    run = subprocess.run([sys.executable, "-m", "posecnn_torch.bench", "infer"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert run.returncode != 0 and run.stdout == ""


def test_train_loop_equals_hand_run_steps():
    """`train_steps` is n `TrainStep` calls, step i+1 on data + loss_i·1e-20."""
    n = 3
    step, state, batch = bench.train_setup("cpu", dense=False, compute_dtype=torch.float32,
                                           **TINY)
    got = bench.train_steps(step, state, batch, n)

    ref_step, ref_state, ref_batch = bench.train_setup("cpu", dense=False,
                                                       compute_dtype=torch.float32, **TINY)
    loss = torch.zeros(())
    for _ in range(n):
        data = ref_batch["data"] + loss * 1e-20
        # the perturbation is below half an ulp: each step sees the batch itself
        assert torch.equal(data, ref_batch["data"])
        loss = ref_step(ref_state, {**ref_batch, "data": data})["loss"]
    assert state.step == ref_state.step == n
    assert torch.equal(got, loss) and torch.isfinite(got)
    for (name, p), q in zip(step.model.named_parameters(), ref_step.model.parameters()):
        assert torch.equal(p, q), name


def test_snapshot_restarts_each_timed_run_from_one_state():
    """As JAX's functional `run`, every timed train run starts from the
    same model, optimizer state and step: after restore() the same n
    steps give the same loss and parameters again."""
    step, state, batch = bench.train_setup("cpu", dense=False, compute_dtype=torch.float32,
                                           **TINY)
    bench.train_steps(step, state, batch, 1)  # the warm-up: momentum buffers exist
    restore = bench.snapshot(step, state)
    first = bench.train_steps(step, state, batch, 2)
    after = {k: v.clone() for k, v in step.model.state_dict().items()}
    assert state.step == state.opt.count == 3
    restore()
    assert state.step == state.opt.count == 1
    again = bench.train_steps(step, state, batch, 2)
    assert torch.equal(first, again)
    for key, value in step.model.state_dict().items():
        assert torch.equal(value, after[key]), key
    # the snapshot itself was not moved by the steps after it
    restore()
    assert torch.equal(bench.train_steps(step, state, batch, 2), first)


def test_train_setup_is_bench_trains_config():
    step, state, batch = bench.train_setup("cpu", dense=True, compute_dtype=torch.float32,
                                           **TINY)
    t = step.cfg.train
    assert (t.ims_per_batch, t.hough_num_samples, t.max_rois, t.add_num_points) == (2, 128, 36,
                                                                                    512)
    assert t.vertex_reg_2d and t.pose_reg and step.keep_prob == 0.5
    assert step.model.hough_kw["max_objects_per_image"] == 2
    assert step.model.hough_kw["cell_stride"] == 1
    assert batch["data"].shape == (2, 48, 64, 3) and "vertex_targets" in batch
    # bench_train.py:64-67: the class points of RandomState(0)
    rng = np.random.RandomState(0)
    points = (rng.rand(4, 512, 3).astype(np.float32) - 0.5) * 0.12
    points[0] = 0
    np.testing.assert_array_equal(step.extents.numpy(), np.abs(points).max(1) * 2)


def test_phases_switch_the_heads_as_jax_does():
    with open(os.path.join(REPO, "experiments", "bench_graph_phases.py")) as f:
        jax_calls = re.findall(r'model_time\("(\w+)", vertex_reg=(\w+), pose_reg=(\w+)\)',
                               f.read())
    assert [(name, str(sw["vertex_reg"]), str(sw["pose_reg"]))
            for name, sw in bench.PHASES] == jax_calls
    inp = make_inputs(1, 64, 96, NUM_CLASSES, device="cpu")
    args = (inp["data"], inp["extents"], inp["meta"])
    present = []
    for _, switches in bench.PHASES:
        fn = forward_fn(flagship_model(1, device="cpu", compute_dtype=torch.float32,
                                       **switches))
        label, rois, poses = fn(*args)
        assert label.shape == (1, 64, 96)
        present.append((rois is not None, poses is not None))
        assert torch.isfinite(checksum((label, rois, poses)))
    # A: trunk + seg; B: + vertex head and Hough; C: + the pose head
    assert present == [(False, False), (True, False), (True, True)]


def test_checksum_is_jaxs():
    import jax.numpy as jnp  # here: the card's machine, which runs the cuda test, has no jax

    rng = np.random.RandomState(1)
    label = rng.randint(0, 22, (1, 48, 64)).astype(np.int32)
    rois = (rng.rand(8, 7) * 100).astype(np.float32)
    poses = rng.randn(8, 88).astype(np.float32)
    want = (jnp.sum(jnp.asarray(rois)) * 1e-6 + jnp.sum(jnp.asarray(label)) * 1e-9
            + jnp.sum(jnp.asarray(poses)) * 1e-6).astype(jnp.float32)
    got = checksum((torch.from_numpy(label).long(), torch.from_numpy(rois),
                    torch.from_numpy(poses)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert checksum((torch.from_numpy(label).long(), None, None)).item() == pytest.approx(
        label.sum() * 1e-9, rel=1e-6)


def test_eager_loop_feeds_each_body_the_last_checksum():
    seen, outputs = [], []
    data = torch.full((1, 4, 4, 3), 1e-30)  # small enough for acc·1e-20 to show

    def fn(d, extents, meta):
        seen.append(d.clone())
        outputs.append((torch.full((1, 4, 4), len(seen)), None, None))
        return outputs[-1]

    acc = eager_loop(fn, (data, torch.zeros(2, 3), torch.zeros(1, 48)), 3)
    assert torch.equal(seen[0], data)
    for i in (1, 2):
        assert not torch.equal(seen[i], data)
        assert torch.equal(seen[i], data + checksum(outputs[i - 1]) * 1e-20)
    assert torch.equal(acc, checksum(outputs[2]))


def test_capture_loop_refuses_cpu_tensors():
    inp = make_inputs(1, 48, 64, 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        capture_loop(lambda *a: None, (inp["data"], inp["extents"], inp["meta"]), 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_stride", [4, 1])
def test_graph_replay_equals_eager(cuda, cell_stride):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = make_inputs(1, 480, 640, NUM_CLASSES, device=cuda)
    args = (inp["data"], inp["extents"], inp["meta"])
    fn = forward_fn(flagship_model(cell_stride, device=cuda))
    want = fn(*args)
    replay, got, launches = capture_loop(fn, args, 3)
    replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert launches == {"tile": 0, "flat": 1, "window": 1, "scan": 0}
