"""The repository's measurement entry points, on one NVIDIA GPU.

    python -m posecnn_torch.bench [infer|phases|train]

Counterpart of the JAX repository's `bench.py` (`infer`, the default),
`experiments/bench_graph_phases.py:86-118` (`phases`) and
`experiments/bench_train.py` (`train`). Each keeps its script's
configuration, seeds and loop counts n1 / n2, and its protocol: warm both
counts, then the median of 3 differenced pairs (t(n2) − t(n1)) / (n2 − n1),
which removes the loop's fixed cost. Time is CUDA events around the run
and a synchronise; the host clock is printed beside it. Every line is one
JSON object and names the card and its power limit; the metric names
carry `torch` and `h100`, so they never mix with the TPU's.

  infer   the forward of `bench.py:46-53` (22 classes, 480×640, num_units
          64, 128 Hough samples, 8 objects, cell stride 1, bf16, seeded
          weights, `entry.make_inputs` at batch 1), n1 = 5, n2 = 45. The
          JAX bench runs n forwards in one compiled `fori_loop`, frame
          i+1 reading data + acc·1e-20 with acc frame i's checksum; here
          the same loop is one CUDA graph (`utils/graph.capture_loop`),
          so the time is the device's. The last line is the metric
          `posecnn_torch_inference_fps_480x640_22cls_h100`, with
          vs_baseline = fps / 10 (`bench.py`'s V100 envelope). The line
          before it, `…_h100_eager`, gives the same loop called eagerly
          with one synchronise at the end: what a server pays for the
          forward without HTTP.
  phases  nested subsets of the same graph at batch 1: A trunk + seg
          (`vertex_reg` off), B + vertex head + Hough (`pose_reg` off),
          C the full forward; then C at batch 4 (n2 = 25), ms an image and
          frames/s. Each from a CUDA graph.
  train   `bench_train.py`'s step: 22 classes, 480×640, batch 2, fc_dim
          4096, 128 Hough samples, 2 objects an image, cell stride 1,
          bf16, the cfg's optimizer (momentum), keep_prob 0.5; class
          points from RandomState(0); one fixed batch rendered by the
          carried generator (its C++ loops) at RandomState(0), with the
          sparse vertex feed (the headline) and the dense one. n steps of
          `TrainStep.forward / backward / update` on that batch, step i+1
          reading data + loss_i·1e-20, no host read between steps, n1 = 3,
          n2 = 23. As JAX's functional `run` starts every call from the
          same state, every timed run starts from the model, optimizer and
          step of the end of the warm-up, restored outside the events.
          Eager: the training forward copies host constants to the device,
          which a CUDA graph cannot capture. A line before the last gives
          torch.profiler's device-busy ms of one step.

Without a CUDA device the command exits non-zero: it measures the card
and has no CPU mode.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from typing import Callable, Sequence

import numpy as np
import torch

from posecnn_torch.cli.common import setup_device
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.pipeline import to_device
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import create_train_state, make_train_step
from posecnn_torch.entry import (
    HEIGHT,
    NUM_CLASSES,
    WIDTH,
    flagship_model,
    forward_fn,
    make_inputs,
)
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.utils.graph import capture_loop, eager_loop

INFER_N = (5, 45)  # bench.py:82
PHASES_N, BATCH4_N = (5, 45), (5, 25)  # bench_graph_phases.py:29, :117
TRAIN_N = (3, 23)  # bench_train.py:107
PAIRS = 3  # the median of 3 differenced pairs
INFER_METRIC = "posecnn_torch_inference_fps_480x640_22cls_h100"
BASELINE_FPS = 10.0
BASELINE_NOTE = ("envelope estimate: ~10 fps V100-class (repo publishes no in-tree number; "
                 "BASELINE.md)")
# bench_graph_phases.py:86-88: the head switches of each nested subset
PHASES = (("A_trunk_seg", dict(vertex_reg=False, pose_reg=False)),
          ("B_plus_vertex_hough", dict(vertex_reg=True, pose_reg=False)),
          ("C_full", dict(vertex_reg=True, pose_reg=True)))
# bench_train.py:43-75
TRAIN_BATCH, TRAIN_POINTS = 2, 512
TRAIN_MODEL = dict(num_units=64, hough_num_samples=128, max_objects=2, hough_cell_stride=1,
                   vote_threshold=-1.0)
TRAIN_FOCAL = (1066.778, 1067.487)


def differenced_median(run: Callable[[int], Sequence[float]], n1: int, n2: int) -> tuple:
    """The JAX benches' timing protocol: run(n1) and run(n2) once to warm
    up, then PAIRS differenced pairs (t(n2) − t(n1)) / (n2 − n1); the
    median of each of run's clocks (run returns a tuple of seconds)."""
    run(n1)
    run(n2)
    samples = []
    for _ in range(PAIRS):
        t1 = run(n1)
        t2 = run(n2)
        samples.append([(b - a) / (n2 - n1) for a, b in zip(t1, t2)])
    return tuple(sorted(col)[len(col) // 2] for col in zip(*samples))


def timed(fn: Callable[[], object], device) -> tuple:
    """(device s, host s) of fn(): CUDA events around it and a
    synchronise, and the host clock to the end of that synchronise."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3, time.perf_counter() - t0


def graph_seconds(fn, args, n1: int, n2: int):
    """(device s, host s) a body of `fn`'s loop as a CUDA graph, and the
    vote kernels' launches per body."""
    device = args[0].device
    replays = {}
    for n in (n1, n2):
        replays[n], _, launches = capture_loop(fn, args, n)
    dev_s, host_s = differenced_median(lambda n: timed(replays[n], device), n1, n2)
    return dev_s, host_s, launches


def eager_seconds(fn, args, n1: int, n2: int):
    """(device s, host s) a body of `fn`'s loop called eagerly."""
    device = args[0].device
    return differenced_median(lambda n: timed(lambda: eager_loop(fn, args, n), device), n1, n2)


def card_line() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           check=True, capture_output=True, text=True).stdout
    return {"device": torch.cuda.get_device_name(0), "power_limit": limit.splitlines()[0].strip()}


def bench_infer(device) -> list:
    """`bench.py`: the eager loop's line, then the graph's metric line."""
    inp = make_inputs(1, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    args = (inp["data"], inp["extents"], inp["meta"])
    fn = forward_fn(flagship_model(1, device=device))
    card = card_line()

    def line(metric, timing, dev_s, host_s, **extra):
        fps = 1.0 / max(dev_s, 1e-9)
        return {"metric": metric, "value": fps,
                "unit": "frames/sec", "timing": timing, "ms": dev_s * 1e3,
                "host_ms": host_s * 1e3, **extra, **card, "vs_baseline": fps / BASELINE_FPS,
                "baseline_note": BASELINE_NOTE}

    eager = line(INFER_METRIC + "_eager", "eager", *eager_seconds(fn, args, *INFER_N))
    dev_s, host_s, launches = graph_seconds(fn, args, *INFER_N)
    return [eager, line(INFER_METRIC, "cuda_graph", dev_s, host_s, launches_per_forward=launches)]


def bench_phases(device) -> list:
    """`bench_graph_phases.py:86-118`: A / B / C at batch 1 and C at
    batch 4, each from a CUDA graph."""
    card = card_line()
    inp = make_inputs(1, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    args = (inp["data"], inp["extents"], inp["meta"])
    lines, results = [], {}
    for name, switches in PHASES:
        fn = forward_fn(flagship_model(1, device=device, **switches))
        dev_s, host_s, launches = graph_seconds(fn, args, *PHASES_N)
        results[name] = dev_s * 1e3
        lines.append({"phase": name, "ms": dev_s * 1e3, "host_ms": host_s * 1e3,
                      "launches_per_forward": launches, **card})
    inp4 = make_inputs(4, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    fn = forward_fn(flagship_model(1, device=device))
    dev_s, host_s, launches = graph_seconds(fn, (inp4["data"], inp4["extents"], inp4["meta"]),
                                            *BATCH4_N)
    results["full_batch4_ms_per_image"] = dev_s * 1e3 / 4
    results["full_batch4_fps"] = 4 / dev_s
    lines.append({"phase": "full_batch4", "ms_per_image": dev_s * 1e3 / 4, "fps": 4 / dev_s,
                  "host_ms_per_image": host_s * 1e3 / 4, "launches_per_forward": launches,
                  **card})
    lines.append({"metric": "posecnn_torch_graph_phases_480x640_22cls_h100", "unit": "ms",
                  "timing": "cuda_graph", **results, **card})
    return lines


def train_setup(device, dense: bool, *, num_classes: int = NUM_CLASSES, height: int = HEIGHT,
                width: int = WIDTH, fc_dim: int = 4096,
                compute_dtype: torch.dtype = torch.bfloat16, **model_kw):
    """`bench_train.py`'s step on its fixed batch: (step, state, batch).
    The sizes default to the bench's; the tests shrink them."""
    c, b = num_classes, TRAIN_BATCH
    cfg = cfg_from_dict({"train": {"num_classes": c, "vertex_reg_2d": True, "pose_reg": True,
                                   "ims_per_batch": b, "hough_num_samples": 128, "max_rois": 36,
                                   "add_num_points": TRAIN_POINTS}})
    rng = np.random.RandomState(0)
    points = (rng.rand(c, TRAIN_POINTS, 3).astype(np.float32) - 0.5) * 0.12
    points[0] = 0
    extents = np.abs(points).max(1) * 2
    symmetry = np.zeros(c, np.float32)
    k = np.array([[TRAIN_FOCAL[0], 0, width / 2], [0, TRAIN_FOCAL[1], height / 2], [0, 0, 1]],
                 np.float32)
    gen = SyntheticSceneGenerator(points, extents, k, width=width, height=height)
    batch = to_device(gen.minibatch(b, dense_vertex_targets=dense), device)
    model = PoseCNN(c, fc_dim=fc_dim, compute_dtype=compute_dtype, **{**TRAIN_MODEL, **model_kw})
    init_weights(model, 0)
    model = model.to(device)
    step = make_train_step(cfg, model, *(torch.from_numpy(a).to(device)
                                         for a in (points, extents, symmetry)))
    return step, create_train_state(cfg, model), batch


def train_steps(step, state, batch: dict, n: int) -> torch.Tensor:
    """n training steps on `batch`, step i+1 reading data + loss_i·1e-20
    (`bench_train.py:83-98`); returns the last loss without waiting."""
    loss = torch.zeros((), dtype=torch.float32, device=batch["data"].device)
    for _ in range(n):
        total, _ = step.forward(state, {**batch, "data": batch["data"] + loss * 1e-20})
        step.backward(total)
        step.update(state)
        loss = total.detach()
    return loss


def snapshot(step, state):
    """A restore() that puts the model's parameters and buffers, the
    optimizer's state and count, and the global step (which seeds the
    dropout streams) back to what they are now."""
    params = copy.deepcopy(step.model.state_dict())
    opt = copy.deepcopy(state.opt.opt.state_dict())
    count, at = state.opt.count, state.step

    def restore():
        step.model.load_state_dict(params)
        # load_state_dict keeps the tensors it is given: hand it copies
        state.opt.opt.load_state_dict(copy.deepcopy(opt))
        state.opt.count, state.step = count, at

    return restore


def step_busy_ms(step, state, batch: dict) -> tuple:
    """(device-busy ms, wall ms) of one training step under torch.profiler:
    the device-side events' self times, and the host clock to a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = batch["data"].device
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_steps(step, state, batch, 1)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3
    return busy, wall * 1e3


def bench_train(device) -> list:
    """`bench_train.py`: seconds a step with the sparse and the dense feed."""
    card = card_line()
    lines, per_feed = [], {}
    for feed in ("sparse", "dense"):
        step, state, batch = train_setup(device, dense=feed == "dense")
        train_steps(step, state, batch, 1)  # cuDNN's plans, the kernels' library
        restore = snapshot(step, state)

        def run(n):
            restore()
            return timed(lambda: train_steps(step, state, batch, n), device)

        dev_s, host_s = differenced_median(run, *TRAIN_N)
        restore()
        busy_ms, wall_ms = step_busy_ms(step, state, batch)
        per_feed[feed] = dev_s
        lines.append({"feed": feed, "s_per_iter": dev_s, "host_s_per_iter": host_s,
                      "profiled_step_device_busy_ms": busy_ms, "profiled_step_wall_ms": wall_ms,
                      "busy_share": busy_ms / wall_ms, **card})
        del step, state, batch
    lines.append({"metric": "posecnn_torch_train_s_per_iter_480x640_b2_h100",
                  "value": per_feed["sparse"], "unit": "s/iter", "timing": "eager",
                  "note": "step time (fwd+bwd+update) on CUDA events, fc4096, sparse vertex "
                          "feed", "sparse_feed_s": per_feed["sparse"],
                  "dense_feed_s": per_feed["dense"], **card})
    return lines


COMMANDS = {"infer": bench_infer, "phases": bench_phases, "train": bench_train}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="time the port's flagship forward and training "
                                "step on one CUDA card, as the JAX repository's benches do")
    p.add_argument("command", nargs="?", default="infer", choices=tuple(COMMANDS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("posecnn_torch.bench: no CUDA device; the bench times the card and has no CPU "
              "mode", file=sys.stderr)
        return 2
    for line in COMMANDS[args.command](setup_device("cuda")):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
