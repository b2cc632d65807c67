"""The repository's measurement entry points, on one NVIDIA GPU.

    python -m posecnn_torch.bench [infer|phases|train|c2f|components|hough|
                                   train_components|train_mfu|profile]

Counterpart of the JAX repository's `bench.py` (`infer`, the default),
`experiments/bench_graph_phases.py` (`phases`, `c2f`),
`experiments/bench_train.py` (`train`), `experiments/bench_components.py`
(`components`), `experiments/bench_hough_phases.py` (`hough`),
`experiments/bench_train_components.py` (`train_components`),
`experiments/bench_train_mfu.py` (`train_mfu`) and
`experiments/profile_train.py` (`profile`). Each keeps its script's
configuration, seeds and loop counts n1 / n2, and the protocol of
`bench_graph_phases.py`'s `timed`: warm both counts, then the median of 3
differenced pairs (t(n2) − t(n1)) / (n2 − n1), which removes the loop's
fixed cost. `bench_components.py` and `bench_hough_phases.py` take one
differenced pair; here they take the median of 3 as well. Time is CUDA
events around the run and a synchronise; the host clock is printed beside
it. Every line is one JSON object and names the card and its power limit;
the metric names carry `torch` and `h100`, so they never mix with the
TPU's.

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
          sparse vertex feed (the headline) and the dense one. n steps on
          that batch, step i+1 reading data + loss_i·1e-20, no host read
          between steps, n1 = 3, n2 = 23: eagerly (`TrainStep.forward /
          backward / update`), and as the compiled step (`engine/train.
          CompiledTrainStep`, one CUDA graph replayed a step, the chain
          inside its body), as `bench_train.py:80` times a jitted step. As
          JAX's functional `run` starts every call from the same state,
          every timed run starts from the model, optimizer and step of the
          end of the warm-up, restored in place outside the events (a graph
          reads them at their addresses). Each feed's line gives both and
          torch.profiler's device-busy ms of one step of each; the last two
          lines are the eager step's metric (`…_h100_eager`) and the
          compiled step's, `posecnn_torch_train_s_per_iter_480x640_b2_h100`
          with `"timing": "cuda_graph"`, as `infer` prints its own.
  c2f     `bench_graph_phases.py:120-170`: the samples of a planted label
          (classes 3 / 9 / 15 in three squares) and a vertex map of
          RandomState(0) (randn·0.3) through `_prepare_slots` (label
          threshold 500, skip 10, 128 samples, 8 slots), then
          `hough_votes_c2f` at (coarse factor, top_t) (4, 4), (8, 4),
          (4, 2), (8, 2), each body reading packed + acc·1e-20, as CUDA
          graphs at n 5 / 45. The script's file, phases A / B / C and
          batch 4 (the `phases` lines, printed first) with the tunings, is
          written to `output/bench_graph_phases_torch.json`.
  components  `bench_components.py`: the VGG16 trunk alone; the models
          seg_only, seg_vertex_hough and full; Hough alone on a label of
          RandomState(0) in all 22 classes with randn·0.3 vertices; RoI
          pool and pose head alone on random conv4 / conv5 maps, 8 RoIs
          and pose weights on the first 4 columns. CUDA graphs at n 5 /
          25, one line each, then `summary_ms`.
  hough   `bench_hough_phases.py`: `_prepare_slots` alone and the
          exhaustive vote (`tile_vote_kernel`, stride 1, 480×640) on the
          `c2f` samples, then the full forward at batch 1 and 4 (ms a
          batch, ms an image, frames/s). CUDA graphs at n 5 / 25.
  train_components  `bench_train_components.py`: `train`'s step in nine
          variants (full; rows_126 at 7 objects; rows_126_compact64 with
          64 pose rows; no_pose; seg_only, its batch cut to the keys the
          seg loss reads; add_p128; fc1024; res_240x320 at half the focal
          length; batch1), each on a fresh batch of RandomState(0), then
          the six differences the script derives. Eager and compiled, n 3 /
          23, every timed run from one restored state, as `train`; each
          variant's device-busy ms of one profiled eager step and their six
          differences beside them (the eager step waits on its host), and
          the compiled step's ms and differences.
  train_mfu  `bench_train_mfu.py`: the step at (batch, scale) (8, 0.5),
          (8, 1.0), (16, 1.0) (adam, grad clip 35, GT RoIs prepended,
          max_rois 16·b, 8·b GT rows, 1 object an image, focal × scale),
          eager and compiled at n 3 / 13. FLOPs of one step from
          `torch.utils.flop_counter.FlopCounterMode` (the vote kernels add
          none), MFU over the H100's 989 TFLOP/s of dense bf16. The
          script's `device_s_per_iter` times a compiled loop with no host
          work in it; the eager step here waits on its host, so its time
          is `s_per_iter_eager` (and `samples_per_s`, `mfu_pct` follow
          it), and the device's own time is `step_busy_ms`, the
          device-busy ms of one profiled step, with `mfu_pct_busy` from
          it; the compiled step, which waits on no host work, is the
          script's loop: `s_per_iter_compiled` and `mfu_pct_compiled`. The
          JAX row's `compile_s` is the warm-up step's seconds here. Written
          to `output/bench_train_mfu_torch.json`.
  profile `profile_train.py`: `train`'s step (sparse feed), warmed outside
          the trace; its FLOPs and 20 steps each ended by a host read (the
          `train_step_mfu` line); 5 such steps under torch.profiler (CPU
          and CUDA), the chrome trace written under `POSECNN_TRACE_DIR`
          (default `posecnn_torch_trace` in the temporary directory), and
          the 40 device kernels of most self time as the script's per-plane
          table, the plane named after the card; then the same for the
          compiled step (its s a step and MFU at a host read a step, the
          device kernels of 5 replayed steps). Written to
          `output/train_profile_torch.json`.

Without a CUDA device the command exits non-zero: it measures the card
and has no CPU mode.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from posecnn_torch.cli.common import setup_device
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.data.pipeline import to_device
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import CompiledTrainStep, create_train_state, make_train_step
from posecnn_torch.entry import (
    HEIGHT,
    NUM_CLASSES,
    WIDTH,
    flagship_model,
    forward_fn,
    make_inputs,
)
from posecnn_torch.models.posecnn import PoseCNN, PoseHead, init_weights
from posecnn_torch.models.vgg16 import VGG16Trunk
from posecnn_torch.ops.hough_kernels import hough_votes_c2f, hough_votes_exhaustive
from posecnn_torch.ops.hough_voting import _prepare_slots, hough_voting
from posecnn_torch.ops.roi_align import roi_pool_fused
from posecnn_torch.utils.graph import capture_loop, checksum, eager_loop

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

C2F_N = (5, 45)  # bench_graph_phases.py:29, `timed`'s defaults
COMPONENTS_N = HOUGH_N = (5, 25)  # bench_components.py:20, bench_hough_phases.py:20
TRAIN_COMPONENTS_N = (3, 23)  # bench_train_components.py:133
MFU_N = (3, 13)  # bench_train_mfu.py:135
PROFILE_HOST_SYNC_STEPS, PROFILE_TRACED_STEPS, PROFILE_TOP = 20, 5, 40  # profile_train.py
PEAK_BF16_TFLOPS = 989.0  # one H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
# bench_graph_phases.py:122-137 (= bench_hough_phases.py:42-72): three
# compact objects (class, centre x, centre y, half side) and the prep
PLANTED_LABEL = ((3, 200, 240, 60), (9, 450, 300, 45), (15, 320, 120, 50))
PREP_KW = dict(label_threshold=500, skip_pixels=10, num_samples=128, max_classes=8)
C2F_TUNINGS = (("c2f_default_f4_t4", dict(coarse_factor=4, top_t=4)),
               ("c2f_f8_t4", dict(coarse_factor=8, top_t=4)),
               ("c2f_f4_t2", dict(coarse_factor=4, top_t=2)),
               ("c2f_f8_t2", dict(coarse_factor=8, top_t=2)))
C2F_OUT = os.path.join("output", "bench_graph_phases_torch.json")
# bench_components.py:65-69
COMPONENT_MODELS = (("seg_only", dict(vertex_reg=False, pose_reg=False)),
                    ("seg_vertex_hough", dict(vertex_reg=True, pose_reg=False)),
                    ("full", dict(vertex_reg=True, pose_reg=True)))
COMPONENT_ROIS = 8  # bench_components.py:113-120
# bench_train_components.py:147-161: each variant's changes to `train`'s step
TRAIN_VARIANTS = (
    ("full", {}),
    ("rows_126", dict(max_objects=7)),
    ("rows_126_compact64", dict(max_objects=7, max_pose_rois=64)),
    ("no_pose", dict(pose_reg=False)),
    ("seg_only", dict(vertex_reg=False, pose_reg=False)),
    ("add_p128", dict(n_points=128)),
    ("fc1024", dict(fc_dim=1024)),
    ("res_240x320", dict(height=240, width=320, focal_scale=0.5)),
    ("batch1", dict(batch=1)),
)
# bench_train_components.py:101-105: the batch keys the seg-only step keeps
SEG_ONLY_KEYS = ("data", "label", "meta", "gt_poses", "gt_valid")
MFU_POINTS = ((8, 0.5), (8, 1.0), (16, 1.0))  # bench_train_mfu.py:57
MFU_OUT = os.path.join("output", "bench_train_mfu_torch.json")
PROFILE_OUT = os.path.join("output", "train_profile_torch.json")


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


def graph_seconds(fn, args, n1: int, n2: int, reduce=checksum):
    """(device s, host s) a body of `fn`'s loop as a CUDA graph, and the
    vote kernels' launches per body; `reduce` as `capture_loop`'s."""
    device = args[0].device
    replays = {}
    for n in (n1, n2):
        replays[n], _, launches = capture_loop(fn, args, n, reduce)
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


def train_setup(device, dense: bool = False, *, num_classes: int = NUM_CLASSES,
                height: int = HEIGHT, width: int = WIDTH, batch: int = TRAIN_BATCH,
                fc_dim: int = 4096, n_points: int = TRAIN_POINTS, focal_scale: float = 1.0,
                max_gt: int = 16, train: Optional[dict] = None,
                compute_dtype: torch.dtype = torch.bfloat16, **model_kw):
    """`bench_train.py`'s step on its fixed batch: (step, state, batch).

    The keywords are what the other train benches change: the frame size
    and focal length (× `focal_scale`), the batch and its GT rows, fc6/fc7's
    width, the ADD points the loss reads (`n_points` of the class's 512),
    `train` the cfg's train keys to add or replace, and `model_kw` PoseCNN's
    keywords over `TRAIN_MODEL` (the head switches also set the cfg's).
    The batch is rendered by a fresh generator, whose rng is
    RandomState(0) as each script resets it. The sizes default to the
    bench's; the tests shrink them."""
    c = num_classes
    vertex_reg, pose_reg = model_kw.get("vertex_reg", True), model_kw.get("pose_reg", True)
    cfg = cfg_from_dict({"train": {"num_classes": c, "vertex_reg_2d": vertex_reg,
                                   "pose_reg": pose_reg, "ims_per_batch": batch,
                                   "hough_num_samples": 128, "max_rois": 36,
                                   "add_num_points": n_points, "fc_dim": fc_dim,
                                   **(train or {})}})
    rng = np.random.RandomState(0)
    points = (rng.rand(c, TRAIN_POINTS, 3).astype(np.float32) - 0.5) * 0.12
    points[0] = 0
    extents = np.abs(points).max(1) * 2
    symmetry = np.zeros(c, np.float32)
    fx, fy = TRAIN_FOCAL[0] * focal_scale, TRAIN_FOCAL[1] * focal_scale
    k = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(points, extents, k, width=width, height=height)
    feed = gen.minibatch(batch, max_gt=max_gt, dense_vertex_targets=dense)
    if not vertex_reg:
        feed = {key: feed[key] for key in SEG_ONLY_KEYS}
    model = PoseCNN(c, fc_dim=fc_dim, compute_dtype=compute_dtype, **{**TRAIN_MODEL, **model_kw})
    init_weights(model, 0)
    model = model.to(device)
    step = make_train_step(cfg, model, *(torch.from_numpy(a).to(device)
                                         for a in (points[:, :n_points], extents, symmetry)))
    return step, create_train_state(cfg, model), to_device(feed, device)


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


def compiled_twin(step) -> CompiledTrainStep:
    """`step`'s model, class points and keep rate as a compiled step whose
    body reads data + loss·1e-20 of the step before it (`feedback`):
    `train_steps`' chain inside the graph."""
    return CompiledTrainStep(step.cfg, step.model, step.points, step.extents, step.symmetry,
                             keep_prob=step.keep_prob, feedback=True)


def compiled_steps(step, state, batch: dict, n: int) -> torch.Tensor:
    """n calls of a `compiled_twin` on `batch`, the first reading data +
    0 (`train_steps` on the graph); returns the last loss without
    waiting. The first call of a signature runs eagerly and captures."""
    step.carry.zero_()
    for _ in range(n):
        step(state, batch)
    return step.carry


def snapshot(step, state):
    """A restore() that puts the model's parameters and buffers, the
    optimizer's state tensors and count, and the global step (which seeds
    the dropout streams) back to what they are now, in place: each tensor
    keeps its address, which a compiled step's graph reads (an optimizer's
    `load_state_dict` would put new tensors in its state)."""
    tensors = [*step.model.state_dict(keep_vars=True).values(), *state.opt.state_tensors()]
    saved = [t.detach().clone() for t in tensors]
    count, at = state.opt.count, state.step

    def restore():
        with torch.no_grad():
            for t, value in zip(tensors, saved):
                t.copy_(value)
        state.opt.count, state.step = count, at

    return restore


def train_seconds(step, state, batch: dict, n1: int, n2: int, steps=None) -> tuple:
    """(device s, host s) a step of `steps` (`train_steps`, or
    `compiled_steps` with a `compiled_twin`), each timed run starting from
    the state as it is now (`snapshot`), as JAX's functional loop starts
    every call from one state; the state is left restored to it. Warm up
    first (the compiled step warms in `differenced_median`'s first runs)."""
    steps = steps or train_steps
    restore = snapshot(step, state)
    device = batch["data"].device

    def run(n):
        restore()
        return timed(lambda: steps(step, state, batch, n), device)

    seconds = differenced_median(run, n1, n2)
    restore()
    return seconds


def step_flops(step, state, batch: dict) -> float:
    """FLOPs of one training step, as `FlopCounterMode` counts the
    forward's and backward's products and convolutions (the vote kernels
    add none). The step moves the state: count after timing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        train_steps(step, state, batch, 1)
    return float(counter.get_total_flops())


def device_kernel_ms(prof) -> dict:
    """Each device kernel's self time in a torch.profiler run, ms, by name.
    The device rows of user annotations (`Optimizer.step#SGD.step` spans
    the optimizer's kernels) are left out: their kernels count already."""
    from torch.autograd import DeviceType

    return {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation}


def step_busy_ms(step, state, batch: dict, steps=None) -> tuple:
    """(device-busy ms, wall ms) of one training step of `steps`
    (`train_steps` or `compiled_steps`) under torch.profiler: the
    device-side events' self times, and the host clock to a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    steps = steps or train_steps
    device = batch["data"].device
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(step, state, batch, 1)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return sum(device_kernel_ms(prof).values()), wall * 1e3


def compiled_launches(step) -> Optional[dict]:
    """The vote kernels' launches in one replay of a compiled step's graph
    (None on the CPU, where the step runs eagerly and captures none)."""
    programs = list(step.compiled.programs.values())
    if len(programs) > 1:
        raise AssertionError(f"a bench step took {len(programs)} graphs, not one")
    return programs[0].launches if programs else None


def bench_train(device) -> list:
    """`bench_train.py`: seconds a step with the sparse and the dense feed,
    eager and compiled."""
    card = card_line()
    lines, eager, compiled = [], {}, {}
    for feed in ("sparse", "dense"):
        step, state, batch = train_setup(device, dense=feed == "dense")
        train_steps(step, state, batch, 1)  # cuDNN's plans, the kernels' library
        dev_s, host_s = train_seconds(step, state, batch, *TRAIN_N)
        busy_ms, wall_ms = step_busy_ms(step, state, batch)
        twin = compiled_twin(step)
        c_dev_s, c_host_s = train_seconds(twin, state, batch, *TRAIN_N, compiled_steps)
        c_busy_ms, c_wall_ms = step_busy_ms(twin, state, batch, compiled_steps)
        eager[feed], compiled[feed] = dev_s, c_dev_s
        lines.append({"feed": feed, "s_per_iter": dev_s, "host_s_per_iter": host_s,
                      "profiled_step_device_busy_ms": busy_ms, "profiled_step_wall_ms": wall_ms,
                      "busy_share": busy_ms / wall_ms, "compiled_s_per_iter": c_dev_s,
                      "compiled_host_s_per_iter": c_host_s,
                      "compiled_profiled_step_device_busy_ms": c_busy_ms,
                      "compiled_profiled_step_wall_ms": c_wall_ms,
                      "compiled_busy_share": c_busy_ms / c_wall_ms,
                      "launches_per_step": compiled_launches(twin), **card})
        del step, state, batch, twin
    note = "step time (fwd+bwd+update) on CUDA events, fc4096, sparse vertex feed"
    for timing, per_feed, suffix in (("eager", eager, "_eager"), ("cuda_graph", compiled, "")):
        lines.append({"metric": f"posecnn_torch_train_s_per_iter_480x640_b2_h100{suffix}",
                      "value": per_feed["sparse"], "unit": "s/iter", "timing": timing,
                      "note": note, "sparse_feed_s": per_feed["sparse"],
                      "dense_feed_s": per_feed["dense"], **card})
    return lines


def scaled_sum(scale: float):
    """A bench body's fp32 scalar: the sum of its one output × scale, as
    the JAX scripts' loop bodies return it."""
    return lambda out: (out.sum(dtype=torch.float32) * scale).float()


def planted_slots(device) -> tuple:
    """The c2f and Hough-phase benches' inputs (`bench_graph_phases.py:
    122-137`): the planted label (1, H, W), the vertex map of
    RandomState(0) (1, H, W, 3C), the seeded inputs' extents and meta, and
    `_prepare_slots`' packed samples (8, 8, 128) and boxes (8, 4)."""
    inp = make_inputs(1, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    rng = np.random.RandomState(0)
    label = np.zeros((HEIGHT, WIDTH), np.int64)
    ys, xs = np.mgrid[0:HEIGHT, 0:WIDTH]
    for cls, cx, cy, r in PLANTED_LABEL:
        label[(np.abs(xs - cx) < r) & (np.abs(ys - cy) < r)] = cls
    label = torch.from_numpy(label[None]).to(device)
    vert = torch.from_numpy(
        rng.randn(1, HEIGHT, WIDTH, 3 * NUM_CLASSES).astype(np.float32) * 0.3).to(device)
    prep = _prepare_slots(label[0], vert[0], inp["extents"], inp["meta"][0],
                          num_classes=NUM_CLASSES, **PREP_KW)
    return label, vert, inp["extents"], inp["meta"], prep["packed"], prep["bboxes"]


def c2f_body(samples, bboxes, *, coarse_factor: int, top_t: int):
    """One body of the c2f sweep: the single-instance c2f maximum at a
    tuning, stride 1 over 480×640; reduce with `c2f_sum`."""
    return hough_votes_c2f(samples, bboxes, cell_stride=1, grid_h=HEIGHT, grid_w=WIDTH,
                           coarse_factor=coarse_factor, top_t=top_t)


def c2f_sum(out) -> torch.Tensor:
    """sum(votes)·1e-6 + sum(cy)·1e-9 (`bench_graph_phases.py:150`)."""
    votes, _, cy, _ = out
    return (votes.sum() * 1e-6 + cy.sum() * 1e-9).float()


def bench_c2f(device) -> list:
    """`bench_graph_phases.py`'s file: the `phases` lines, then the c2f
    tunings from CUDA graphs; writes C2F_OUT."""
    card = card_line()
    lines = bench_phases(device)
    results = {k: v for k, v in lines[-1].items() if k not in ("metric", "unit", "timing")
               and k not in card}
    *_, packed, bboxes = planted_slots(device)
    for name, tuning in C2F_TUNINGS:
        dev_s, host_s, launches = graph_seconds(partial(c2f_body, **tuning), (packed, bboxes),
                                                *C2F_N, reduce=c2f_sum)
        results[name] = dev_s * 1e3
        lines.append({"phase": name, **tuning, "ms": dev_s * 1e3, "host_ms": host_s * 1e3,
                      "launches_per_body": launches, **card})
    os.makedirs(os.path.dirname(C2F_OUT), exist_ok=True)
    with open(C2F_OUT, "w") as f:
        json.dump(results, f, indent=2)
    lines.append({"metric": "posecnn_torch_c2f_tunings_480x640_h100", "unit": "ms",
                  "timing": "cuda_graph",
                  **{name: results[name] for name, _ in C2F_TUNINGS}, "wrote": C2F_OUT, **card})
    return lines


def bench_components(device) -> list:
    """`bench_components.py`: each component alone, from a CUDA graph."""
    card = card_line()
    inp = make_inputs(1, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    data, extents, meta = inp["data"], inp["extents"], inp["meta"]
    lines, results = [], {}

    def report(name, fn, args, reduce=checksum):
        dev_s, host_s, launches = graph_seconds(fn, args, *COMPONENTS_N, reduce=reduce)
        results[name] = dev_s * 1e3
        lines.append({"component": name, "ms": dev_s * 1e3, "host_ms": host_s * 1e3,
                      "launches_per_body": launches, **card})

    trunk = VGG16Trunk(compute_dtype=torch.bfloat16)
    init_weights(trunk, 0)
    trunk = trunk.to(device).eval()

    @torch.inference_mode()
    def conv5_3(x):
        return trunk(x)[1]

    report("trunk", conv5_3, (data,), reduce=scaled_sum(1e-9))
    del trunk
    for name, switches in COMPONENT_MODELS:
        report(name, forward_fn(flagship_model(1, device=device, **switches)),
               (data, extents, meta))

    # Hough alone on a label in all classes (bench_components.py:92-108)
    rng = np.random.RandomState(0)
    label = torch.from_numpy(rng.randint(0, NUM_CLASSES, (1, HEIGHT, WIDTH))).to(device)
    vert = torch.from_numpy(
        rng.randn(1, HEIGHT, WIDTH, 3 * NUM_CLASSES).astype(np.float32) * 0.3).to(device)

    def hough_rois(v, lab, ext, m):
        return hough_voting(lab, v, ext, m, vote_threshold=-1.0, num_samples=128,
                            max_objects_per_image=8, cell_stride=1).rois

    report("hough_alone", hough_rois, (vert, label, extents, meta), reduce=scaled_sum(1e-6))
    del label, vert

    # RoI pool and pose head alone (bench_components.py:110-134)
    c4 = torch.from_numpy(rng.randn(1, HEIGHT // 8, WIDTH // 8, 512).astype(np.float32))
    c5 = torch.from_numpy(rng.randn(1, HEIGHT // 16, WIDTH // 16, 512).astype(np.float32))
    n = COMPONENT_ROIS
    rois = np.stack([np.zeros(n), np.arange(1, n + 1), rng.uniform(0, WIDTH / 2, n),
                     rng.uniform(0, HEIGHT / 2, n), rng.uniform(WIDTH / 2, WIDTH, n),
                     rng.uniform(HEIGHT / 2, HEIGHT, n), np.ones(n)], axis=1).astype(np.float32)
    head = PoseHead(NUM_CLASSES, 7 * 7 * 512, compute_dtype=torch.bfloat16)
    init_weights(head, 0)
    head = head.to(device).eval()
    pose_weight = torch.zeros((n, 4 * NUM_CLASSES), device=device)
    pose_weight[:, :4] = 1.0

    @torch.inference_mode()
    def pose_head(conv4, conv5, boxes, pw):
        return head(roi_pool_fused(conv4, conv5, boxes), pw)[0]

    report("roi_posehead_alone", pose_head,
           (c4.to(device), c5.to(device), torch.from_numpy(rois).to(device), pose_weight),
           reduce=scaled_sum(1e-6))
    lines.append({"metric": "posecnn_torch_components_480x640_22cls_h100", "unit": "ms",
                  "timing": "cuda_graph", "summary_ms": results, **card})
    return lines


def bench_hough(device) -> list:
    """`bench_hough_phases.py`: the prep and the exhaustive vote alone on
    the planted samples, then the full forward at batch 1 and 4."""
    card = card_line()
    label, vert, extents, meta, packed, bboxes = planted_slots(device)
    lines, results = [], {}

    def prep_packed(v, lab, ext, m):
        return _prepare_slots(lab[0], v[0], ext, m[0], num_classes=NUM_CLASSES,
                              **PREP_KW)["packed"]

    def exhaustive_votes(samples, boxes):
        return hough_votes_exhaustive(samples, boxes, cell_stride=1, grid_h=HEIGHT,
                                      grid_w=WIDTH)[0]

    for name, fn, args in (("prepare_slots", prep_packed, (vert, label, extents, meta)),
                           ("vote_kernel_realistic", exhaustive_votes, (packed, bboxes))):
        dev_s, host_s, launches = graph_seconds(fn, args, *HOUGH_N, reduce=scaled_sum(1e-6))
        results[name] = dev_s * 1e3
        lines.append({"phase": name, "ms": dev_s * 1e3, "host_ms": host_s * 1e3,
                      "launches_per_body": launches, **card})
    del label, vert
    for b in (1, 4):
        inp = make_inputs(b, HEIGHT, WIDTH, NUM_CLASSES, device=device)
        fn = forward_fn(flagship_model(1, device=device))
        dev_s, host_s, launches = graph_seconds(fn, (inp["data"], inp["extents"], inp["meta"]),
                                                *HOUGH_N)
        results[f"full_batch{b}_ms_per_image"] = dev_s * 1e3 / b
        lines.append({"phase": f"full_batch{b}", "ms_per_batch": dev_s * 1e3,
                      "ms_per_image": dev_s * 1e3 / b, "fps_per_image": b / dev_s,
                      "host_ms_per_batch": host_s * 1e3, "launches_per_forward": launches,
                      **card})
    lines.append({"metric": "posecnn_torch_hough_phases_480x640_22cls_h100", "unit": "ms",
                  "timing": "cuda_graph", **results, **card})
    return lines


def train_differences(ms: dict) -> dict:
    """The differences `bench_train_components.py:162-167` derives from
    the variants' ms a step."""
    return {"pose_branch_ms": ms["full"] - ms["no_pose"],
            "vertex_branch_ms": ms["no_pose"] - ms["seg_only"],
            "add_points_ms": ms["full"] - ms["add_p128"],
            "fc_width_ms": ms["full"] - ms["fc1024"],
            "fixed_cost_est_ms": (4 * ms["res_240x320"] - ms["full"]) / 3,
            "compaction_saves_ms": ms["rows_126"] - ms["rows_126_compact64"]}


def train_variant_seconds(device, **variant) -> tuple:
    """(device s, host s) a step of `train`'s step with `variant`'s
    changes (`train_setup`'s keywords), warmed once, n 3 / 23; the
    device-busy ms of one profiled step (`step_busy_ms`); then the
    compiled step's (device s, host s) and launches a replay."""
    step, state, batch = train_setup(device, **variant)
    train_steps(step, state, batch, 1)  # cuDNN's plans, the kernels' library
    dev_s, host_s = train_seconds(step, state, batch, *TRAIN_COMPONENTS_N)
    busy_ms = step_busy_ms(step, state, batch)[0]
    twin = compiled_twin(step)
    compiled = train_seconds(twin, state, batch, *TRAIN_COMPONENTS_N, compiled_steps)
    return dev_s, host_s, busy_ms, compiled, compiled_launches(twin)


def bench_train_components(device) -> list:
    """`bench_train_components.py`: the nine variants, then the derived
    differences. The eager step waits on its host work, which a variant
    may change less than its device work, so each variant's device-busy
    ms and their differences stand beside the script's; the compiled
    step's ms and differences, which wait on no host work, beside both."""
    card = card_line()
    lines, ms, busy, compiled = [], {}, {}, {}
    for name, variant in TRAIN_VARIANTS:
        dev_s, host_s, busy[name], (c_dev_s, c_host_s), launches = train_variant_seconds(
            device, **variant)
        ms[name], compiled[name] = dev_s * 1e3, c_dev_s * 1e3
        lines.append({"variant": name, **variant, "ms_per_iter": dev_s * 1e3,
                      "host_ms_per_iter": host_s * 1e3,
                      "profiled_step_device_busy_ms": busy[name],
                      "compiled_ms_per_iter": c_dev_s * 1e3,
                      "compiled_host_ms_per_iter": c_host_s * 1e3,
                      "launches_per_step": launches, **card})
        gc.collect()  # the variant's graph and its memory pool
        torch.cuda.empty_cache()
    lines.append({"metric": "posecnn_torch_train_components_480x640_b2_h100", "unit": "ms/iter",
                  "timing": "eager", **ms, **train_differences(ms), "device_busy_ms": busy,
                  "device_busy_differences": train_differences(busy),
                  "compiled_ms": compiled, "compiled_differences": train_differences(compiled),
                  **card})
    return lines


def mfu_setup(batch: int, scale: float) -> dict:
    """`train_setup`'s keywords at one point of `bench_train_mfu.py`
    (`:57-91`)."""
    return dict(batch=batch, height=int(HEIGHT * scale), width=int(WIDTH * scale),
                focal_scale=scale, max_gt=8 * batch,
                max_objects=max(1, 16 * batch // max(batch, 1) // 9), gt_pose_rois=True,
                train={"max_rois": 16 * batch, "gt_pose_rois": True, "optimizer": "adam",
                       "grad_clip": 35.0})


def bench_train_mfu(device) -> list:
    """`bench_train_mfu.py`: s a step eager and busy on the device, FLOPs
    and MFU of each at each point; writes MFU_OUT."""
    card = card_line()
    lines = []
    for b, scale in MFU_POINTS:
        torch.cuda.reset_peak_memory_stats(device)
        setup = mfu_setup(b, scale)
        step, state, batch = train_setup(device, **setup)
        t0 = time.perf_counter()
        train_steps(step, state, batch, 1)
        torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - t0
        dev_s, host_s = train_seconds(step, state, batch, *MFU_N)
        busy_ms = step_busy_ms(step, state, batch)[0]
        twin = compiled_twin(step)
        c_dev_s, c_host_s = train_seconds(twin, state, batch, *MFU_N, compiled_steps)
        flops = step_flops(step, state, batch)
        achieved, achieved_busy = flops / dev_s / 1e12, flops / busy_ms / 1e9
        achieved_compiled = flops / c_dev_s / 1e12
        lines.append({"batch": b, "scale": scale, "hw": [setup["height"], setup["width"]],
                      "s_per_iter_eager": dev_s, "host_s_per_iter": host_s,
                      "samples_per_s": b / dev_s, "step_flops": flops,
                      "achieved_tflops": achieved, "mfu_pct": 100 * achieved / PEAK_BF16_TFLOPS,
                      "step_busy_ms": busy_ms, "achieved_tflops_busy": achieved_busy,
                      "mfu_pct_busy": 100 * achieved_busy / PEAK_BF16_TFLOPS,
                      "s_per_iter_compiled": c_dev_s, "host_s_per_iter_compiled": c_host_s,
                      "samples_per_s_compiled": b / c_dev_s,
                      "achieved_tflops_compiled": achieved_compiled,
                      "mfu_pct_compiled": 100 * achieved_compiled / PEAK_BF16_TFLOPS,
                      "launches_per_step": compiled_launches(twin),
                      "peak_tflops": PEAK_BF16_TFLOPS, "warmup_s": warmup_s,
                      "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9, **card})
        del step, state, batch, twin
        gc.collect()  # the point's graph and its memory pool
        torch.cuda.empty_cache()
    out = {"metric": "posecnn_torch_train_mfu_sweep_h100", "points": lines, **card}
    os.makedirs(os.path.dirname(MFU_OUT), exist_ok=True)
    with open(MFU_OUT, "w") as f:
        json.dump(out, f, indent=2)
    return lines + [{**out, "points": len(lines), "wrote": MFU_OUT}]


def trace_dir() -> str:
    """Where `profile` writes its chrome trace."""
    return os.environ.get("POSECNN_TRACE_DIR",
                          os.path.join(tempfile.gettempdir(), "posecnn_torch_trace"))


def host_sync_seconds(steps, step, state, batch: dict) -> float:
    """Seconds a step of `steps` with a host read after each, as
    `profile_train.py` times its loop."""
    t0 = time.perf_counter()
    for _ in range(PROFILE_HOST_SYNC_STEPS):
        float(steps(step, state, batch, 1))
    return (time.perf_counter() - t0) / PROFILE_HOST_SYNC_STEPS


def traced_kernels(steps, step, state, batch: dict, trace: str) -> dict:
    """Each device kernel's ms over PROFILE_TRACED_STEPS steps of `steps`
    under torch.profiler, a host read a step as the script; the chrome
    trace written to `trace`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_TRACED_STEPS):
            float(steps(step, state, batch, 1))
    prof.export_chrome_trace(trace)
    return device_kernel_ms(prof)


def bench_profile(device) -> list:
    """`profile_train.py`: the step's MFU at a host read a step, then a
    torch.profiler trace of 5 steps and its top device kernels; the same
    for the compiled step beside them; writes PROFILE_OUT."""
    card = card_line()
    step, state, batch = train_setup(device)
    train_steps(step, state, batch, 1)  # warm, outside the trace
    twin = compiled_twin(step)
    compiled_steps(twin, state, batch, 2)  # its real step and capture, then a replay
    torch.cuda.synchronize(device)
    flops = step_flops(step, state, batch)
    dt = host_sync_seconds(train_steps, step, state, batch)
    c_dt = host_sync_seconds(compiled_steps, twin, state, batch)
    mfu_line = {"metric": "posecnn_torch_train_step_mfu_h100", "step_flops": flops,
                "s_per_iter_host_sync": dt, "achieved_tflops": flops / dt / 1e12,
                "peak_tflops_assumed": PEAK_BF16_TFLOPS,
                "mfu": flops / dt / (PEAK_BF16_TFLOPS * 1e12),
                "compiled_s_per_iter_host_sync": c_dt,
                "compiled_achieved_tflops": flops / c_dt / 1e12,
                "compiled_mfu": flops / c_dt / (PEAK_BF16_TFLOPS * 1e12), **card}

    path = trace_dir()
    os.makedirs(path, exist_ok=True)
    trace = os.path.join(path, "train_step.trace.json")
    kernels = traced_kernels(train_steps, step, state, batch, trace)
    c_trace = os.path.join(path, "compiled_train_step.trace.json")
    c_kernels = traced_kernels(compiled_steps, twin, state, batch, c_trace)
    plane = f"/device:GPU:0 ({card['device']})"
    per_plane = {plane: dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:PROFILE_TOP])}
    c_top = dict(sorted(c_kernels.items(), key=lambda kv: -kv[1])[:PROFILE_TOP])
    os.makedirs(os.path.dirname(PROFILE_OUT), exist_ok=True)
    with open(PROFILE_OUT, "w") as f:
        json.dump({"mfu": mfu_line, "per_plane": per_plane, "trace": trace,
                   "compiled": {"top_kernels_ms": c_top, "trace": c_trace}}, f, indent=1)
    return [mfu_line, {"plane": plane, "top_kernels_ms": per_plane[plane],
                       "compiled_top_kernels_ms": c_top, **card},
            {"metric": "posecnn_torch_train_profile_h100", "planes": list(per_plane),
             "steps": PROFILE_TRACED_STEPS, "device_kernel_ms": sum(kernels.values()),
             "kernels": len(kernels), "compiled_device_kernel_ms": sum(c_kernels.values()),
             "compiled_kernels": len(c_kernels), "launches_per_step": compiled_launches(twin),
             "trace": trace, "compiled_trace": c_trace, "wrote": PROFILE_OUT, **card}]


COMMANDS = {"infer": bench_infer, "phases": bench_phases, "train": bench_train, "c2f": bench_c2f,
            "components": bench_components, "hough": bench_hough,
            "train_components": bench_train_components, "train_mfu": bench_train_mfu,
            "profile": bench_profile}


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
