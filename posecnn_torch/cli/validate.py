"""Per-round validation of the port's Hough vote kernels on the card.

Counterpart of `experiments/validate_tpu.py`:

    python -m posecnn_torch.cli.validate              # on the card

1. builds the three vote kernels and runs Hough at 480×640 with 22
   classes on a scene rendered by the carried generator (seed 11, 3-5
   objects, GT-perfect dense vertex targets, 128 samples, 8 class slots,
   8 RoIs, stride-1 cells);
2. checks that the coarse-to-fine backend emits the exhaustive kernel's
   RoIs and initial poses (valid exactly, values within 1e-5) and
   reports whether the dense reduction agrees;
3. multi-instance mode: two same-class instances (vote_threshold 5,
   vote_percentage 1e-4) must be found by every backend within 6 px,
   with peak votes within 5% across backends; each backend's Hough time
   by CUDA events;
4. the serving forward at the default config, finite;
3b. one train step at the config of `experiments/cfgs/lov_color_2d.yaml`
   (batch 2, pooled feed off, symmetry off): the loss is finite;
4a. the ADD-loss probe: plain SGD on one RoI's fc8 logits, through the
   loss the train step uses, recovers a target rotation to under 15°;
4a2. the probe loss's gradient on the card against the same gradient on
   the CPU: within 5% of its largest entry (the JAX original compared
   eager against jit on the TPU, where a compiler bug once lived);
5. the renderer's rotation signal: a 45° turn of an object changes its
   pixels well above the change of a sub-pixel shift.

Prints one JSON line and writes it to `--out`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from posecnn_torch.cli.common import base_parser, setup_device
from posecnn_torch.core.config import cfg_from_file
from posecnn_torch.data.pipeline import to_device
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import (
    create_train_state,
    loss_point_scale,
    make_train_step,
)
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.ops import _cuda
from posecnn_torch.ops.add_loss import average_distance_loss
from posecnn_torch.ops.hough_voting import BACKENDS, hough_voting
from posecnn_torch.utils.quaternion import quat_to_mat, quat_to_mat_np

NUM_CLASSES = 22
HOUGH_KW = dict(num_samples=128, max_classes=8, max_objects_per_image=8, cell_stride=1)
MULTI_KW = dict(HOUGH_KW, vote_threshold=5.0, vote_percentage=1e-4)
MULTI_CLASS = 5
PROBE_CLASS = 3
TRAIN_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "experiments",
                         "cfgs", "lov_color_2d.yaml")


def scene(height, width, num_classes=NUM_CLASSES):
    """The generator, the class extents and one rendered frame."""
    proc = synthetic_class_library(num_classes, 2620)
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        proc.points, proc.extents, k, width=width, height=height, seed=11, min_objects=3,
        max_objects=5, point_colors=proc.colors, point_normals=proc.normals,
    )
    return gen, proc.extents, gen.minibatch(1, dense_vertex_targets=True)


def two_instances(height, width, num_classes=NUM_CLASSES):
    """Two class-5 squares with perfect directions at depth 1 m, centred
    at (w/4, h/2) and (3w/4, h/2); half side h/8 (60 px at 480×640)."""
    label = np.zeros((1, height, width), np.int64)
    vert = np.zeros((1, height, width, 3 * num_classes), np.float32)
    ys, xs = np.mgrid[0:height, 0:width]
    centres = ((width / 4, height / 2), (3 * width / 4, height / 2))
    half = height / 8
    for cx, cy in centres:
        mask = (np.abs(xs - cx) <= half) & (np.abs(ys - cy) <= half)
        dx, dy = cx - xs, cy - ys
        nrm = np.sqrt(dx * dx + dy * dy) + 1e-10
        label[0][mask] = MULTI_CLASS
        vert[0][mask, 3 * MULTI_CLASS] = (dx / nrm)[mask]
        vert[0][mask, 3 * MULTI_CLASS + 1] = (dy / nrm)[mask]
    return label, vert, centres


def require(ok, message):
    """A validation check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(message)


def device_ms(fn, device, n=10, warm=True):
    """Mean device milliseconds of `fn` over n runs, by CUDA events,
    after one warm-up run unless the caller has just run it."""
    if warm:
        fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def probe_loss(x, points, extents, num_classes=NUM_CLASSES):
    """The ADD loss of one RoI whose class-PROBE_CLASS fc8 logits are
    tanh(x), against the target quaternion of `probe_target`, through
    the pose head's mask and normalisation (experiments/validate_tpu.py
    part 4a)."""
    target, weight = probe_target(x.device, num_classes)
    row = torch.zeros((1, 4 * num_classes), device=x.device)
    row[0, 4 * PROBE_CLASS:4 * PROBE_CLASS + 4] = torch.tanh(x)
    masked = row * weight
    norm = torch.sqrt((masked * masked).sum(1, keepdim=True) + 1e-12)
    pts, sym = loss_point_scale(points, extents, torch.zeros(num_classes, device=x.device), True)
    return average_distance_loss(masked / norm, target, weight, pts, sym, margin=0.01,
                                 num_valid=torch.tensor(1.0, device=x.device))


def probe_target(device, num_classes=NUM_CLASSES):
    """(target, weight) rows of the probe: a random unit quaternion (seed
    7) in class PROBE_CLASS's columns."""
    q = np.random.RandomState(7).randn(4)
    q /= np.linalg.norm(q)
    target = np.zeros((1, 4 * num_classes), np.float32)
    weight = np.zeros((1, 4 * num_classes), np.float32)
    target[0, 4 * PROBE_CLASS:4 * PROBE_CLASS + 4] = q
    weight[0, 4 * PROBE_CLASS:4 * PROBE_CLASS + 4] = 1.0
    return torch.from_numpy(target).to(device), torch.from_numpy(weight).to(device)


def rotation_probe(device, points, extents, steps=400, lr=0.05):
    """Part 4a: the rotation error (degrees) after `steps` of plain SGD on
    the probe's logits from a small random start (seed 7's draws after
    the target)."""
    rng = np.random.RandomState(7)
    rng.randn(4)  # the target's draw
    x = torch.tensor(rng.randn(4) * 0.1, dtype=torch.float32, device=device, requires_grad=True)
    for _ in range(steps):
        (g,) = torch.autograd.grad(probe_loss(x, points, extents), x)
        with torch.no_grad():
            x -= lr * g
    with torch.no_grad():
        q = torch.tanh(x) / torch.linalg.vector_norm(torch.tanh(x))
        target, _ = probe_target(device)
        r_rel = quat_to_mat(q) @ quat_to_mat(target[0, 4 * PROBE_CLASS:4 * PROBE_CLASS + 4]).T
        cos = ((torch.trace(r_rel) - 1.0) / 2.0).clamp(-1.0, 1.0)
        return math.degrees(math.acos(float(cos)))


def probe_gradient(device, points, extents):
    """Part 4a2's gradient of the probe loss at a fixed point (seed 8)."""
    x = torch.tensor(np.random.RandomState(8).randn(4) * 0.3, dtype=torch.float32,
                     device=device, requires_grad=True)
    (g,) = torch.autograd.grad(probe_loss(x, points.to(device), extents.to(device)), x)
    return g.cpu()


def run_checks(device, height=480, width=640, cfg=None):
    """The parts above on `device`; `cfg` sizes the serving forward and
    the train step (default: `experiments/cfgs/lov_color_2d.yaml`; the
    train step turns its vertex and pose regression on, as the original
    does). A smaller height and width rehearse the checks on the CPU,
    where 4a2 has no second device and reads "not measured". Returns the
    result dict; raises AssertionError on a failed check."""
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "height": height, "width": width, "num_classes": NUM_CLASSES}
    t0 = time.perf_counter()
    if device.type == "cuda":
        _cuda.library("hough_vote")
        result["kernels_built_s"] = round(time.perf_counter() - t0, 3)
    gen, extents, batch = scene(height, width)
    ext = torch.from_numpy(extents).to(device)

    # ---- 1+2: c2f == exhaustive on the rendered scene ----
    label = torch.from_numpy(batch["label"].astype(np.int64)).to(device)
    vertex = torch.from_numpy(batch["vertex_targets"]).to(device)
    meta = torch.from_numpy(batch["meta"]).to(device)

    def run(backend, lab, vert, **kw):
        out = hough_voting(lab, vert, ext, meta, backend=backend, **kw)
        return tuple(t.cpu().numpy() for t in (out.rois, out.poses_init, out.valid))

    rois_ex, poses_ex, valid_ex = run("exhaustive", label, vertex, **HOUGH_KW)
    rois_c, poses_c, valid_c = run("c2f", label, vertex, **HOUGH_KW)
    n_det = int(valid_ex.sum())
    result["hough_detections"] = n_det
    require(n_det > 0, "no detections on the rendered scene")
    np.testing.assert_array_equal(valid_c, valid_ex, err_msg="c2f valid != exhaustive valid")
    np.testing.assert_allclose(rois_c[valid_ex], rois_ex[valid_ex], rtol=0, atol=1e-5,
                               err_msg="c2f rois != exhaustive rois")
    np.testing.assert_allclose(poses_c[valid_ex], poses_ex[valid_ex], rtol=0, atol=1e-5,
                               err_msg="c2f poses_init != exhaustive")
    result["c2f_equals_exhaustive"] = True
    rois_d, _, valid_d = run("dense", label, vertex, **HOUGH_KW)
    result["dense_agrees"] = bool(
        valid_d.sum() == n_det and np.allclose(rois_d[valid_d], rois_ex[valid_ex], atol=1e-4)
    )

    # ---- 3: multi-instance, two same-class instances ----
    lab_mi, vert_mi, centres = two_instances(height, width)
    lab_mi = torch.from_numpy(lab_mi).to(device)
    vert_mi = torch.from_numpy(vert_mi).to(device)
    peaks = {}
    for backend in BACKENDS:
        rois, _, valid = run(backend, lab_mi, vert_mi, **MULTI_KW)
        sel = rois[valid]
        sel = sel[sel[:, 1] == MULTI_CLASS]
        require(len(sel) > 0, f"{backend}: no valid class-{MULTI_CLASS} rois")
        cx, cy = (sel[:, 2] + sel[:, 4]) / 2, (sel[:, 3] + sel[:, 5]) / 2
        peaks[backend] = []
        for tx, ty in centres:
            d = np.hypot(cx - tx, cy - ty)
            require(d.min() <= 6.0, f"{backend}: instance at x={tx} missed ({d.min():.1f} px)")
            peaks[backend].append(float(sel[int(d.argmin()), 6]))
    for i in range(len(centres)):
        vs = [p[i] for p in peaks.values()]
        require(max(vs) - min(vs) <= 0.05 * max(vs), f"peak-{i} votes diverge >5%: {peaks}")
    result["multi_instance"] = True
    result["multi_instance_peak_votes"] = peaks
    result["multi_instance_hough_ms"] = {
        backend: round(device_ms(lambda b=backend: hough_voting(
            lab_mi, vert_mi, ext, meta, backend=b, **MULTI_KW), device), 4)
        if device.type == "cuda" else "not measured"
        for backend in BACKENDS
    }

    # ---- 4: the serving forward at the default config, finite ----
    cfg = cfg or cfg_from_file(TRAIN_CFG)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = PoseCNN(NUM_CLASSES, num_units=cfg.train.num_units, fc_dim=cfg.train.fc_dim,
                    hough_num_samples=cfg.test.hough_num_samples, compute_dtype=dtype)
    init_weights(model, cfg.rng_seed)
    out = model.to(device)(torch.from_numpy(batch["data"]).to(device), ext, meta)
    for name in ("log_prob", "poses_pred"):
        require(bool(torch.isfinite(getattr(out, name)).all()), f"serving forward: {name}")
    require(bool(torch.isfinite(out.hough.rois).all()), "serving forward: rois")
    result["serving_forward"] = "ok"
    del model, out

    # ---- 3b: one train step at the config's widths, batch 2 ----
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, vertex_reg_2d=True, pose_reg=True))
    t = tcfg.train
    model = PoseCNN(NUM_CLASSES, num_units=t.num_units, fc_dim=t.fc_dim,
                    hough_num_samples=t.hough_num_samples,
                    max_objects=max(1, t.max_rois // 2 // 9), compute_dtype=dtype)
    init_weights(model, 0)
    model = model.to(device)
    lib = synthetic_class_library(NUM_CLASSES, 2620)
    pidx = np.linspace(0, lib.points.shape[1] - 1, t.add_num_points).astype(int)
    points = torch.from_numpy(lib.points[:, pidx]).to(device)
    step = make_train_step(tcfg, model, points, ext, torch.zeros(NUM_CLASSES, device=device))
    tb = to_device(gen.minibatch(2, max_gt=16, dense_vertex_targets=False), device)
    metrics = step(create_train_state(tcfg, model), tb)
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"train-step loss not finite: {loss}")
    result["train_step_loss"] = round(loss, 4)
    del model, step, tb

    # ---- 4a: the ADD-loss SGD probe; 4a2: its gradient, card vs CPU ----
    rot_err = rotation_probe(device, points, ext)
    require(rot_err < 15.0, f"ADD-loss SGD probe stuck at {rot_err:.1f} deg")
    result["rot_probe_final_deg"] = round(rot_err, 2)
    if device.type == "cuda":
        g_card = probe_gradient(device, points, ext)
        g_cpu = probe_gradient(torch.device("cpu"), points.cpu(), ext.cpu())
        gap = float((g_card - g_cpu).abs().max() / (g_cpu.abs().max() + 1e-9))
        require(gap < 0.05, f"the card's probe gradient is {100 * gap:.2f}% off the CPU's")
        result["probe_grad_card_vs_cpu"] = gap
    else:
        result["probe_grad_card_vs_cpu"] = "not measured"

    # ---- 5: the rendered rotation signal ----
    light = np.array([0.2, -0.3, -0.9], np.float32)
    light /= np.linalg.norm(light)

    def render_one(q, t):
        d = np.full((height, width), np.inf, np.float32)
        lab = np.zeros((height, width), np.int32)
        im = np.zeros((height, width, 3), np.float32)
        gen._splat_object(PROBE_CLASS, quat_to_mat_np(q), t, d, lab, im, light)
        return im, lab

    t0v = np.array([0, 0, 0.9], np.float32)
    i0, l0 = render_one(np.array([1.0, 0, 0, 0], np.float32), t0v)
    i1, l1 = render_one(np.array([np.cos(np.pi / 8), 0, 0, np.sin(np.pi / 8)], np.float32), t0v)
    i2, l2 = render_one(np.array([1.0, 0, 0, 0], np.float32),
                        np.array([0.0008, 0, 0.9], np.float32))
    rot, shift = (l0 > 0) & (l1 > 0), (l0 > 0) & (l2 > 0)
    d_rot = float(np.abs(i0[rot] - i1[rot]).mean())
    d_noise = float(np.abs(i0[shift] - i2[shift]).mean())
    require(d_rot > 3.0 * d_noise, f"rotation signal {d_rot:.1f} not above noise {d_noise:.1f}")
    result["rot_signal_ratio"] = round(d_rot / max(d_noise, 1e-6), 1)
    result["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return result


def make_parser():
    p = base_parser("Validate the port's Hough vote kernels and training step on the card")
    p.add_argument("--out", default="output/validate_gpu.json", help="where the JSON line goes")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    device = setup_device(args.device)
    try:
        result = {"metric": "gpu_kernel_validation", "value": 1,
                  **run_checks(device)}
        rc = 0
    except AssertionError as err:
        traceback.print_exc()
        result, rc = {"metric": "gpu_kernel_validation", "value": 0, "error": str(err)}, 1
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
