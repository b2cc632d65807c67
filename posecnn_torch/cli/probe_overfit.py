"""Single-batch pose-overfit probe: can the whole train path memorise rotation?
(PyTorch/CUDA port.)

Counterpart of `experiments/probe_overfit_pose.py`, the r6 overfit guard
(`experiments/finish_round_r6.sh:85-89`: `--iters 400 --sweep adam:0.0003
--assert_below 15`). It fixes one minibatch of `--batch` scenes of class
`--cls_index` alone at `--height` × `--width` (`experiments/cfgs/rot_probe.yaml`:
160 × 160, class 1, orientation paint, the GT RoIs prepended), rendered
from a YCB-Video root's model clouds (`--data_root`; a
`data/fabricate.write_ycb_tree` root stands in for the real one) with
YCB's focal length / 4, and trains the full graph (trunk, heads, Hough on
the dense backend as JAX's probe runs it, RoI pool, pose head) from seeded
weights on the ADD pose loss alone. Two images need no generalisation: a
correctly plumbed path drives the on-batch rotation error towards 0.

Each `--sweep` entry (`momentum:LR` or `adam:LR`) starts from the same
weights with its own optimizer (plain, as JAX's probe: no decay, no
clip). Every `--log_every` steps (and the first) a line gives the pose
loss, the mean geodesic rotation error over the weighted rows, the mean
|tanh| of the active quaternion channels, the pose head's gradient norm
and the weighted rows; `--out` gets JAX's JSON (one record a config:
opt, lr, iters, fresh_batches, full_loss, keep_prob, final_rot_err,
min_rot_err, history) plus the config's seconds and ms a step. With
`--assert_below D` the exit code is nonzero unless every config's
minimum error is under D degrees. The trunk and heads compute in bf16 on
the card and fp32 on the CPU. `--set` overrides the yaml (the CPU tests
shrink the widths with it); JAX's `--fresh_batches`, `--pool`,
`--full_loss` and `--qmag_w` variants are not carried.

    python -m posecnn_torch.cli.probe_overfit --data_root /path/to/LOV --iters 400 \\
        --sweep adam:0.0003 --assert_below 15 --out output/overfit_guard.json
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data import datasets  # noqa: F401  (fills DATASETS)
from posecnn_torch.data.pipeline import to_device
from posecnn_torch.data.procedural import colorize_model_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.train import Optimizer, dropout_generators, loss_point_scale
from posecnn_torch.models import PoseCNN
from posecnn_torch.models.posecnn import init_weights
from posecnn_torch.ops.add_loss import average_distance_loss

ROT_PROBE_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "experiments", "cfgs", "rot_probe.yaml")
# YCB-Video's focal lengths (posecnn_tpu's probe divides them by 4 for 160 px)
YCB_FX, YCB_FY = 1066.778, 1067.487


class Probe(NamedTuple):
    model: PoseCNN
    batch: dict  # the fixed minibatch, on the device
    extents: torch.Tensor
    points: torch.Tensor  # (C, add_num_points, 3), scaled for the ADD loss
    symmetry: torch.Tensor  # (C,), effective
    keep_prob: float


def build_probe(args, cfg, device) -> Probe:
    """The seeded model (init seed 0) and the fixed batch of the probe."""
    t = cfg.train
    ds = DATASETS.get("ycb_video")(args.data_root, "train")
    c = ds.num_classes
    colors, normals = colorize_model_library(ds.points, orient_detail=True)
    k = np.array([[YCB_FX / 4, 0, args.width / 2], [0, YCB_FY / 4, args.height / 2],
                  [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(ds.points, ds.extents, k, width=args.width, height=args.height,
                                  t_near=t.syn_tnear, t_far=t.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=1234,
                                  class_whitelist=[args.cls_index], point_colors=colors,
                                  point_normals=normals)
    idx = np.linspace(0, ds.points.shape[1] - 1, t.add_num_points).astype(int)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = PoseCNN(c, num_units=t.num_units, fc_dim=t.fc_dim, vote_threshold=t.voting_threshold,
                    hough_num_samples=t.hough_num_samples, max_objects=8,
                    max_pose_rois=t.max_pose_rois, gt_pose_rois=True, hough_backend="xla",
                    compute_dtype=compute_dtype)
    init_weights(model, 0)
    model = model.to(device)
    batch = gen.minibatch(args.batch, max_gt=max(16, args.batch), dense_vertex_targets=False)
    extents = torch.from_numpy(np.asarray(ds.extents, np.float32)).to(device)
    points, symmetry = loss_point_scale(
        torch.from_numpy(np.ascontiguousarray(ds.points[:, idx])).to(device), extents,
        torch.from_numpy(np.asarray(ds.symmetry, np.float32)).to(device), True)
    return Probe(model, to_device(batch, device), extents, points, symmetry, args.keep_prob)


def probe_losses(probe: Probe, step: int):
    """(pose loss, metrics) of the fixed batch: the ADD loss over the
    weighted rows, their mean rotation error in degrees, the mean |tanh| of
    the active channels and the weighted rows' count."""
    b = probe.batch
    gens = dropout_generators(0, step, probe.extents.device)
    out = probe.model.train_forward(b["data"], probe.extents, b["meta"], b["gt_poses"],
                                    b["gt_valid"], keep_prob=probe.keep_prob, generators=gens)
    w = out.hough.poses_weight
    weighted = (w.amax(dim=1) > 0) & out.hough.valid
    num_w = weighted.float().sum()
    loss_pose = average_distance_loss(out.poses_pred, out.hough.poses_target, w, probe.points,
                                      probe.symmetry, margin=0.01, num_valid=num_w)
    with torch.no_grad():
        # pred and target are zero outside a row's 4 active channels, so
        # the row dot product is the quaternion dot product
        dot = torch.abs((out.poses_pred * out.hough.poses_target).sum(dim=1))
        ang = 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0)) * 180.0 / np.pi
        rot_err = torch.where(weighted, ang, 0.0).sum() / torch.clamp(num_w, min=1.0)
        tanh_abs = (out.poses_tanh.abs() * w).sum() / torch.clamp(w.sum(), min=1.0)
    return loss_pose, {"loss_pose": loss_pose.detach(), "rot_err": rot_err,
                       "tanh_abs": tanh_abs, "num_w": num_w}


def run_config(probe: Probe, init_state: dict, opt_name: str, lr: float, iters: int,
               log_every: int) -> dict:
    """Train from `init_state` with one optimizer; JAX's result record."""
    model = probe.model
    model.load_state_dict(init_state)
    opt = Optimizer(list(model.parameters()), kind=opt_name, schedule=lambda _count: lr)
    print(f"=== {opt_name} lr={lr} ===", flush=True)
    hist = []
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        loss, metrics = probe_losses(probe, it)
        model.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.pose_head.parameters() if p.grad is not None]
        metrics["g_pose"] = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        metrics["loss"] = metrics["loss_pose"]
        opt.update()
        if it % log_every == 0 or it == 1:
            m = {kk: round(float(v), 4) for kk, v in metrics.items()}
            m["iter"] = it
            hist.append(m)
            print(f"  it {it}: loss_pose {m['loss_pose']:.4f} rot_err {m['rot_err']:.1f} "
                  f"tanh|.| {m['tanh_abs']:.3f} g_pose {m['g_pose']:.3f} num_w {m['num_w']:.0f} "
                  f"({(time.perf_counter() - t0) / it:.3f} s/it)", flush=True)
    if probe.extents.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"opt": opt_name, "lr": lr, "iters": iters, "fresh_batches": False,
            "full_loss": False, "keep_prob": probe.keep_prob,
            "final_rot_err": hist[-1]["rot_err"],
            "min_rot_err": min(h["rot_err"] for h in hist), "history": hist,
            "seconds": seconds, "ms_per_step": 1e3 * seconds / iters}


def make_parser():
    parser = base_parser("Single-batch pose-overfit probe (PyTorch/CUDA port of "
                         "experiments/probe_overfit_pose.py)")
    parser.set_defaults(cfg_file=ROT_PROBE_CFG)
    parser.add_argument("--iters", type=int, default=1500)
    parser.add_argument("--height", type=int, default=160)
    parser.add_argument("--width", type=int, default=160)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--keep_prob", type=float, default=1.0)
    parser.add_argument("--data_root", required=True,
                        help="a YCB-Video root with models/ (e.g. a "
                        "data/fabricate.write_ycb_tree root)")
    parser.add_argument("--cls_index", type=int, default=1)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--sweep", default="momentum:0.001",
                        help="comma list of opt:lr configs, each from the same init")
    parser.add_argument("--out", default="output/probe_overfit_pose.json")
    parser.add_argument("--assert_below", type=float, default=0.0,
                        help="exit nonzero unless every config's min on-batch rotation error "
                        "is below this many degrees")
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    device = setup_device(args.device)
    probe = build_probe(args, cfg, device)
    init_state = {k: v.clone() for k, v in probe.model.state_dict().items()}
    results = []
    for spec in args.sweep.split(","):
        opt_name, lr_s = spec.strip().split(":")
        results.append(run_config(probe, init_state, opt_name, float(lr_s), args.iters,
                                  args.log_every))
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps([{kk: r[kk] for kk in ("opt", "lr", "final_rot_err", "min_rot_err")}
                      for r in results], indent=1))
    if args.assert_below > 0:
        bad = [r for r in results if r["min_rot_err"] >= args.assert_below]
        if bad:
            print(f"OVERFIT GUARD FAILED: {len(bad)} config(s) never got below "
                  f"{args.assert_below} deg: the pose train path has regressed", flush=True)
            return 1
        print(f"overfit guard ok: all configs < {args.assert_below} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
