"""Evaluate PoseCNN on held-out synthetic scenes (PyTorch/CUDA port).

Counterpart of the synthetic posecnn branch of
`posecnn_tpu/cli/test_net.py:43-420`: frames rendered by the carried
generator from the procedural class library at the training resolution
(seed 1234, held out from training's), the forward with per-class NMS,
detections, optionally RANSAC centres (`--ransac`) and ICP against the
rendered depth (`--refine`), then `PoseEvaluator`:

    python -m posecnn_torch.cli.test_net --cfg experiments/cfgs/lov_color_2d_pool_full.yaml \\
        --ckpt output/train/snapshot_iter_N.npz --num_images 64 --refine --output output/eval

    # at toy size on the CPU
    python -m posecnn_torch.cli.test_net --device cpu --num_images 2 --refine \\
        --output output/eval_toy --set train.num_classes=4 train.syn_height=48 \\
        train.syn_width=64 train.num_units=16 train.fc_dim=64 test.hough_num_samples=64 \\
        train.add_num_points=32

`<output>/eval.json` holds the evaluator's summary, as the JAX test_net
writes it, and under "run" the device, the images/s of the loop and the
seconds of each stage (render, forward, extract = NMS, detections and
RANSAC, icp, evaluate), with the number of detections and of refined
ones. Weights come from `--ckpt` (the JAX `.npz` layout, either
package's), else seeded random ones (`init_weights`, `rng_seed`).

Not ported yet, each raising: the dataset branches (`--dataset
ycb_video|lov|linemod`, or a `--data_root` holding `models/`), RGBD,
DEPTH and NORMAL input, and the detection family (`network:
posecnn_det`); ROADMAP.md Queue 1 names what each waits for.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from posecnn_torch.cli.common import base_parser, head_flags_from_ckpt, load_config, setup_device
from posecnn_torch.cli.train_net import _load_backgrounds
from posecnn_torch.core.checkpoint import restore_params
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.engine.evaluate import (
    PoseEvaluator,
    extract_detections,
    format_per_class_table,
)
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.ops.nms import nms_per_class
from posecnn_torch.refine.icp import icp_refine_batch
from posecnn_torch.refine.ransac import draw_hypotheses, estimate_center

STAGES = ("render", "forward", "extract", "icp", "evaluate")


def make_parser():
    p = base_parser("PoseCNN evaluation on synthetic scenes (PyTorch/CUDA)")
    p.add_argument("--dataset", default="synthetic",
                   help="only 'synthetic' runs in the port; ycb_video, lov and linemod raise")
    p.add_argument("--data_root", default=None,
                   help="a dataset root; one holding models/ (YCB geometry) raises")
    p.add_argument("--ckpt", default=None, help="weights in the JAX .npz layout")
    p.add_argument("--output", default="output/eval")
    p.add_argument("--num_images", type=int, default=20)
    p.add_argument("--refine", action="store_true", help="ICP against the rendered depth")
    p.add_argument("--ransac", action="store_true",
                   help="translation from a RANSAC centre of the vertex directions instead of "
                   "the Hough maximum")
    p.add_argument("--seed", type=int, default=1234, help="held-out scene seed")
    p.add_argument("--backgrounds", default=None,
                   help="glob of RGB frames composited behind the renders, as training's "
                   "--backgrounds (default: none)")
    p.add_argument("--instance_matching", action="store_true",
                   help="match detections to GTs greedily per instance, not one per class")
    p.add_argument("--save_results", action="store_true",
                   help="write results_NNNN.npz per image (label, rois, keep, poses, classes)")
    return p


def check_supported(args, cfg) -> None:
    """Raise on what the port's evaluation cannot run yet, naming the
    ROADMAP.md Queue 1 item it waits for."""
    if cfg.network == "posecnn_det":
        raise NotImplementedError("network posecnn_det: the detection family's evaluation "
                                  "waits for ROADMAP.md Queue 1, 'Secondary families'")
    if args.dataset != "synthetic" or (
            args.data_root and os.path.exists(os.path.join(args.data_root, "models"))):
        raise NotImplementedError(
            f"--dataset {args.dataset!r} / --data_root {args.data_root!r}: real datasets and "
            "YCB geometry wait for ROADMAP.md Queue 1, 'The dataset branches of test_net'")
    if cfg.input != "COLOR":
        raise NotImplementedError(f"input {cfg.input!r}: the RGBD, DEPTH and NORMAL towers wait "
                                  "for ROADMAP.md Queue 1, 'The rest of the posecnn family'")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ransac_translation(label, vertex_pred, dets, k, seed):
    """Each detection's translation from a RANSAC centre of its class's
    vertex directions (up to 1024 pixels, 64 hypotheses drawn from a
    generator seeded by (seed, detection index)) and the median voted
    depth. label (H, W) int numpy; vertex_pred (H, W, 3C) on the device."""
    n_fix = 1024
    dev = vertex_pred.device
    out = []
    for di, (cls, q, t) in enumerate(dets):
        ys, xs = np.nonzero(label == cls)
        if len(ys) < 10:
            out.append((cls, q, t))
            continue
        sel = np.linspace(0, len(ys) - 1, min(len(ys), n_fix)).astype(int)
        m = len(sel)
        yx = torch.from_numpy(np.stack([ys[sel], xs[sel]])).to(dev)
        vp = vertex_pred[yx[0], yx[1], 3 * cls : 3 * cls + 3]
        px_xy = torch.zeros((n_fix, 2), dtype=torch.float32, device=dev)
        dirs = torch.zeros((n_fix, 2), dtype=torch.float32, device=dev)
        valid = torch.zeros((n_fix,), dtype=torch.bool, device=dev)
        px_xy[:m] = torch.stack([yx[1], yx[0]], 1).float()
        dirs[:m] = vp[:, :2]
        valid[:m] = True
        seq = np.random.SeedSequence([seed, di])
        g = torch.Generator().manual_seed(int(seq.generate_state(1)[0]))
        est = estimate_center(px_xy, dirs, valid, draw_hypotheses(valid, 64, 2, g))
        cxy = est.center.cpu().numpy()
        z = float(np.median(torch.exp(vp[:, 2]).cpu().numpy()))
        t_new = np.array([(cxy[0] - k[0, 2]) / k[0, 0] * z, (cxy[1] - k[1, 2]) / k[1, 1] * z, z],
                         np.float32)
        out.append((cls, q, t_new))
    return out


def refine_detections(dets, label_t, depth, points, k, cfg, device):
    """All detections of a frame refined by ICP in one batch."""
    cls = torch.tensor([d[0] for d in dets], device=device)
    res = icp_refine_batch(
        torch.from_numpy(np.stack([np.asarray(d[1], np.float32) for d in dets])).to(device),
        torch.from_numpy(np.stack([np.asarray(d[2], np.float32) for d in dets])).to(device),
        points[cls], torch.from_numpy(depth).to(device), label_t[None] == cls[:, None, None],
        torch.from_numpy(k).to(device), num_iters=cfg.test.icp_iters,
        num_hypotheses=cfg.test.icp_hypotheses, rot_perturb=cfg.test.icp_rot_perturb)
    quats, transs = res.quat.cpu().numpy(), res.trans.cpu().numpy()
    return [(c, quats[i], transs[i]) for i, (c, _, _) in enumerate(dets)]


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    check_supported(args, cfg)
    device = setup_device(args.device)
    c = cfg.train.num_classes
    # the procedural class library training renders (data/procedural.py, seed 0)
    proc = synthetic_class_library(c, 2620)
    width, height = cfg.train.syn_width, cfg.train.syn_height
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    # TEST.SCALES_BASE: evaluate at a rescaled resolution, intrinsics with it
    scale_base = float(cfg.test.scales_base[0]) if cfg.test.scales_base else 1.0
    if scale_base != 1.0:
        width, height = int(round(width * scale_base)), int(round(height * scale_base))
        k = k.copy()
        k[:2, :] *= scale_base
    gen = SyntheticSceneGenerator(
        proc.points, proc.extents, k, width=width, height=height, t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar, pixel_means=cfg.pixel_means, seed=args.seed,
        point_colors=proc.colors, point_normals=proc.normals,
        backgrounds=_load_backgrounds(args.backgrounds, (height, width)),
    )
    idxp = np.linspace(0, proc.points.shape[1] - 1, cfg.train.add_num_points).astype(int)
    points = proc.points[:, idxp]
    adi_classes = tuple(int(i) for i in np.nonzero(proc.symmetry)[0])

    model = PoseCNN(
        c, num_units=cfg.train.num_units, fc_dim=cfg.train.fc_dim,
        **head_flags_from_ckpt(cfg, args.ckpt),
        # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
        compute_dtype=getattr(torch, cfg.compute_dtype) if device.type == "cuda"
        else torch.float32,
        hough_num_samples=cfg.test.hough_num_samples, skip_pixels=cfg.test.hough_skip_pixels,
        max_objects=8, vote_threshold=cfg.test.voting_threshold,
    )
    if args.ckpt:
        print(f"restored checkpoint at step {restore_params(args.ckpt, model)}")
    else:
        init_weights(model, cfg.rng_seed)
    model = model.to(device).eval()
    extents_t = torch.from_numpy(proc.extents).to(device)
    points_t = torch.from_numpy(points).to(device)
    meta = np.zeros((1, 48), np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    meta_t = torch.from_numpy(meta).to(device)

    use_ransac = args.ransac or cfg.test.ransac
    evaluator = PoseEvaluator(num_classes=c, points=points, extents=proc.extents,
                              symmetric_classes=adi_classes,
                              instance_matching=args.instance_matching, device=str(device))
    seconds = dict.fromkeys(STAGES, 0.0)
    n_dets = n_refined = 0
    os.makedirs(args.output, exist_ok=True)
    wall0 = time.perf_counter()
    for i in range(args.num_images):
        t = [time.perf_counter()]
        sample = gen.render()
        gts = [(int(row[1]), row[6:10], row[10:13]) for row in sample.poses]
        t.append(time.perf_counter())
        out = model(torch.from_numpy(sample.image[None]).to(device), extents_t, meta_t,
                    full_vertex=use_ransac)
        _sync(device)
        t.append(time.perf_counter())
        keep = nms_per_class(out.hough.rois, cfg.test.nms_threshold, out.hough.valid)
        label_t = out.label_2d[0]
        label = label_t.cpu().numpy()
        rois = out.hough.rois.cpu().numpy()
        dets = extract_detections(rois, out.hough.poses_init.cpu().numpy(),
                                  out.poses_pred.cpu().numpy(), keep.cpu().numpy(), c)
        if use_ransac and dets:
            dets = ransac_translation(label, out.vertex_pred[0], dets, k, args.seed)
        if args.save_results:
            np.savez_compressed(
                os.path.join(args.output, f"results_{i:04d}.npz"),
                label=label.astype(np.int32), rois=rois, keep=keep.cpu().numpy(),
                poses=np.asarray([np.concatenate([q, t_]) for _, q, t_ in dets])
                if dets else np.zeros((0, 7), np.float32),
                classes=np.asarray([cls for cls, _, _ in dets], np.int32),
            )
        n_dets += len(dets)
        t.append(time.perf_counter())
        if args.refine and dets:
            dets = refine_detections(dets, label_t, sample.depth, points_t, k, cfg, device)
            n_refined += len(dets)
        t.append(time.perf_counter())
        evaluator.add_segmentation(sample.label, label)
        evaluator.add_image(dets, gts)
        t.append(time.perf_counter())
        for name, a, b in zip(STAGES, t, t[1:]):
            seconds[name] += b - a
    wall = time.perf_counter() - wall0

    summary = evaluator.summarize()
    summary["run"] = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "images_per_s": args.num_images / wall,
        "seconds": seconds, "detections": n_dets, "refined": n_refined,
    }
    with open(os.path.join(args.output, "eval.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(format_per_class_table(summary))
    print(json.dumps({k_: v for k_, v in summary.items() if k_ != "per_class"}, indent=2))
    print(f"wrote {args.output}/eval.json")
    return summary


if __name__ == "__main__":
    main()
