"""ICP refinement drive: perturb GT poses, refine, report (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/test_icp.py:24-130`: render synthetic
scenes with known poses from the procedural class library (512 points a
class), perturb each GT pose (a random axis by `--rot_noise_deg`·N(0, 1)
degrees, the translation by `--trans_noise`·N(0, 1) metres a component),
refine every object of a scene in one `icp_refine_batch` call against the
rendered depth and GT masks, and report rotation and translation errors
before and after:

    python -m posecnn_torch.cli.test_icp --num_scenes 2 --rot_perturb 0.25 \\
        --set train.num_classes=22 train.syn_height=480 train.syn_width=640

    # at toy size on the CPU
    python -m posecnn_torch.cli.test_icp --device cpu --output output/icp_toy \\
        --set train.num_classes=4 train.syn_height=96 train.syn_width=128

Writes `<output>/icp_report.json`, and with `--visualize` each scene's
refined poses as projected 3D boxes on its render, `<output>/NNN-refined.png`.
With the same cfg and seed, the scenes and perturbations are the JAX
drive's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.refine.icp import icp_refine_batch
from posecnn_torch.utils.pose_error import re as rot_err, te as trans_err
from posecnn_torch.utils.quaternion import mat_to_quat_np, quat_to_mat_np
from posecnn_torch.utils.visualize import draw_detections, save_image


def make_parser():
    p = base_parser("ICP pose-refinement drive (PyTorch/CUDA)")
    p.add_argument("--output", default="output/test_icp")
    p.add_argument("--num_scenes", type=int, default=2)
    p.add_argument("--rot_noise_deg", type=float, default=8.0)
    p.add_argument("--trans_noise", type=float, default=0.03,
                   help="translation perturbation stddev (m)")
    p.add_argument("--num_iters", type=int, default=8)
    p.add_argument("--rot_perturb", type=float, default=0.0,
                   help="rotation-hypothesis half-angle (rad); 0 = off")
    p.add_argument("--visualize", action="store_true",
                   help="write NNN-refined.png: the refined poses' 3D boxes on each render")
    return p


def perturbed_scenes(cfg, num_scenes: int, rot_noise_deg: float, trans_noise: float) -> list:
    """The drive's inputs, as numpy: per scene with objects a dict of
    gt [(cls, quat, t)], the perturbed quats (N, 4) and transs (N, 3),
    model_pts (N, P, 3), the GT masks (N, H, W), depth (H, W) and k."""
    c = cfg.train.num_classes
    w, h = cfg.train.syn_width, cfg.train.syn_height
    rng = np.random.RandomState(cfg.rng_seed)
    proc = synthetic_class_library(c, 512)
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        proc.points, proc.extents, k, width=w, height=h, t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar, pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
        point_colors=proc.colors, point_normals=proc.normals,
    )
    scenes = []
    for _ in range(num_scenes):
        s = gen.render()
        gt, quats, transs = [], [], []
        for r in s.poses:
            cls, q, t = int(r[1]), r[6:10].astype(np.float32), r[10:13].astype(np.float32)
            ax = rng.randn(3)
            ax /= np.linalg.norm(ax) + 1e-12
            ang = np.deg2rad(rot_noise_deg) * rng.randn()
            dq = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * ax])
            quats.append(mat_to_quat_np(quat_to_mat_np(dq) @ quat_to_mat_np(q)).astype(np.float32))
            transs.append((t + trans_noise * rng.randn(3).astype(np.float32)).astype(np.float32))
            gt.append((cls, q, t))
        if not gt:
            continue
        classes = [g[0] for g in gt]
        scenes.append(dict(gt=gt, quats=np.stack(quats), transs=np.stack(transs),
                           model_pts=proc.points[classes],
                           masks=np.stack([s.label == cls for cls in classes]),
                           depth=s.depth, k=k,
                           # the render in RGB, and what its boxes are drawn with
                           rgb=np.clip(s.image + gen.pixel_means, 0, 255)[:, :, ::-1],
                           extents=proc.extents, colors=gen.class_colors))
    return scenes


def refine_scene(scene: dict, device, num_iters: int, rot_perturb: float):
    """`icp_refine_batch` on one scene's inputs on `device`."""
    t = {name: torch.from_numpy(np.asarray(scene[name])).to(device)
         for name in ("quats", "transs", "model_pts", "depth", "masks", "k")}
    return icp_refine_batch(t["quats"], t["transs"], t["model_pts"], t["depth"], t["masks"],
                            t["k"], num_iters=num_iters, rot_perturb=rot_perturb)


def _errors(q, t, q_gt, t_gt):
    r = torch.from_numpy(quat_to_mat_np(q))
    return (float(rot_err(r, torch.from_numpy(quat_to_mat_np(q_gt)))),
            float(trans_err(torch.from_numpy(np.asarray(t, np.float32)), torch.from_numpy(t_gt))))


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    device = setup_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    report = []
    scenes = perturbed_scenes(cfg, args.num_scenes, args.rot_noise_deg, args.trans_noise)
    for si, scene in enumerate(scenes):
        res = refine_scene(scene, device, args.num_iters, args.rot_perturb)
        quats, transs, scores = res.quat.cpu().numpy(), res.trans.cpu().numpy(), res.score.cpu()
        for i, (cls, q_gt, t_gt) in enumerate(scene["gt"]):
            re0, te0 = _errors(scene["quats"][i], scene["transs"][i], q_gt, t_gt)
            re1, te1 = _errors(quats[i], transs[i], q_gt, t_gt)
            before, after = dict(re=re0, te=te0), dict(re=re1, te=te1, score=float(scores[i]))
            report.append(dict(scene=si, cls=cls, before=before, after=after))
            print(f"scene {si} cls {cls}: RE {re0:.2f}->{re1:.2f} deg, "
                  f"TE {te0 * 100:.2f}->{te1 * 100:.2f} cm, score {after['score']:.3f}")
        if args.visualize:
            dets = [(cls, quats[i], transs[i]) for i, (cls, _, _) in enumerate(scene["gt"])]
            save_image(os.path.join(args.output, f"{si:03d}-refined.png"),
                       draw_detections(scene["rgb"], dets, scene["extents"], scene["k"],
                                       scene["colors"]))
    te_before = np.mean([r["before"]["te"] for r in report]) if report else 0.0
    te_after = np.mean([r["after"]["te"] for r in report]) if report else 0.0
    summary = dict(num_objects=len(report), mean_te_before_cm=float(te_before * 100),
                   mean_te_after_cm=float(te_after * 100), objects=report)
    with open(os.path.join(args.output, "icp_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "objects"}))
    return summary


if __name__ == "__main__":
    main()
