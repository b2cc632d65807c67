"""Oracle rotation eval: the quaternion head's quality on GT RoIs.

Counterpart of `experiments/eval_rotation_oracle.py`, the r6 accuracy
figure "rotation oracle 36.6° mean". `test_net`'s pose metrics depend on
Hough's detections, so early in training they read ~0 however well the
pose head has learned rotation. This probe feeds the pose head the exact
GT RoIs instead: the training forward with the GT RoIs prepended
(`gt_pose_rois`, keep_prob 1, 7 objects an image), on held-out synthetic
scenes rendered from a YCB-Video root's model clouds at seed `--seed`,
and reads rows [0, G) of `poses_pred`, the G GT rows. Per class it
reports the mean and median rotation error of the predicted quaternion:
the geodesic error (ref `lib/utils/pose_error.py:92-106`), or for a
symmetric class (a surface of revolution) the angle between the
predicted and GT object z-axes. The summary JSON has the JAX script's
keys (metric, ckpt_step, num_images, nonsym_classes, nonsym_mean_deg,
nonsym_below_45deg, per_class); its last line is the summary without
per_class.

    python -m posecnn_torch.cli.eval_rotation_oracle --ckpt snap.npz \\
        --data_root /path/to/LOV --num_images 20 --seed 4242

The checkpoint is in the JAX `.npz` layout (`core/checkpoint.restore_params`,
strict); the head flags and the paint flags come from its metadata where
it records them. `--data_root` has no default: a `data/fabricate.write_ycb_tree`
root stands in for YCB-Video. `--backgrounds` (none by default) is the
compositing pool training used. The trunk and heads compute in the cfg's
`compute_dtype` on every device, as JAX's script does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from posecnn_torch.cli.common import (
    YCB_K,
    data_flags_from_ckpt,
    head_flags_from_ckpt,
    load_backgrounds,
    setup_device,
)
from posecnn_torch.core.checkpoint import restore_params
from posecnn_torch.core.config import cfg_from_file
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data import datasets  # noqa: F401  (fills DATASETS)
from posecnn_torch.data.pipeline import to_device
from posecnn_torch.data.procedural import colorize_model_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.models import PoseCNN
from posecnn_torch.utils.quaternion import quat_to_mat

DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "experiments", "cfgs", "lov_color_2d.yaml")
MAX_OBJECTS = 7  # eval_rotation_oracle.py:134


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="rotation error of the pose head on GT RoIs")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data_root", default=None,
                    help="a YCB-Video root (models/<cls>/points.xyz, extents.txt)")
    ap.add_argument("--cfg", default=DEFAULT_CFG)
    ap.add_argument("--num_images", type=int, default=20)
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--out", default="output/r3_rot_oracle.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default 'cuda' fails when no card is present")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="evaluate at scale×(syn_width, syn_height) with k scaled to match "
                    "(the training TRAIN.SCALES_BASE measures at the trained feature scale)")
    ap.add_argument("--backgrounds", default=None,
                    help="compositing pool (a glob): the SAME pool training used, so the "
                    "oracle's features see the train distribution; none disables")
    return ap


def rotation_errors(preds: np.ndarray, gt_poses: np.ndarray, gt_valid: np.ndarray,
                    symmetry: np.ndarray):
    """(class, degrees) for each valid GT row with a predicted quaternion
    of norm ≥ 1e-6: the geodesic error, or the z-axis angle for a
    symmetric class (`eval_rotation_oracle.py:155-190`)."""
    out = []
    for i in np.flatnonzero(gt_valid):
        cls = int(gt_poses[i, 1])
        q_pred = preds[i, 4 * cls: 4 * cls + 4]
        nrm = np.linalg.norm(q_pred)
        if nrm < 1e-6:
            continue
        r_pred = quat_to_mat(torch.from_numpy(q_pred / nrm)).numpy()
        r_gt = quat_to_mat(torch.from_numpy(gt_poses[i, 6:10])).numpy()
        if symmetry[cls] > 0:
            cos = float(np.clip(np.dot(r_pred[:, 2], r_gt[:, 2]), -1.0, 1.0))
        else:
            cos = float(np.clip((np.trace(r_pred.T @ r_gt) - 1.0) / 2.0, -1.0, 1.0))
        out.append((cls, float(np.degrees(np.arccos(cos)))))
    return out


def summarize(per_class: dict, symmetry: np.ndarray, num_classes: int, step: int,
              num_images: int) -> dict:
    """The JAX script's summary (`eval_rotation_oracle.py:192-219`)."""
    rows, nonsym_mean, below45 = {}, [], 0
    for cls in range(1, num_classes):
        errs = per_class.get(cls, [])
        if not errs:
            continue
        m = float(np.mean(errs))
        sym = bool(symmetry[cls] > 0)
        rows[cls] = {"n": len(errs), "mean_deg": round(m, 1),
                     "median_deg": round(float(np.median(errs)), 1), "symmetric": sym,
                     "metric": "axis_deg" if sym else "geodesic_deg"}
        if not sym:
            nonsym_mean.append(m)
            below45 += int(m < 45.0)
    return {
        "metric": "rotation_oracle",
        "ckpt_step": int(step),
        "num_images": num_images,
        "nonsym_classes": len(nonsym_mean),
        "nonsym_mean_deg": round(float(np.mean(nonsym_mean)), 1) if nonsym_mean else None,
        "nonsym_below_45deg": below45,
        "per_class": rows,
    }


def main(argv=None) -> dict:
    parser = make_parser()
    args = parser.parse_args(argv)
    if not args.data_root:
        parser.error("--data_root: a YCB-Video root is needed for the model clouds "
                     "(posecnn_torch.data.fabricate.write_ycb_tree writes one)")
    device = setup_device(args.device)
    cfg = cfg_from_file(args.cfg)
    t = cfg.train
    ds = DATASETS.get("ycb_video")(args.data_root, "train")
    c = ds.num_classes
    symmetry = np.asarray(ds.symmetry)
    colors, normals = colorize_model_library(ds.points, **data_flags_from_ckpt(cfg, args.ckpt))
    width, height = t.syn_width, t.syn_height
    k = YCB_K.copy()
    if args.scale != 1.0:
        width, height = int(round(width * args.scale)), int(round(height * args.scale))
        k[:2, :] *= args.scale
    # the held-out scenes of test_net's synthetic eval
    gen = SyntheticSceneGenerator(
        ds.points, ds.extents, k, width=width, height=height, t_near=t.syn_tnear,
        t_far=t.syn_tfar, pixel_means=cfg.pixel_means, seed=args.seed, point_colors=colors,
        point_normals=normals,
        class_whitelist=[min(t.syn_class_index, c - 1)] if t.syn_class_index > 0 else None,
        backgrounds=load_backgrounds(args.backgrounds, (height, width)),
    )
    model = PoseCNN(
        c, num_units=t.num_units, fc_dim=t.fc_dim, **head_flags_from_ckpt(cfg, args.ckpt),
        compute_dtype=getattr(torch, cfg.compute_dtype),
        vertex_reg=True, pose_reg=True, hough_num_samples=t.hough_num_samples,
        max_objects=MAX_OBJECTS, gt_pose_rois=True,
    )
    # JAX initialises its template on one minibatch first: draw it, so that
    # the evaluated scenes are the same ones
    n_gt = gen.minibatch(1, dense_vertex_targets=False)["gt_poses"].shape[0]
    step = restore_params(args.ckpt, model)
    model = model.to(device)
    print(f"restored checkpoint at step {step}")
    extents = torch.from_numpy(ds.extents).to(device)

    per_class: dict = {}
    for _ in range(args.num_images):
        host = gen.minibatch(1, dense_vertex_targets=False)
        b = to_device({key: host[key] for key in ("data", "meta", "gt_poses", "gt_valid")},
                      device)
        with torch.inference_mode():
            out = model.train_forward(b["data"], extents, b["meta"], b["gt_poses"],
                                      b["gt_valid"], keep_prob=1.0)
        # the GT rows come first: rows [0, n_gt) of poses_pred
        preds = out.poses_pred[:n_gt].float().cpu().numpy()
        for cls, err in rotation_errors(preds, host["gt_poses"], host["gt_valid"], symmetry):
            per_class.setdefault(cls, []).append(err)

    summary = summarize(per_class, symmetry, c, step, args.num_images)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({key: v for key, v in summary.items() if key != "per_class"}))
    return summary


if __name__ == "__main__":
    main()
