"""Synthesizer drive: render scenes, report statistics and throughput
(PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/test_synthesis.py` (the reference's
tools/test_synthesis*.py): renders `--num_samples` scenes with the
carried generator (`data/synthetic.py`, seed `rng_seed`, 500 px focal
length at the training size) from the procedural class library
(`--num_points` a class), or from a registered dataset's model clouds
with `--dataset` / `--data_root`, and writes
`<output>/synthesis_report.json`:

  scenes_per_sec          render throughput on this host (the feed's
                          producer-side budget; host work, no card)
  mean_objects_per_scene, mean_fg_fraction, class_frequency
  tz_range, tz_within_config   translations against t_near / t_far
  max_quat_norm_err       |‖q‖ − 1| over every pose

`--save_images N` writes the first N scenes' colour and label-tint PNGs:

    python -m posecnn_torch.cli.test_synthesis --device cpu --num_samples 20 \\
        --cfg experiments/cfgs/lov_color_2d_pool_full.yaml

With the same cfg every number but `scenes_per_sec` is the JAX tool's.
The JAX tool's dataset branch paints the clouds with the procedural
library's colours, which it has not built there, and fails; here a
dataset's clouds render unpainted.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data import datasets  # noqa: F401  (fills DATASETS)
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.utils.visualize import overlay_label, save_image


def make_parser():
    p = base_parser("Synthetic-scene generator check (PyTorch/CUDA)")
    p.add_argument("--output", default="output/test_synthesis")
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--dataset", default=None, help="registered dataset for real model clouds")
    p.add_argument("--data_root", default=None)
    p.add_argument("--num_points", type=int, default=512)
    p.add_argument("--save_images", type=int, default=0,
                   help="write the first N samples as PNGs")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args.device)
    cfg = load_config(args)
    w, h = cfg.train.syn_width, cfg.train.syn_height
    points = extents = colors = normals = None
    if args.dataset and args.data_root and os.path.isdir(args.data_root):
        ds = DATASETS.get(args.dataset)(args.data_root, "train")
        if hasattr(ds, "subsampled_points"):
            points, extents = ds.subsampled_points(args.num_points), ds.extents
    if points is None:
        proc = synthetic_class_library(cfg.train.num_classes, args.num_points)
        points, extents, colors, normals = proc.points, proc.extents, proc.colors, proc.normals
    c = points.shape[0]
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(points, extents, k, width=w, height=h,
                                  t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
                                  point_colors=colors, point_normals=normals)
    os.makedirs(args.output, exist_ok=True)
    class_freq = np.zeros(c, np.int64)
    fg_fracs, n_objs, tz_all, qnorm_all = [], [], [], []
    t0 = time.perf_counter()
    for i in range(args.num_samples):
        s = gen.render()
        cls = s.poses[:, 1].astype(int)
        class_freq[cls] += 1
        n_objs.append(len(cls))
        fg_fracs.append(float((s.label > 0).mean()))
        tz_all.extend(s.poses[:, 12].tolist())
        qnorm_all.extend(np.linalg.norm(s.poses[:, 6:10], axis=1).tolist())
        if i < args.save_images:
            rgb = np.clip(s.image + gen.pixel_means, 0, 255)[:, :, ::-1]
            save_image(os.path.join(args.output, f"{i:03d}-color.png"), rgb)
            save_image(os.path.join(args.output, f"{i:03d}-label.png"),
                       overlay_label(rgb, s.label, gen.class_colors))
    dt = time.perf_counter() - t0
    tz = np.asarray(tz_all)
    summary = dict(
        num_samples=args.num_samples,
        scenes_per_sec=round(args.num_samples / max(dt, 1e-9), 2),
        mean_objects_per_scene=float(np.mean(n_objs)),
        mean_fg_fraction=float(np.mean(fg_fracs)),
        class_frequency={int(i): int(f) for i, f in enumerate(class_freq) if f},
        tz_range=[float(tz.min()), float(tz.max())] if tz.size else None,
        tz_within_config=bool(tz.size and tz.min() >= cfg.train.syn_tnear - 1e-6
                              and tz.max() <= cfg.train.syn_tfar + 1e-6),
        max_quat_norm_err=float(np.abs(np.asarray(qnorm_all) - 1).max()) if qnorm_all else None,
    )
    with open(os.path.join(args.output, "synthesis_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
