"""Training-blob sanity images (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/check_data.py` (the reference's
tools/check_data*.py and the VISUALIZE debug path): renders
`--num_samples` scenes of the procedural class library (512 points a
class, 500 px focal length at the training size, seed `rng_seed`) and
writes for each `NNN-color.png`, `NNN-label.png` (the label tint),
`NNN-gtboxes.png` (each object's projected 3D box), `NNN-vertex.png` (the
x and y of the centre directions on labelled pixels, as red and green)
and `NNN-depth.png`:

    python -m posecnn_torch.cli.check_data --device cpu --num_samples 3 \\
        --cfg experiments/cfgs/lov_color_2d_pool_full.yaml --output output/check_data

With the same cfg the images are the JAX tool's. The renders are host
work; `--device` is only checked.
"""

from __future__ import annotations

import os

import numpy as np

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.utils.visualize import draw_detections, overlay_label, save_image


def make_parser():
    p = base_parser("Training-blob sanity visualization (PyTorch/CUDA)")
    p.add_argument("--output", default="output/check_data")
    p.add_argument("--num_samples", type=int, default=3)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    setup_device(args.device)
    cfg = load_config(args)
    c, w, h = cfg.train.num_classes, cfg.train.syn_width, cfg.train.syn_height
    proc = synthetic_class_library(c, 512)
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(proc.points, proc.extents, k, width=w, height=h,
                                  t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
                                  point_colors=proc.colors, point_normals=proc.normals)
    colors = gen.class_colors
    os.makedirs(args.output, exist_ok=True)
    for i in range(args.num_samples):
        s = gen.render()
        rgb = np.clip(s.image + gen.pixel_means, 0, 255)[:, :, ::-1]
        out = os.path.join(args.output, f"{i:03d}")
        save_image(out + "-color.png", rgb)
        save_image(out + "-label.png", overlay_label(rgb, s.label, colors))
        dets = [(int(r[1]), r[6:10], r[10:13]) for r in s.poses]
        save_image(out + "-gtboxes.png", draw_detections(rgb, dets, proc.extents, k, colors))
        # the centre directions as red (x) and green (y) on labelled pixels
        vert = np.zeros((h, w, 3), np.float32)
        ys, xs = np.nonzero(s.label > 0)
        cls = s.label[ys, xs]
        vert[ys, xs, 0] = (s.vertex_targets[ys, xs, 3 * cls] + 1) * 127.5
        vert[ys, xs, 1] = (s.vertex_targets[ys, xs, 3 * cls + 1] + 1) * 127.5
        save_image(out + "-vertex.png", vert)
        d = s.depth / max(s.depth.max(), 1e-6) * 255
        save_image(out + "-depth.png", np.stack([d] * 3, -1))
        print(f"sample {i}: {len(dets)} objects, {int((s.label > 0).sum())} fg px")
    print(f"wrote {args.output}/")
    return 0


if __name__ == "__main__":
    main()
