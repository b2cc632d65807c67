"""Render saved pose results over their source images (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/render_poses.py` (the reference's
tools/render_poses*.py): each result's poses drawn as projected 3D boxes
(`utils/visualize.draw_detections`) over its image. Inputs are the port's
artifacts, which are the JAX CLIs':

  - `detections.json` and `<frame>-label.npy` from `cli/demo`: the image
    is `--images/<frame>-color.png`, else the label map in class
    colours; writes `<frame>-poses.png` and `<frame>-label.png`;
  - `results_NNNN.npz` from `cli/test_net --save_results`: the images are
    `--images`' `*-color.png` in sorted order, else the label maps;
    writes `NNNN-poses.png`.

    python -m posecnn_torch.cli.render_poses --device cpu --results output/eval \\
        --output output/render_poses

The box extents are a registered dataset's (`--dataset` / `--data_root`),
else 0.1 m cubes; the camera is `--fx --fy --cx --cy` (YCB-Video's by
default). The drawing is host work; `--device` is only checked.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
from PIL import Image

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data import datasets  # noqa: F401  (fills DATASETS)
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.utils.visualize import (
    draw_detections,
    label_to_color,
    overlay_label,
    save_image,
)


def make_parser():
    p = base_parser("Render saved poses over images (PyTorch/CUDA)")
    p.add_argument("--results", required=True, help="demo / test_net output dir")
    p.add_argument("--images", default=None, help="image dir (demo layout)")
    p.add_argument("--output", default="output/render_poses")
    p.add_argument("--dataset", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--num_classes", type=int, default=22)
    p.add_argument("--fx", type=float, default=1066.778)
    p.add_argument("--fy", type=float, default=1067.487)
    p.add_argument("--cx", type=float, default=312.9869)
    p.add_argument("--cy", type=float, default=241.3109)
    return p


def extents_and_colors(args, num_classes: int):
    """The dataset's box extents (else 0.1 m, background 0) and the
    generator's class colours."""
    extents = None
    if args.dataset and args.data_root and os.path.isdir(args.data_root):
        ds = DATASETS.get(args.dataset)(args.data_root, "train")
        if hasattr(ds, "extents"):
            extents = np.asarray(ds.extents, np.float32)
    if extents is None:
        extents = np.full((num_classes, 3), 0.1, np.float32)
        extents[0] = 0
    return extents, SyntheticSceneGenerator.make_class_colors(num_classes)


def _read_rgb(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def render_demo(args, results: list, k: np.ndarray) -> int:
    nc = max([args.num_classes] + [d["class"] + 1 for r in results for d in r["detections"]])
    extents, colors = extents_and_colors(args, nc)
    written = 0
    for r in results:
        frame = r["frame"]
        img_path = os.path.join(args.images, f"{frame}-color.png") if args.images else None
        lab_p = os.path.join(args.results, f"{frame}-label.npy")
        if img_path and os.path.exists(img_path):
            rgb = _read_rgb(img_path)
        elif os.path.exists(lab_p):
            rgb = label_to_color(np.load(lab_p), colors).astype(np.float32)
        else:
            continue
        dets = [(d["class"], np.asarray(d["quat_wxyz"], np.float32),
                 np.asarray(d["trans"], np.float32)) for d in r["detections"]]
        save_image(os.path.join(args.output, f"{frame}-poses.png"),
                   draw_detections(rgb, dets, extents, k, colors))
        if os.path.exists(lab_p):
            save_image(os.path.join(args.output, f"{frame}-label.png"),
                       overlay_label(rgb, np.load(lab_p), colors))
        written += 1
    return written


def render_results(args, k: np.ndarray) -> int:
    npzs = sorted(glob.glob(os.path.join(args.results, "results_*.npz")))
    img_files = sorted(glob.glob(os.path.join(args.images, "*-color.png"))) if args.images else []
    extents = colors = None
    for i, path in enumerate(npzs):
        with np.load(path) as z:
            label, poses, classes = z["label"], z["poses"], z["classes"]
        if extents is None:
            extents, colors = extents_and_colors(args, max(int(label.max()) + 1,
                                                           args.num_classes))
        rgb = (_read_rgb(img_files[i]) if i < len(img_files)
               else label_to_color(label, colors).astype(np.float32))
        dets = [(int(c), poses[j, :4], poses[j, 4:7]) for j, c in enumerate(classes)]
        save_image(os.path.join(args.output, f"{i:04d}-poses.png"),
                   draw_detections(rgb, dets, extents, k, colors))
    return len(npzs)


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    setup_device(args.device)
    load_config(args)
    os.makedirs(args.output, exist_ok=True)
    k = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]], np.float32)
    det_json = os.path.join(args.results, "detections.json")
    if os.path.exists(det_json):
        with open(det_json) as f:
            written = render_demo(args, json.load(f), k)
    else:
        written = render_results(args, k)
    print(f"wrote {written} pose renderings to {args.output}/")
    return written


if __name__ == "__main__":
    main()
