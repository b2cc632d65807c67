"""Export rendered scenes or dataset frames to a COCO annotation file
(PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/export_coco.py` (ref:
my_tools/ycb_to_coco.py walking LOV frames, my_tools/fat_to_coco.py).
Two sources:

- `--dataset synthetic`: renders `--num_images` scenes (seed `--seed`)
  with the carried generator and its C++ splat, saving the colour and
  depth PNGs under `<output>/images`. The class geometry is YCB-Video's
  (its model clouds, 512 points a class, YCB's camera) when `--data_root`
  holds `models/`, else `train.num_classes` random clouds seeded 0 with a
  500 px camera at the training size, as in JAX;
- a registered pose dataset (`--dataset ycb_video|lov …` with
  `--data_root`): walks `--image_set` (the first `--num_images` frames;
  0 for all) and converts each frame's label map and `-meta.mat` poses.

Each annotation carries the reference's meta payload {center, pose
(quaternion + translation), intrinsic_matrix}; each image its depth file
and depth factor. Writes `<output>/annotations.json` and prints one JSON
line {out, images, annotations, categories}. The JSON is the JAX CLI's on
the same arguments (`tests/test_torch_coco_export.py`). Host work only:
nothing runs on the card, and `--device` is not read.

    python -m posecnn_torch.cli.export_coco --dataset synthetic --num_images 20 \\
        --output output/coco_syn
    python -m posecnn_torch.cli.export_coco --dataset lov --data_root /path/to/LOV \\
        --image_set val --output output/coco_val
"""

from __future__ import annotations

import json
import os

import numpy as np

from posecnn_torch.cli.common import base_parser, class_data_from_dataset, load_config
from posecnn_torch.core.registry import DATASETS
from posecnn_torch.data import datasets  # noqa: F401  (fills DATASETS)
from posecnn_torch.data.coco_export import CocoWriter, frame_annotations
from posecnn_torch.data.minibatch import build_pose_blob
from posecnn_torch.data.synthetic import SyntheticSceneGenerator
from posecnn_torch.utils.quaternion import mat_to_quat_np

YCB_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32)


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _export_synthetic(args, cfg) -> dict:
    t = cfg.train
    if args.data_root and os.path.isdir(os.path.join(args.data_root, "models")):
        ds = DATASETS.get("ycb_video")(args.data_root, "train")
        points, extents, _ = class_data_from_dataset(ds, 512)
        classes, k = list(ds.classes[1:]), YCB_K
    else:  # random clouds, as the JAX CLI's hermetic branch
        rng = np.random.RandomState(0)
        points = rng.uniform(-0.05, 0.05, (t.num_classes, 256, 3)).astype(np.float32)
        points[0] = 0
        extents = np.abs(points).max(1) * 2.0
        classes = [f"class_{i:02d}" for i in range(1, t.num_classes)]
        k = np.array([[500.0, 0, t.syn_width / 2.0], [0, 500.0, t.syn_height / 2.0], [0, 0, 1]],
                     np.float32)
    gen = SyntheticSceneGenerator(points, extents, k, width=t.syn_width, height=t.syn_height,
                                  t_near=t.syn_tnear, t_far=t.syn_tfar, seed=args.seed)
    writer = CocoWriter(classes, supercategory="YCB")
    img_dir = os.path.join(args.output, "images")
    os.makedirs(img_dir, exist_ok=True)
    annot_id = 1
    for i in range(args.num_images):
        s = gen.render(dense_vertex_targets=False)
        image_id = i + 1
        name, depth_name = f"{image_id:06d}-color.png", f"{image_id:06d}-depth.png"
        rgb = np.clip(s.image[:, :, ::-1] + gen.pixel_means[::-1], 0, 255).astype(np.uint8)
        _save_png(os.path.join(img_dir, name), rgb)
        _save_png(os.path.join(img_dir, depth_name),
                  np.clip(s.depth * 10000.0, 0, 65535).astype(np.uint16))
        writer.add_image(image_id, t.syn_width, t.syn_height, name, depth_name)
        annot_id = frame_annotations(writer, image_id, annot_id, s.label, s.poses, k,
                                     segmentation=args.segmentation, eps_frac=args.eps)
    return writer.get_annot_json()


def _export_real(args) -> dict:
    if not args.data_root:
        raise ValueError(f"--dataset {args.dataset} needs --data_root")
    ds = DATASETS.get(args.dataset)(args.data_root, args.image_set)
    writer = CocoWriter(list(ds.classes[1:]), supercategory=args.dataset.upper())
    annot_id = 1
    indices = ds.image_index[: args.num_images] if args.num_images else ds.image_index
    for i, index in enumerate(indices):
        frame = ds.load_frame(index)
        if "label" not in frame or "poses" not in frame:
            continue
        image_id = i + 1
        poses = frame["poses"]  # (3, 4, N)
        n = poses.shape[2]
        quats = np.stack([mat_to_quat_np(poses[:, :3, j]) for j in range(n)])
        trans = poses[:, 3, :].T
        centers = frame.get("center", np.zeros((n, 2), np.float32))
        gt = build_pose_blob(0, frame["cls_indexes"].astype(np.int32), quats, trans,
                             centers=centers)
        h, w = frame["label"].shape[:2]
        writer.add_image(image_id, w, h, f"{index}-color.png", f"{index}-depth.png",
                         factor_depth=float(np.squeeze(frame["meta"].get("factor_depth",
                                                                         10000.0))))
        annot_id = frame_annotations(writer, image_id, annot_id, frame["label"], gt,
                                     frame["intrinsic_matrix"], segmentation=args.segmentation,
                                     eps_frac=args.eps)
    return writer.get_annot_json()


def make_parser():
    parser = base_parser("Export rendered scenes or dataset frames to COCO JSON (PyTorch/CUDA "
                         "port; ref my_tools/ycb_to_coco.py)")
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--data_root", default=None,
                        help="the dataset's root; with --dataset synthetic, YCB-Video geometry "
                        "when it holds models/")
    parser.add_argument("--image_set", default="train")
    parser.add_argument("--output", default="output/coco")
    parser.add_argument("--num_images", type=int, default=10)
    parser.add_argument("--segmentation", choices=["polygon", "rle"], default="polygon")
    parser.add_argument("--eps", type=float, default=0.003, help="polygon simplify frac")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    os.makedirs(args.output, exist_ok=True)
    data = _export_synthetic(args, cfg) if args.dataset == "synthetic" else _export_real(args)
    out_file = os.path.join(args.output, "annotations.json")
    with open(out_file, "w") as f:
        json.dump(data, f)
    print(json.dumps({"out": out_file, "images": len(data["images"]),
                      "annotations": len(data["annotations"]),
                      "categories": len(data["categories"])}))
    return data


if __name__ == "__main__":
    main()
