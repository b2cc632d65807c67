"""Demo: single-frame PoseCNN on a directory of demo frames (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/demo.py:26-167` (the reference's
tools/demo.py): each `<idx>-color.png` (with `<idx>-depth.png`, depth in
units of 1e-4 m) of `--images` through the flagship forward in
single-instance mode (`vote_threshold` −1, 16 RoIs an image, c2f Hough on
the card's vote kernels), per-class NMS at 0.5, detections (rotation from
the RoI's class quaternion, translation from Hough), and with `--refine`
ICP against the frame's depth, every detection of a frame in one batch.
On the card the forward with its per-class NMS (the scan on the device,
`nms_scan_kernel`), and ICP, run compiled (`utils/graph.compile_static`:
one CUDA graph per input signature, as the JAX demo jits its forward and
`nms_per_class` at (1, H, W)); `--device cpu` runs them eagerly.
It writes `<idx>-label.npy`, `<idx>-overlay.png` (the label tint and each
detection's projected 3D box) and `detections.json` (per frame its
forward seconds and each detection's class, pose and, refined, its
network pose as `quat_wxyz_init` / `trans_init`, keyed by detection
index):

    python -m posecnn_torch.cli.demo --images data/demo_images --ckpt <snapshot.npz> \\
        --output output/demo --refine

    # on the CPU
    python -m posecnn_torch.cli.demo --device cpu --images <dir> --refine --set train.fc_dim=64

The class geometry is YCB-Video's models where `<images>/../LOV/models`
exists, else the procedural library (`--num_points` a class). Without
`--ckpt` the weights are seeded random ones (a pipeline check).
"""

from __future__ import annotations

import json
import os
import time
from functools import partial

import numpy as np
import torch

from posecnn_torch.cli.common import (
    base_parser,
    forward_with_nms,
    head_flags_from_ckpt,
    load_config,
    setup_device,
)
from posecnn_torch.core.checkpoint import restore_for_eval
from posecnn_torch.data.datasets import YCB_CLASS_COLORS, DemoDataset, YCBVideoDataset
from posecnn_torch.data.minibatch import build_meta_blob
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.engine.evaluate import extract_detections
from posecnn_torch.models.posecnn import PoseCNN, init_weights
from posecnn_torch.refine.icp import icp_refine_batch
from posecnn_torch.utils.graph import compile_static
from posecnn_torch.utils.visualize import draw_detections, overlay_label, save_image


def make_parser():
    p = base_parser("PoseCNN demo on demo frames (PyTorch/CUDA)")
    p.add_argument("--images", default="data/demo_images",
                   help="directory of <idx>-color.png (and <idx>-depth.png) frames")
    p.add_argument("--ckpt", default=None, help="weights in the JAX .npz layout")
    p.add_argument("--output", default="output/demo")
    p.add_argument("--num_points", type=int, default=512)
    p.add_argument("--refine", action="store_true", help="ICP against the frame's depth")
    p.add_argument("--max_frames", type=int, default=0)
    return p


def demo_geometry(images: str, num_classes: int, num_points: int):
    """(points (C, P, 3), extents (C, 3)): YCB-Video's models beside the
    demo frames when present, else the procedural library."""
    lov_root = os.path.join(os.path.dirname(images.rstrip("/")), "LOV")
    if os.path.exists(os.path.join(lov_root, "models")):
        lov = YCBVideoDataset(lov_root, "debug", num_points=num_points)
        return lov.points, lov.extents
    proc = synthetic_class_library(num_classes, num_points)
    return proc.points, proc.extents


def main(argv=None) -> list:
    args = make_parser().parse_args(argv)
    cfg = load_config(args)
    device = setup_device(args.device)
    ds = DemoDataset(args.images)
    c = ds.num_classes
    points, extents = demo_geometry(args.images, c, args.num_points)
    model = PoseCNN(
        c, num_units=cfg.train.num_units, fc_dim=cfg.train.fc_dim,
        **head_flags_from_ckpt(cfg, args.ckpt),
        # bf16 compute on the card (cfg.compute_dtype); fp32 on the CPU
        compute_dtype=getattr(torch, cfg.compute_dtype) if device.type == "cuda"
        else torch.float32,
        hough_num_samples=cfg.test.hough_num_samples, max_objects=16,
        vote_threshold=-1.0,  # single instance, as the reference demo
    )
    # every head; a switched model's checkpoint keeps the seeded values of
    # the heads it lacks (core/checkpoint.restore_for_eval)
    init_weights(model, cfg.rng_seed)
    if args.ckpt:
        print(f"restored checkpoint at step {restore_for_eval(args.ckpt, model)}")
    model = model.to(device).eval()
    k = ds.intrinsic_matrix
    meta = torch.from_numpy(build_meta_blob(k)[None]).to(device)
    extents_t = torch.from_numpy(np.asarray(extents, np.float32)).to(device)
    points_t = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    pixel_means = np.asarray(cfg.pixel_means, np.float32)
    # the forward with its NMS, and ICP, each one CUDA graph per input
    # signature on the card; outputs live until their next call
    forward = compile_static(partial(forward_with_nms, model, nms_threshold=0.5))
    refine = compile_static(icp_refine_batch)

    os.makedirs(args.output, exist_ok=True)
    results = []
    frames = ds.image_index[: args.max_frames] if args.max_frames else ds.image_index
    for idx in frames:
        frame = ds.load_frame(idx)
        # BGR, mean-subtracted (the reference's _get_image_blob)
        blob = frame["color"][:, :, :3].astype(np.float32)[:, :, ::-1] - pixel_means
        data = torch.from_numpy(np.ascontiguousarray(blob[None])).to(device)
        t0 = time.perf_counter()
        out, keep = forward(data, extents_t, meta)
        label = out.label_2d[0].cpu().numpy()
        dt = time.perf_counter() - t0  # ends in the label's fetch
        dets = extract_detections(out.hough.rois.cpu().numpy(),
                                  out.hough.poses_init.cpu().numpy(),
                                  out.poses_pred.cpu().numpy(), keep.cpu().numpy(), c)
        init_poses = {}  # detection index → the network's pose
        if args.refine and dets and "depth" in frame:
            cls = torch.tensor([d[0] for d in dets], device=device)
            res = refine(
                torch.from_numpy(np.stack([d[1] for d in dets]).astype(np.float32)).to(device),
                torch.from_numpy(np.stack([d[2] for d in dets]).astype(np.float32)).to(device),
                points_t[cls], torch.from_numpy(frame["depth"]).to(device),
                out.label_2d[0][None] == cls[:, None, None], torch.from_numpy(k).to(device))
            quats, transs = res.quat.cpu().numpy(), res.trans.cpu().numpy()
            for i, (_, q, t) in enumerate(dets):
                init_poses[i] = (np.asarray(q).tolist(), np.asarray(t).tolist())
            dets = [(cl, quats[i], transs[i]) for i, (cl, _, _) in enumerate(dets)]

        np.save(os.path.join(args.output, f"{idx}-label.npy"), label)
        vis = overlay_label(frame["color"][:, :, :3], label, YCB_CLASS_COLORS)
        vis = draw_detections(vis, dets, extents, k, class_colors=YCB_CLASS_COLORS,
                              class_names=ds.classes)
        save_image(os.path.join(args.output, f"{idx}-overlay.png"), vis)
        det_json = [
            {"class": int(cl), "class_name": ds.classes[int(cl)],
             "quat_wxyz": np.asarray(q).tolist(), "trans": np.asarray(t).tolist(),
             **({"quat_wxyz_init": init_poses[i][0], "trans_init": init_poses[i][1]}
                if i in init_poses else {})}
            for i, (cl, q, t) in enumerate(dets)
        ]
        results.append({"frame": idx, "seconds": dt, "detections": det_json})
        print(f"{idx}: {len(dets)} detections, {dt * 1000:.1f} ms")

    with open(os.path.join(args.output, "detections.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output}/detections.json")
    return results


if __name__ == "__main__":
    main()
