"""The KinectFusion check: TSDF fusion, raycast, tracking and surfaces (PyTorch/CUDA port).

Counterpart of `posecnn_tpu/cli/test_fusion.py` (ref:
tools/test_kinect_fusion.py), quantitative on one synthetic camera-motion
sequence with known ground truth:

  1. fuse the GT depth and GT label probabilities at the GT camera poses
     (`refine/fusion.fuse_frame`);
  2. raycast the volume from each pose: the depth error and the
     foreground label accuracy against the render (`raycast`);
  3. track each frame against the previous pose's raycast depth: the
     rotation and translation errors against the GT motion (`track_camera`);
  4. the labelled surface (`extract_surface`) and the marching-tetrahedra
     mesh (`extract_mesh`), written to `<output>/model.ply` (`save_mesh_ply`).

    python -m posecnn_torch.cli.test_fusion --output output/test_fusion [--grid_size 64]

Writes `<output>/fusion_report.json`; `--visualize` also writes each
frame's raycast label and depth images. On a card `fuse_frame`, `raycast`,
`track_camera` and `extract_mesh` run compiled (`utils/graph.compile_static`,
the counterpart of their `jax.jit`), one CUDA graph each, the volume bound
in place; each output is fetched before the program's next call.
`extract_surface` runs eagerly, as in JAX; with `--device cpu` all do.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from posecnn_torch.cli.common import base_parser, load_config, setup_device
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.refine.fusion import (
    create_volume,
    extract_mesh,
    extract_surface,
    fuse_frame,
    raycast,
    save_mesh_ply,
    track_camera,
)
from posecnn_torch.utils.graph import compile_static
from posecnn_torch.utils.visualize import label_to_color, save_image

EYE34 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)


def make_parser():
    p = base_parser("KinectFusion (TSDF fusion and tracking) check (PyTorch/CUDA)")
    p.add_argument("--output", default="output/test_fusion")
    p.add_argument("--num_steps", type=int, default=5)
    p.add_argument("--grid_size", type=int, default=64)
    p.add_argument("--visualize", action="store_true")
    return p


def cam_to_world(w2c: np.ndarray) -> np.ndarray:
    r = np.asarray(w2c[:, :3])
    return np.concatenate([r.T, (-r.T @ w2c[:, 3])[:, None]], 1).astype(np.float32)


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = setup_device(args.device)
    cfg = load_config(args)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    c = cfg.train.num_classes
    w, h = cfg.train.syn_width, cfg.train.syn_height
    # dense clouds: the fused surface is only as whole as the depth maps
    proc = synthetic_class_library(c, 2048)
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(proc.points, proc.extents, k, width=w, height=h,
                                  t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                  pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
                                  point_colors=proc.colors, point_normals=proc.normals)
    seq = SyntheticSequenceGenerator(gen, num_steps=args.num_steps).minibatch(1)
    kt = dev(k)

    # the scene spans about [t_near, t_far] along +z of frame 0's camera
    span = cfg.train.syn_tfar + 0.3
    vol = create_volume(args.grid_size, c, origin=(-span / 2, -span / 2, 0.2),
                        voxel_size=span / args.grid_size, device=device)
    fuse = compile_static(fuse_frame, inplace=("vol",))
    cast = compile_static(raycast, inplace=("vol",))
    track = compile_static(track_camera)
    mesh = compile_static(extract_mesh, inplace=("vol",))

    # 1. fuse every frame at its GT pose
    w2l_list = []
    for t in range(args.num_steps):
        w2l = EYE34 if t == 0 else seq["meta"][t, 0][18:30].reshape(3, 4).astype(np.float32)
        w2l_list.append(w2l)
        prob = F.one_hot(dev(seq["label"][t, 0]).long(), c).float()
        fuse(vol, dev(seq["depth"][t, 0]), prob, kt, dev(w2l))

    # 2. raycast from each pose against the GT depth and labels
    os.makedirs(args.output, exist_ok=True)
    depth_errs, label_accs = [], []
    for t in range(args.num_steps):
        d_pred, _, lab_pred = cast(vol, kt, dev(cam_to_world(w2l_list[t])), height=h, width=w,
                                   near=0.2, far=span + 0.2)
        d_pred, lab_pred = d_pred.cpu().numpy(), lab_pred.cpu().numpy()
        d_gt = seq["depth"][t, 0]
        both = (d_pred > 1e-6) & (d_gt > 1e-6)
        if both.sum():
            depth_errs.append(float(np.abs(d_pred - d_gt)[both].mean()))
        fg = (seq["label"][t, 0] > 0) & (d_pred > 1e-6)
        if fg.sum():
            label_accs.append(float((lab_pred[fg] == seq["label"][t, 0][fg]).mean()))
        if args.visualize:
            save_image(os.path.join(args.output, f"{t:03d}-raycast-label.png"),
                       label_to_color(lab_pred, gen.class_colors))
            dn = d_pred / max(d_pred.max(), 1e-6) * 255
            save_image(os.path.join(args.output, f"{t:03d}-raycast-depth.png"),
                       np.stack([dn] * 3, -1))

    # 3. frame-to-model tracking against the GT relative motion
    rot_errs, trans_errs = [], []
    for t in range(1, args.num_steps):
        model_depth, _, _ = cast(vol, kt, dev(cam_to_world(w2l_list[t - 1])), height=h,
                                 width=w, near=0.2, far=span + 0.2)
        rt = track(dev(seq["depth"][t, 0]), model_depth, kt, dev(EYE34),
                   num_iters=8).cpu().numpy()
        r_prev = w2l_list[t - 1][:, :3]
        rel_r = w2l_list[t][:, :3] @ r_prev.T  # cam_t ← world ← cam_{t−1}
        rel_t = w2l_list[t][:, 3] - rel_r @ w2l_list[t - 1][:, 3]
        cos = np.clip(0.5 * (np.trace(rt[:, :3].T @ rel_r) - 1), -1, 1)
        rot_errs.append(float(np.degrees(np.arccos(cos))))
        trans_errs.append(float(np.linalg.norm(rt[:, 3] - rel_t)))

    # 4. the labelled surface and the mesh
    _, labels_surf, valid = extract_surface(vol, max_points=16384)
    valid, labels_surf = valid.cpu().numpy(), labels_surf.cpu().numpy()
    tri_verts, tri_labels, tri_valid = mesh(vol, max_triangles=16384)
    tv = tri_verts.cpu().numpy()[tri_valid.cpu().numpy()]
    mesh_area = float(0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1).sum()) if len(tv) else 0.0
    n_faces = save_mesh_ply(os.path.join(args.output, "model.ply"), tri_verts, tri_labels,
                            tri_valid)

    summary = dict(
        num_steps=args.num_steps,
        ply_faces=n_faces,
        grid_size=args.grid_size,
        raycast_depth_mae_m=float(np.mean(depth_errs)) if depth_errs else None,
        raycast_fg_label_acc=float(np.mean(label_accs)) if label_accs else None,
        tracking_rot_err_deg=rot_errs,
        tracking_trans_err_m=trans_errs,
        surface_points=int(valid.sum()),
        surface_classes=sorted(int(x) for x in np.unique(labels_surf[valid])),
        mesh_triangles=int(len(tv)),
        mesh_area_m2=mesh_area,
    )
    with open(os.path.join(args.output, "fusion_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
