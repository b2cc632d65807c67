"""Dataset trees in the reference's on-disk formats, from rendered scenes.

`write_ycb_tree` writes a YCB-Video / LOV tree that `data/datasets.py`
reads: `models/<cls>/points.xyz` (the procedural library's clouds),
`extents.txt`, the image sets `<root>/<set>.txt` (where
`YCBVideoDataset` reads them) and, per frame, `data/<index>-color.png`
(RGB), `-depth.png` (uint16, metres × factor_depth), `-label.png` (uint8)
and `-meta.mat` (poses (3, 4, N), cls_indexes (N, 1), center (N, 2),
intrinsic_matrix, factor_depth), each frame rendered by
`SyntheticSceneGenerator` with YCB-Video's camera; and a pose bank under
`poses/`. Frames are indexed `<video>/<frame>`, `video_length` frames a
video. With `moving_camera`, each video is one scene seen from a camera
that moves a little each frame (`SyntheticSequenceGenerator.views`), and
each frame's `-meta.mat` also holds its world→camera
`rotation_translation_matrix` (3, 4), the world being the video's first
camera, which the video feed reads. `write_scene_tree` writes a
scene-segmentation tree (`SceneSegDataset`'s layout: image sets and
`data/<index>-{color,depth,label}.png`, no models). `write_linemod_tree` writes the LINEMOD files the readers use
without frames: `extents.txt` and `indexes/<cls>_<set>.txt`.
`write_demo_frames` writes frames in the demo's format (`<idx>-color.png`,
`<idx>-depth.png`), seen through the demo's camera.

They stand in for the real datasets wherever those are absent: the
loaders, `train_net` and `test_net` run on them as on the real trees.
"""

from __future__ import annotations

import os

import numpy as np

from posecnn_torch.data.datasets import LINEMOD_CLASSES, YCB_CLASSES, YCB_K, DemoDataset
from posecnn_torch.data.procedural import make_procedural_objects, synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.utils.quaternion import mat_to_quat_np, quat_to_mat_np

FACTOR_DEPTH = 10000.0  # YCB-Video's depth scale


def write_ycb_tree(root: str, *, sets=(("train", 8), ("val", 4)), height: int = 480,
                   width: int = 640, num_points: int = 2620, seed: int = 0, k=YCB_K,
                   video_length: int = 1000, moving_camera: bool = False) -> dict:
    """Write the tree (YCB-Video's 22 classes, frames of `height` × `width`
    seen through `k`); returns {set name: [frame index, …]}."""
    import scipy.io
    from PIL import Image

    k = np.asarray(k, np.float32)
    num_classes = len(YCB_CLASSES)
    lib = make_procedural_objects(num_classes, num_points, seed=seed)
    for c in range(1, num_classes):
        os.makedirs(os.path.join(root, "models", YCB_CLASSES[c]), exist_ok=True)
        np.savetxt(os.path.join(root, "models", YCB_CLASSES[c], "points.xyz"), lib.points[c],
                   fmt="%.6f")
    np.savetxt(os.path.join(root, "extents.txt"), lib.extents[1:], fmt="%.6f")
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=width, height=height,
                                  pixel_means=np.zeros(3, np.float32), seed=seed + 1,
                                  point_colors=lib.colors, point_normals=lib.normals)
    # the pose bank of train.syn_sample_pose: rows [qw qx qy qz tx ty tz]
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    bank_rng = np.random.RandomState(seed + 2)
    for c in range(1, num_classes):
        q = bank_rng.randn(16, 4)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = np.stack([bank_rng.uniform(-0.1, 0.1, 16), bank_rng.uniform(-0.1, 0.1, 16),
                      bank_rng.uniform(0.6, 1.2, 16)], 1)
        np.savetxt(os.path.join(root, "poses", f"{YCB_CLASSES[c]}.txt"),
                   np.concatenate([q, t], 1), fmt="%.6f")
    videos = SyntheticSequenceGenerator(gen, num_steps=video_length)
    indexes = {}
    frame = 0
    for name, count in sets:
        indexes[name] = []
        for _ in range(count):
            index = f"{frame // video_length:04d}/{frame % video_length + 1:06d}"
            prefix = os.path.join(root, "data", index)
            os.makedirs(os.path.dirname(prefix), exist_ok=True)
            extra = {}
            if moving_camera:
                if frame % video_length == 0:
                    base, later = videos.views()
                    views = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), base.image,
                              base.label, base.depth)] + later
                r, cam_t, image, label, depth = views[frame % video_length]
                poses = base.poses.copy()
                for row in poses:
                    row[6:10] = mat_to_quat_np(r @ quat_to_mat_np(row[6:10]))
                    row[10:13] = r @ row[10:13] + cam_t
                    row[2:4] = (k @ (row[10:13] / row[12]))[:2]
                extra["rotation_translation_matrix"] = np.concatenate(
                    [r, cam_t[:, None]], 1).astype(np.float64)
            else:
                s = gen.render(dense_vertex_targets=False)
                image, label, depth, poses = s.image, s.label, s.depth, s.poses
            _write_rgbd(prefix, image, depth)
            Image.fromarray(label.astype(np.uint8)).save(prefix + "-label.png")
            mats = np.stack([np.concatenate([quat_to_mat_np(row[6:10]), row[10:13, None]], 1)
                             for row in poses], axis=2)
            scipy.io.savemat(prefix + "-meta.mat", {
                "poses": mats.astype(np.float64),
                "cls_indexes": poses[:, 1:2].astype(np.float64),
                "center": poses[:, 2:4].astype(np.float64),
                "intrinsic_matrix": np.asarray(k, np.float64),
                "factor_depth": np.array([[FACTOR_DEPTH]]),
                **extra,
            })
            indexes[name].append(index)
            frame += 1
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(indexes[name]) + "\n")
    return indexes


def write_scene_tree(root: str, num_classes: int, *, sets=(("train", 4), ("val", 2)),
                     height: int = 480, width: int = 640, num_points: int = 512,
                     seed: int = 0) -> dict:
    """A scene-segmentation tree: `<root>/<set>.txt` and, per frame,
    `data/<index>-color.png`, `-depth.png` and `-label.png`, renders of the
    procedural library of `num_classes` classes (500 px focal length);
    returns {set name: [frame index, …]}."""
    from PIL import Image

    lib = synthetic_class_library(num_classes, num_points)
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=width, height=height,
                                  pixel_means=np.zeros(3, np.float32), seed=seed,
                                  point_colors=lib.colors, point_normals=lib.normals)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    indexes, frame = {}, 0
    for name, count in sets:
        indexes[name] = []
        for _ in range(count):
            index = f"{frame:06d}"
            s = gen.render(dense_vertex_targets=False)
            _write_rgbd(os.path.join(root, "data", index), s.image, s.depth)
            Image.fromarray(s.label.astype(np.uint8)).save(
                os.path.join(root, "data", index + "-label.png"))
            indexes[name].append(index)
            frame += 1
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(indexes[name]) + "\n")
    return indexes


def _write_rgbd(prefix: str, image: np.ndarray, depth: np.ndarray) -> None:
    """`<prefix>-color.png` (RGB of a render's BGR image) and `-depth.png`
    (uint16, metres × FACTOR_DEPTH, 0 where nothing was drawn)."""
    from PIL import Image

    bgr = np.clip(np.rint(image), 0, 255).astype(np.uint8)
    Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(prefix + "-color.png")
    Image.fromarray(np.clip(np.rint(depth * FACTOR_DEPTH), 0, 65535).astype(
        np.uint16)).save(prefix + "-depth.png")


def write_demo_frames(root: str, count: int = 5, *, height: int = 480, width: int = 640,
                      num_points: int = 512, seed: int = 0) -> list:
    """`count` frames `000000`… in the demo's format under `root`, renders
    of the procedural library the demo falls back to (YCB-Video's 22
    classes, `num_points` a class) through the demo's camera; returns
    their indexes."""
    os.makedirs(root, exist_ok=True)
    lib = synthetic_class_library(len(YCB_CLASSES), num_points)
    k = DemoDataset(root).intrinsic_matrix
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=width, height=height,
                                  pixel_means=np.zeros(3, np.float32), seed=seed,
                                  point_colors=lib.colors, point_normals=lib.normals)
    indexes = [f"{i:06d}" for i in range(count)]
    for index in indexes:
        s = gen.render(dense_vertex_targets=False)
        _write_rgbd(os.path.join(root, index), s.image, s.depth)
    return indexes


def write_linemod_tree(root: str, cls: str = "ape", sets=("train", "test"), seed: int = 0,
                       with_model: bool = False, num_points: int = 2620) -> None:
    """LINEMOD's `extents.txt` (15 objects, random extents of 6-30 cm) and
    `indexes/<cls>_<set>.txt`; with `with_model`, `models/<cls>/points.xyz`
    for the one object (a procedural cloud scaled to its extents)."""
    rng = np.random.RandomState(seed)
    extents = rng.uniform(0.06, 0.3, (len(LINEMOD_CLASSES) - 1, 3))
    np.savetxt(os.path.join(root, "extents.txt"), extents, fmt="%.6f")
    os.makedirs(os.path.join(root, "indexes"), exist_ok=True)
    for name in sets:
        with open(os.path.join(root, "indexes", f"{cls}_{name}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in range(4)) + "\n")
    if with_model:
        ci = LINEMOD_CLASSES.index(cls)
        lib = make_procedural_objects(2, num_points, seed=seed)
        pts = lib.points[1] * (extents[ci - 1] / np.maximum(lib.extents[1], 1e-6))
        os.makedirs(os.path.join(root, "models", cls), exist_ok=True)
        np.savetxt(os.path.join(root, "models", cls, "points.xyz"), pts, fmt="%.6f")
