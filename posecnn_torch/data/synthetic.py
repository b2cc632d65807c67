"""Synthetic scene generator (host side, numpy; no OpenGL).

The port's copy of `SyntheticSceneGenerator` in
`posecnn_tpu/data/synthetic.py:42-477`, carried because `posecnn_tpu.data`
imports jax. A point-based software renderer over class point clouds:
each object's points are posed, projected with the intrinsics and
splatted with a z-buffer, giving the label map, depth, vertex targets,
meta and pose blobs of one training frame.

Pose sampling: uniform (random unit quaternion, translation uniform in
the frustum between `t_near` and `t_far`) or from a per-class pose bank
with ±0.2 quaternion / ±0.1 m jitter; both with the minimum centre
separation by rejection. Same seed, same arrays as the original
(`tests/test_torch_synthetic.py`). The splats and the dense vertex
targets run in the C++ loops of `data/native.py`, as the JAX package's
do; `native=False` runs the original's numpy paths instead (the plain
version: the same splats bit for bit, the vertex targets within fp32
rounding).

`pooled_minibatch` is the training feed's replay pool (`:405-445`):
`fresh` new renders per call, the batch drawn from a rolling pool of
recent scenes, with σ = 8 gaussian noise per draw.

`SyntheticSequenceGenerator` (`:479-547`) is the video family's feed:
one scene a sequence, re-rendered from a camera that moves a little each
frame, with pose_world2live / live2world in meta[18:42] for the state
warp. It draws from the scene generator's `rng` in the original's order,
so its frames are the original's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from posecnn_torch.data.minibatch import build_meta_blob, build_pose_blob, generate_vertex_targets
from posecnn_torch.data.native import splat_points_native, splat_points_rgb_native
from posecnn_torch.utils.quaternion import axis_angle_to_quat_np, quat_mul_np, quat_to_mat_np


class SyntheticSample(NamedTuple):
    image: np.ndarray  # (H, W, 3) float32, mean-subtracted BGR
    label: np.ndarray  # (H, W) int32
    depth: np.ndarray  # (H, W) float32, metres (0 = empty)
    vertex_targets: Optional[np.ndarray]  # (H, W, 3C); None in sparse mode
    vertex_weights: Optional[np.ndarray]  # (H, W, 3C); None in sparse mode
    poses: np.ndarray  # (N, 13)
    meta: np.ndarray  # (48,)
    # sparse vertex-target inputs: per-class centre and log depth
    vertex_centers: Optional[np.ndarray] = None  # (C, 2)
    vertex_logz: Optional[np.ndarray] = None  # (C,)
    vertex_valid: Optional[np.ndarray] = None  # (C,) bool


class SyntheticSceneGenerator:
    """Renders random multi-object scenes from class point clouds."""

    def __init__(
        self,
        points: np.ndarray,  # (C, P, 3) class point clouds (row 0 unused)
        extents: np.ndarray,  # (C, 3)
        intrinsics: np.ndarray,  # (3, 3)
        width: int = 640,
        height: int = 480,
        t_near: float = 0.5,
        t_far: float = 2.0,
        min_objects: int = 3,
        max_objects: int = 5,
        pixel_means: Sequence[float] = (102.9801, 115.9465, 122.7717),
        class_colors: Optional[np.ndarray] = None,
        splat_radius: int = 2,
        seed: int = 0,
        class_whitelist: Optional[Sequence[int]] = None,
        sample_object: bool = True,
        sample_pose: bool = False,
        pose_bank: Optional[Sequence[Optional[np.ndarray]]] = None,
        min_separation: float = 0.2,
        point_colors: Optional[np.ndarray] = None,  # (C, P, 3) RGB 0-255
        point_normals: Optional[np.ndarray] = None,  # (C, P, 3) unit
        backgrounds: Optional[np.ndarray] = None,  # (N, H, W, 3) BGR 0-255
        background_prob: float = 0.8,
        native: bool = True,  # the C++ loops of data/native.py; False: numpy
    ):
        self.points = points.astype(np.float32)
        self.extents = extents.astype(np.float32)
        self.k = intrinsics.astype(np.float32)
        self.width = width
        self.height = height
        self.t_near = t_near
        self.t_far = t_far
        self.min_objects = min_objects
        self.max_objects = max_objects
        self.pixel_means = np.asarray(pixel_means, np.float32)
        self.num_classes = points.shape[0]
        self.splat_radius = splat_radius
        # the classes that may be rendered (all foreground by default)
        self.class_whitelist = (
            np.asarray(sorted(class_whitelist), np.int64)
            if class_whitelist is not None
            else np.arange(1, points.shape[0])
        )
        # True: a random subset of the whitelist per frame; False: all of it
        self.sample_object = sample_object
        self.sample_pose = sample_pose
        self.pose_bank = pose_bank
        if sample_pose and pose_bank is None:
            raise ValueError("sample_pose=True requires a pose_bank")
        self.min_separation = min_separation
        self.rng = np.random.RandomState(seed)
        if class_colors is None:
            class_colors = self.make_class_colors(self.num_classes)
        self.class_colors = class_colors
        # per-point texture + normals: rotation-dependent appearance
        # (texture × Lambertian shade) instead of a flat class colour
        self.point_colors = point_colors.astype(np.float32) if point_colors is not None else None
        self.point_normals = (
            point_normals.astype(np.float32) if point_normals is not None else None
        )
        self.backgrounds = backgrounds
        self.background_prob = background_prob
        self.native = native

    @staticmethod
    def make_class_colors(num_classes: int) -> np.ndarray:
        """Distinct per-class colours from a deterministic hash palette."""
        cc = np.zeros((num_classes, 3), np.float32)
        for c in range(1, num_classes):
            cc[c] = [(c * 53) % 256, (c * 101) % 256, (c * 197) % 256]
        return cc

    def _sample_pose(self, cls: int = 0, prev_trans=()):
        """One pose draw in the configured mode, redrawn (at most 30
        times) until it keeps `min_separation` from `prev_trans`."""
        bank = None
        if self.sample_pose and self.pose_bank is not None:
            bank = self.pose_bank[cls] if cls < len(self.pose_bank) else None
            if bank is not None and len(bank) == 0:
                bank = None
        for _ in range(30):
            if bank is not None:
                row = bank[self.rng.randint(len(bank))]
                q = row[:4] + self.rng.uniform(-0.2, 0.2, 4)
                q /= np.linalg.norm(q) + 1e-12
                t = (row[4:7] + self.rng.uniform(-0.1, 0.1, 3)).astype(np.float32)
            else:
                q = self.rng.randn(4)
                q /= np.linalg.norm(q)
                z = self.rng.uniform(self.t_near, self.t_far)
                # keep the centre inside the image with a margin
                fx, fy = self.k[0, 0], self.k[1, 1]
                px, py = self.k[0, 2], self.k[1, 2]
                margin = 0.15
                u = self.rng.uniform(margin * self.width, (1 - margin) * self.width)
                v = self.rng.uniform(margin * self.height, (1 - margin) * self.height)
                t = np.array([(u - px) / fx * z, (v - py) / fy * z, z], np.float32)
            if all(np.linalg.norm(t - p) >= self.min_separation for p in prev_trans):
                break
        return q.astype(np.float32), t

    def _scene_light(self) -> np.ndarray:
        """Per-scene random light direction (camera frame, unit)."""
        light = self.rng.randn(3).astype(np.float32)
        light[2] = -abs(light[2])  # from the camera half-space toward the scene
        return light / (np.linalg.norm(light) + 1e-12)

    def _splat_object(self, c, rot, t, depth, label, image, light):
        """Project one posed object and z-buffer-splat it into the buffers.

        Textured (point_colors set): per-point RGB = texture × Lambertian
        shade of the rotated normals; among the points within 1 cm of a
        pixel's nearest depth, the nearest one colours it. Otherwise the
        class colour × a depth shade, nearest point wins."""
        fx, fy = self.k[0, 0], self.k[1, 1]
        px, py = self.k[0, 2], self.k[1, 2]
        r = self.splat_radius
        if self.point_colors is not None:
            # widen the splat to the projected point spacing (estimated
            # from the box surface area) so close objects show no gaps
            ext = self.extents[c]
            area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
            spacing_m = float(np.sqrt(max(area, 1e-8) / self.points.shape[1]))
            spacing_px = spacing_m * float(fx) / max(float(t[2]), 1e-3)
            r = int(np.clip(round(1.0 * spacing_px), self.splat_radius, 7))
        pts = self.points[c] @ rot.T + t
        z = pts[:, 2]
        ok = z > 1e-3
        u = np.round(fx * pts[ok, 0] / z[ok] + px).astype(np.int64)
        v = np.round(fy * pts[ok, 1] / z[ok] + py).astype(np.int64)
        zok = z[ok].astype(np.float32)
        if self.point_colors is not None:
            n_cam = (self.point_normals[c] @ rot.T)[ok]
            shade = 0.55 + 0.45 * np.clip(n_cam @ light, 0.0, 1.0)
            rgb = np.clip(self.point_colors[c][ok] * shade[:, None], 0.0, 255.0).astype(np.float32)
            if self.native:
                splat_points_rgb_native(u, v, zok, rgb, c, r, depth, label, image)
            else:
                self._splat_rgb_numpy(c, u, v, zok, rgb, r, depth, label, image)
        elif self.native:
            splat_points_native(u, v, zok, c, r, self.class_colors[c], self.t_far, depth, label,
                                image)
        else:
            self._splat_numpy(c, u, v, zok, r, depth, label, image)

    @staticmethod
    def _offsets(u, v, zok, r, h, w, *extra):
        """Per splat offset (du, dv): the in-bounds pixels of the points, far
        to near, and among points at one depth the later point first, so
        that a last write leaves the nearest point, first in point order."""
        index = np.arange(len(zok))
        for dv in range(-r, r + 1):
            for du in range(-r, r + 1):
                uu, vv = u + du, v + dv
                inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                srt = np.lexsort((-index[inb], -zok[inb]))
                yield tuple(a[inb][srt] for a in (uu, vv, zok, *extra))

    def _splat_rgb_numpy(self, c, u, v, zok, rgb, r, depth, label, image):
        """The numpy two-pass visibility splat (`splat_points_rgb`): pass 1
        the nearest depth per pixel; pass 2 colours each pixel with the
        nearest point within 1 cm of it and, among points at that depth,
        the first in point order, as the C++ loop does. (The JAX package's
        numpy fallback breaks such ties by offset order instead, so its two
        paths can differ on a pixel where two points meet at one depth.)"""
        h, w = depth.shape
        for ui, vi, zi in self._offsets(u, v, zok, r, h, w):
            closer = zi < depth[vi, ui]
            depth[vi[closer], ui[closer]] = zi[closer]
        eps = 0.01
        color_z = np.full_like(depth, 1e30)
        color_i = np.full(depth.shape, len(zok), np.int64)
        for ui, vi, zi, ci, ii in self._offsets(u, v, zok, r, h, w, rgb, np.arange(len(zok))):
            cz = color_z[vi, ui]
            ok2 = (zi <= depth[vi, ui] + eps) & ((zi < cz) | ((zi == cz) & (ii < color_i[vi, ui])))
            ui, vi, zi, ci, ii = ui[ok2], vi[ok2], zi[ok2], ci[ok2], ii[ok2]
            color_z[vi, ui] = zi
            color_i[vi, ui] = ii
            label[vi, ui] = c
            image[vi, ui] = ci

    def _splat_numpy(self, c, u, v, zok, r, depth, label, image):
        """The numpy class-colour splat (`splat_points`): z-buffer by
        sorted last-write-wins, far to near."""
        h, w = depth.shape
        for ui, vi, zi in self._offsets(u, v, zok, r, h, w):
            closer = zi < depth[vi, ui]
            ui, vi, zi = ui[closer], vi[closer], zi[closer]
            depth[vi, ui] = zi
            label[vi, ui] = c
            shade = np.clip(1.6 - zi / self.t_far, 0.4, 1.3)[:, None]
            image[vi, ui] = self.class_colors[c][None, :] * shade

    def _fill_background(self, label, image):
        """Paint label-0 pixels: a crop of a pool image with probability
        `background_prob`, else uniform noise."""
        bg = label == 0
        if (
            self.backgrounds is not None
            and len(self.backgrounds)
            and self.rng.rand() < self.background_prob
        ):
            bgim = self.backgrounds[self.rng.randint(len(self.backgrounds))]
            h, w = label.shape
            if bgim.shape[0] >= h and bgim.shape[1] >= w:
                oy = self.rng.randint(bgim.shape[0] - h + 1)
                ox = self.rng.randint(bgim.shape[1] - w + 1)
                crop = bgim[oy : oy + h, ox : ox + w]
            else:  # pool image smaller than the frame: tile it
                ry = -(-h // bgim.shape[0])
                rx = -(-w // bgim.shape[1])
                crop = np.tile(bgim, (ry, rx, 1))[:h, :w]
            gain = self.rng.uniform(0.6, 1.1)
            image[bg] = crop[bg] * gain
        else:
            image[bg] = self.rng.uniform(0, 60, size=(int(bg.sum()), 3))

    def render(self, dense_vertex_targets: bool = True) -> SyntheticSample:
        h, w = self.height, self.width
        n_obj = self.rng.randint(self.min_objects, self.max_objects + 1)
        if self.sample_object:
            classes = self.rng.choice(
                self.class_whitelist, size=min(n_obj, len(self.class_whitelist)), replace=False
            )
        else:
            classes = self.class_whitelist[: max(self.max_objects, 1)]
        depth = np.full((h, w), np.inf, np.float32)
        label = np.zeros((h, w), np.int32)
        image = np.zeros((h, w, 3), np.float32)

        quats, trans, centers, zs, used = [], [], [], [], []
        fx, fy = self.k[0, 0], self.k[1, 1]
        px, py = self.k[0, 2], self.k[1, 2]
        light = self._scene_light()
        for c in classes:
            q, t = self._sample_pose(int(c), trans)
            self._splat_object(int(c), quat_to_mat_np(q), t, depth, label, image, light)
            quats.append(q)
            trans.append(t)
            centers.append([fx * t[0] / t[2] + px, fy * t[1] / t[2] + py])
            zs.append(t[2])
            used.append(c)

        depth[np.isinf(depth)] = 0.0
        self._fill_background(label, image)

        used = np.asarray(used, np.int64)
        centers = np.asarray(centers, np.float32)
        zs = np.asarray(zs, np.float32)
        if dense_vertex_targets:
            targets, weights = generate_vertex_targets(label, used, centers, zs, self.num_classes,
                                                       native=self.native)
        else:
            targets = weights = None
        v_centers = np.zeros((self.num_classes, 2), np.float32)
        v_logz = np.zeros((self.num_classes,), np.float32)
        v_valid = np.zeros((self.num_classes,), bool)
        for i, cc in enumerate(used):
            v_centers[cc] = centers[i]
            v_logz[cc] = np.log(max(float(zs[i]), 1e-6))
            v_valid[cc] = True
        poses = build_pose_blob(
            0, used, np.asarray(quats, np.float32), np.asarray(trans, np.float32), centers
        )
        return SyntheticSample(
            image=image - self.pixel_means, label=label, depth=depth,
            vertex_targets=targets, vertex_weights=weights, poses=poses,
            meta=build_meta_blob(self.k), vertex_centers=v_centers, vertex_logz=v_logz,
            vertex_valid=v_valid,
        )

    def minibatch(self, batch_size: int, max_gt: int = 16, dense_vertex_targets: bool = True):
        """A stacked batch of fresh frames with the GT rows padded to
        `max_gt`. With dense_vertex_targets=False it carries the per-class
        vertex_centers / vertex_logz / vertex_valid instead of the
        (H, W, 3C) maps."""
        samples = [self.render(dense_vertex_targets=dense_vertex_targets)
                   for _ in range(batch_size)]
        return self._collate(samples, max_gt, dense_vertex_targets)

    def pooled_minibatch(self, batch_size: int, max_gt: int = 16,
                         dense_vertex_targets: bool = True, pool_size: int = 512,
                         fresh: int = 2):
        """A batch drawn from a rolling pool of recent scenes: the first
        call renders `batch_size` scenes, each later call `fresh` new ones;
        the pool keeps the newest `pool_size`. Per-draw gaussian noise
        (σ = 8) decorrelates the repeated scenes."""
        if not hasattr(self, "_pool"):
            self._pool: list = []
        n_new = fresh if self._pool else batch_size
        for _ in range(n_new):
            self._pool.append(self.render(dense_vertex_targets=dense_vertex_targets))
        if len(self._pool) > pool_size:
            del self._pool[: len(self._pool) - pool_size]
        idx = self.rng.randint(0, len(self._pool), batch_size)
        batch = self._collate([self._pool[i] for i in idx], max_gt, dense_vertex_targets)
        batch["data"] = batch["data"] + self.rng.randn(
            *batch["data"].shape).astype(np.float32) * 8.0
        return batch

    @staticmethod
    def _collate(samples, max_gt: int, dense_vertex_targets: bool):
        batch = {
            "data": np.stack([s.image for s in samples]),
            "label": np.stack([s.label for s in samples]),
            "depth": np.stack([s.depth for s in samples]),
            "meta": np.stack([s.meta for s in samples]),
        }
        if dense_vertex_targets:
            batch["vertex_targets"] = np.stack([s.vertex_targets for s in samples])
            batch["vertex_weights"] = np.stack([s.vertex_weights for s in samples])
        else:
            batch["vertex_centers"] = np.stack([s.vertex_centers for s in samples])
            batch["vertex_logz"] = np.stack([s.vertex_logz for s in samples])
            batch["vertex_valid"] = np.stack([s.vertex_valid for s in samples])
        gt = np.zeros((max_gt, 13), np.float32)
        gt_valid = np.zeros((max_gt,), bool)
        row = 0
        for i, s in enumerate(samples):
            for j in range(s.poses.shape[0]):
                if row >= max_gt:
                    break
                gt[row] = s.poses[j]
                gt[row, 0] = i
                gt_valid[row] = True
                row += 1
        batch["gt_poses"] = gt
        batch["gt_valid"] = gt_valid
        return batch


class SyntheticSequenceGenerator:
    """Multi-frame sequences with camera motion (ref: GtDataLayer's
    NUM_STEPS-frame minibatches, minibatch.py:20-310). Objects stay fixed
    in the world; per frame the camera turns by up to `cam_step_r` rad
    about a random axis and moves by up to `cam_step_t` m per axis."""

    def __init__(self, scene_gen: SyntheticSceneGenerator, num_steps: int = 5,
                 cam_step_t: float = 0.01, cam_step_r: float = 0.02):
        self.gen = scene_gen
        self.num_steps = num_steps
        self.cam_step_t = cam_step_t
        self.cam_step_r = cam_step_r

    def views(self):
        """One sequence's scene: its first render (a `SyntheticSample`; the
        frame-0 camera is the world frame) and, for each later frame,
        (r (3, 3), t (3,), image, label, depth): the camera's world→live
        rotation and translation and the render from there."""
        g = self.gen
        rng = g.rng
        base = g.render(dense_vertex_targets=False)
        cam_q = np.array([1.0, 0, 0, 0], np.float32)
        cam_t = np.zeros(3, np.float32)
        later = []
        for _ in range(1, self.num_steps):
            axis = rng.randn(3).astype(np.float32)
            dq = axis_angle_to_quat_np(
                axis, np.float32(rng.uniform(-self.cam_step_r, self.cam_step_r)))
            cam_q = quat_mul_np(dq, cam_q)
            cam_t = cam_t + rng.uniform(-self.cam_step_t, self.cam_step_t, 3).astype(np.float32)
            r = quat_to_mat_np(cam_q)
            # the same objects from the new camera, through the shared splat
            depth = np.full((g.height, g.width), np.inf, np.float32)
            label = np.zeros((g.height, g.width), np.int32)
            image = np.zeros((g.height, g.width, 3), np.float32)
            light = g._scene_light()
            for pose in base.poses:
                g._splat_object(int(pose[1]), r @ quat_to_mat_np(pose[6:10]),
                                r @ pose[10:13] + cam_t, depth, label, image, light)
            depth[np.isinf(depth)] = 0.0
            g._fill_background(label, image)
            later.append((r, cam_t, image - g.pixel_means, label, depth))
        return base, later

    def render_sequence(self) -> dict:
        """(T, H, W, …) image, label, depth and (T, 48) meta of one sequence,
        with pose_world2live / live2world in each later frame's meta."""
        base, later = self.views()
        frames = {"image": [base.image], "label": [base.label], "depth": [base.depth],
                  "meta": [base.meta]}
        for r, cam_t, image, label, depth in later:
            w2l = np.concatenate([r, cam_t[:, None]], 1).astype(np.float32)
            l2w = np.concatenate([r.T, (-r.T @ cam_t)[:, None]], 1).astype(np.float32)
            frames["image"].append(image)
            frames["label"].append(label)
            frames["depth"].append(depth)
            frames["meta"].append(build_meta_blob(self.gen.k, w2l, l2w))
        return {k: np.stack(v) for k, v in frames.items()}

    def minibatch(self, batch_size: int) -> dict:
        """(T, B, …) stacked sequences."""
        seqs = [self.render_sequence() for _ in range(batch_size)]
        return {k: np.stack([s[k] for s in seqs], axis=1) for k in seqs[0]}
