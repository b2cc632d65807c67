"""Minibatch blob construction: synthetic scenes and real dataset frames.

The port's numpy copy of `posecnn_tpu/data/minibatch.py` (carried because
`posecnn_tpu.data` imports jax):

  generate_vertex_targets — per labelled pixel of class c, channels
    [3c, 3c+1] = unit direction (centre − pixel), 3c+2 = log z; weights
    `vertex_w_inside` on the 3 channels of labelled pixels. Written by the
    C++ loop of `data/native.py`, as the JAX package's are; `native=False`
    runs the original's numpy path (fp64 directions rounded once to fp32,
    within 1e-6 of the loop's fp32 ones)
  build_meta_blob — 48 floats [K(9), K⁻¹(9), pose_world2live(12),
    pose_live2world(12), voxel step(3), voxel min(3)]
  build_pose_blob — (N, 13) rows [batch, cls, centre(2:4), …, quat(6:10), t(10:13)]
  build_image_blobs — one frame's network inputs per input mode (COLOR,
    DEPTH, RGBD's second tower, NORMAL), with chromatic jitter, noise and
    the horizontal flip
  get_real_minibatch — a training batch of dataset frames: rescale,
    crop/pad to the training size, mirrored copies, GT poses and the dense
    or sparse vertex-target form
  get_real_video_minibatch — the recurrent family's sequences of dataset
    frames: NUM_STEPS consecutive frames of one video each, the camera
    motion from each frame's rotation_translation_matrix, the voxel grid
    from the first frame's depth
  label_to_boxes — GT boxes from a label map

Augmentations draw from the caller's `RandomState` in the original's
order (chromatic, then noise on the colour, then noise on the depth), so
the same seed gives the same blobs bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from posecnn_torch.data.augment import add_noise, chromatic_transform
from posecnn_torch.data.native import vertex_targets_native


def generate_vertex_targets(im_label, cls_indexes, centers, zs, num_classes: int,
                            vertex_w_inside: float = 10.0, native: bool = True):
    """Vertex targets and weights of one image, (H, W, 3C) each. The
    first instance of a class claims the pixels labelled with it. `native`
    picks the C++ loop (per class: the first instance's centre, NaN for an
    absent class, and its log depth), else the numpy path."""
    h, w = im_label.shape
    targets = np.zeros((h, w, 3 * num_classes), np.float32)
    weights = np.zeros((h, w, 3 * num_classes), np.float32)
    ys, xs = np.nonzero(im_label > 0)
    if len(ys) == 0:
        return targets, weights
    if native:
        cls_centers = np.full((num_classes, 2), np.nan, np.float32)
        cls_logz = np.zeros((num_classes,), np.float32)
        for i, cc in enumerate(cls_indexes):
            ci = int(cc)
            if 0 < ci < num_classes and np.isnan(cls_centers[ci, 0]):
                cls_centers[ci] = centers[i]
                cls_logz[ci] = np.log(max(float(zs[i]), 1e-12))
        vertex_targets_native(im_label, cls_centers, cls_logz, float(vertex_w_inside),
                              num_classes, targets, weights)
        return targets, weights
    labels_at = im_label[ys, xs]
    # class id -> instance row (first instance of that class)
    cls_to_inst = -np.ones(num_classes, np.int64)
    for i, c in enumerate(cls_indexes):
        if cls_to_inst[int(c)] == -1:
            cls_to_inst[int(c)] = i
    inst = cls_to_inst[labels_at]
    ok = inst >= 0
    ys, xs, labels_at, inst = ys[ok], xs[ok], labels_at[ok], inst[ok]
    dx = centers[inst, 0] - xs
    dy = centers[inst, 1] - ys
    norm = np.sqrt(dx * dx + dy * dy) + 1e-10
    base = 3 * labels_at
    targets[ys, xs, base + 0] = dx / norm
    targets[ys, xs, base + 1] = dy / norm
    targets[ys, xs, base + 2] = np.log(zs[inst])
    for off in range(3):
        weights[ys, xs, base + off] = vertex_w_inside
    return targets, weights


def build_meta_blob(k, pose_world2live=None, pose_live2world=None,
                    voxel_step=(0.0, 0.0, 0.0), voxel_min=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The 48-float meta blob of one frame."""
    meta = np.zeros(48, np.float32)
    meta[0:9] = np.asarray(k, np.float32).flatten()
    meta[9:18] = np.linalg.pinv(np.asarray(k, np.float64)).astype(np.float32).flatten()
    if pose_world2live is not None:
        meta[18:30] = np.asarray(pose_world2live, np.float32).flatten()
    if pose_live2world is not None:
        meta[30:42] = np.asarray(pose_live2world, np.float32).flatten()
    meta[42:45] = voxel_step
    meta[45:48] = voxel_min
    return meta


def build_pose_blob(batch_index: int, cls_indexes, quats, translations,
                    centers=None) -> np.ndarray:
    """(N, 13) ground-truth pose rows."""
    n = len(cls_indexes)
    blob = np.zeros((n, 13), np.float32)
    blob[:, 0] = batch_index
    blob[:, 1] = cls_indexes
    if centers is not None:
        blob[:, 2:4] = centers
    blob[:, 6:10] = quats
    blob[:, 10:13] = translations
    return blob


def pad_image_blob(ims: list[np.ndarray], pixel_means: np.ndarray, stride: int = 16):
    """Stack images into a batch blob, mean-subtracted, padded to a
    stride multiple (ref: lib/utils/blob.py:13-72 im_list_to_blob +
    pad_im(·,16))."""
    max_h = max(im.shape[0] for im in ims)
    max_w = max(im.shape[1] for im in ims)
    ph = (max_h + stride - 1) // stride * stride
    pw = (max_w + stride - 1) // stride * stride
    blob = np.zeros((len(ims), ph, pw, 3), np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1], :] = im.astype(np.float32) - pixel_means
    return blob


def mat_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), NumPy host-side
    (ref: transforms3d mat2quat used at minibatch.py:373). Shepperd's
    method via the largest diagonal branch for numerical stability."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )
    if q[0] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)


def flip_poses(poses: np.ndarray, k: np.ndarray, width: float) -> np.ndarray:
    """Mirror GT poses for a horizontally flipped image
    (ref: _flip_poses minibatch.py:502-513): new pose = K⁻¹·K₁·pose
    where K₁ negates fx and reflects cx about the image width."""
    k = np.asarray(k, np.float64)
    k1 = k.copy()
    k1[0, 0] = -k1[0, 0]
    k1[0, 2] = width - k1[0, 2]
    a = np.linalg.inv(k) @ k1  # (3,3)
    # poses: (N, 3, 4)
    return np.einsum("ij,njk->nik", a, np.asarray(poses, np.float64)).astype(np.float32)


def normals_from_depth_np(depth: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Depth (H, W) metric → unit normal map (H, W, 3), host NumPy
    (ref: lib/normals/compute_normals.cu — cross product of central-
    difference backprojected tangents; used by the NORMAL input mode,
    minibatch.py:206-223). Invalid (zero-depth) pixels get zero
    normals."""
    h, w = depth.shape
    fx, fy = float(k[0, 0]), float(k[1, 1])
    cx, cy = float(k[0, 2]), float(k[1, 2])
    us, vs = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = depth.astype(np.float32)
    pts = np.stack([(us - cx) / fx * z, (vs - cy) / fy * z, z], axis=-1)
    du = np.zeros_like(pts)
    dv = np.zeros_like(pts)
    du[:, 1:-1] = pts[:, 2:] - pts[:, :-2]
    dv[1:-1, :] = pts[2:, :] - pts[:-2, :]
    n = np.cross(dv.reshape(-1, 3), du.reshape(-1, 3)).reshape(h, w, 3)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-8)
    # orient toward the camera and zero out invalid depth
    flipmask = (n[..., 2:3] > 0).astype(np.float32)
    n = n * (1.0 - 2.0 * flipmask)
    return n * (z[..., None] > 0)


def _box_smooth(im: np.ndarray, radius: int = 2) -> np.ndarray:
    """Separable box filter — host-side stand-in for the reference's
    cv2.bilateralFilter on the normal image (minibatch.py:223; cv2 is
    not in this environment — documented deviation). Vectorized via
    edge-padded cumsum along each axis (data-path hot loop)."""
    out = im.astype(np.float32)
    width_k = 2 * radius + 1
    for axis in (0, 1):
        padded = np.concatenate(
            [
                np.repeat(np.take(out, [0], axis=axis), radius + 1, axis=axis),
                out,
                np.repeat(np.take(out, [-1], axis=axis), radius, axis=axis),
            ],
            axis=axis,
        )
        cs = np.cumsum(padded, axis=axis)
        hi = np.take(cs, np.arange(width_k, cs.shape[axis]), axis=axis)
        lo = np.take(cs, np.arange(0, cs.shape[axis] - width_k), axis=axis)
        out = (hi - lo) / width_k
    return out


def build_image_blobs(
    color: np.ndarray,
    depth_raw: Optional[np.ndarray],
    k: np.ndarray,
    *,
    input_mode: str = "COLOR",
    pixel_means: np.ndarray,
    rng: Optional[np.random.RandomState] = None,
    chromatic: bool = False,
    noise: bool = False,
    flip: bool = False,
    depth_factor: float = 1000.0,
):
    """One frame → (data, data_p) network inputs per cfg INPUT mode
    (ref: _get_image_blob minibatch.py:84-241).

      COLOR  data = aug(color) − pixel_means
      DEPTH  data = tile3(depth/max·255) − pixel_means
      RGBD   data = color blob, data_p = depth blob (dual tower)
      NORMAL data = (127.5·normals(depth)+127.5 smoothed) − pixel_means
    """
    pixel_means = np.asarray(pixel_means, np.float32)
    need_depth = input_mode in ("DEPTH", "RGBD", "NORMAL")
    if need_depth and depth_raw is None:
        depth_raw = np.zeros(color.shape[:2], np.float32)

    data = None
    data_p = None
    if input_mode in ("COLOR", "RGBD"):
        im = color.astype(np.float32)
        if chromatic and rng is not None:
            im = chromatic_transform(im, rng)
        if noise and rng is not None:
            im = add_noise(im, rng)
        if flip:
            im = im[:, ::-1, :]
        data = im.astype(np.float32) - pixel_means

    if input_mode in ("DEPTH", "RGBD"):
        dmax = float(depth_raw.max()) or 1.0
        im_d = depth_raw.astype(np.float32) / dmax * 255.0
        im_d = np.tile(im_d[:, :, None], (1, 1, 3))
        if noise and rng is not None:
            im_d = add_noise(im_d, rng)
        if flip:
            im_d = im_d[:, ::-1, :]
        im_d = im_d - pixel_means
        if input_mode == "DEPTH":
            data = im_d
        else:
            data_p = im_d

    if input_mode == "NORMAL":
        nmap = normals_from_depth_np(depth_raw.astype(np.float32) / depth_factor, k)
        im_n = _box_smooth(127.5 * nmap + 127.5)
        if flip:
            im_n = im_n[:, ::-1, :]
        data = im_n.astype(np.float32) - pixel_means

    return data, data_p


def depth_blob(depth: np.ndarray, k: np.ndarray, input_mode: str,
               pixel_means: np.ndarray) -> np.ndarray:
    """The DEPTH / RGBD-tower blob (tile3(depth / max · 255) − means) or the
    NORMAL blob (127.5 · normals + 127.5 − means) of a rendered metric
    depth map (`posecnn_tpu/cli/train_net.py:590-606`)."""
    if input_mode == "NORMAL":
        return 127.5 * normals_from_depth_np(depth, k) + 127.5 - pixel_means
    return np.tile((depth / max(float(depth.max()), 1e-6) * 255.0)[:, :, None],
                   (1, 1, 3)) - pixel_means


def resize_nearest(im: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbor rescale (labels / raw depth — value-preserving,
    matching the reference's cv2 INTER_NEAREST label resize,
    ref: minibatch.py:168-175)."""
    h, w = im.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    yi = np.minimum(((np.arange(nh) + 0.5) * h / nh).astype(np.int64), h - 1)
    xi = np.minimum(((np.arange(nw) + 0.5) * w / nw).astype(np.int64), w - 1)
    return im[yi][:, xi]


def resize_bilinear(im: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear rescale with half-pixel centers (color images,
    matching the reference's cv2.resize INTER_LINEAR,
    ref: minibatch.py:155-166)."""
    h, w = im.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = np.clip((np.arange(nh) + 0.5) * h / nh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) * w / nw - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[:, None]
    wx = (xs - x0).astype(np.float32)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    imf = im.astype(np.float32)
    top = imf[y0][:, x0] * (1 - wx) + imf[y0][:, x1] * wx
    bot = imf[y1][:, x0] * (1 - wx) + imf[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _fit_hw(im: np.ndarray, height: int, width: int, fill=0):
    """Crop/zero-pad to a fixed (height, width) — static shapes for
    jit (replaces the reference's variable-size im_list_to_blob)."""
    out_shape = (height, width) + im.shape[2:]
    out = np.full(out_shape, fill, dtype=im.dtype)
    h = min(height, im.shape[0])
    w = min(width, im.shape[1])
    out[:h, :w] = im[:h, :w]
    return out


def get_real_minibatch(
    dataset,
    indices,
    *,
    num_classes: int,
    height: int,
    width: int,
    pixel_means,
    input_mode: str = "COLOR",
    rng: Optional[np.random.RandomState] = None,
    chromatic: bool = False,
    noise: bool = False,
    use_flipped: bool = False,
    max_gt: int = 16,
    vertex_w_inside: float = 10.0,
    scale: float = 1.0,
    dense_vertex_targets: bool = True,
) -> dict:
    """Assemble a training batch from real dataset frames
    (ref: get_minibatch minibatch.py:26-82 real branch; flipped
    augmentation per imdb.append_flipped_images imdb.py:104-117 —
    with use_flipped, index i ≥ len(dataset) selects the mirrored
    copy of frame i − len(dataset)).

    Returns the same blob dict as SyntheticSceneGenerator.minibatch:
    data (B,H,W,3), label (B,H,W) int32, depth (B,H,W) metric,
    vertex_targets/weights (B,H,W,3C), meta (B,48), gt_poses (G,13),
    gt_valid (G,) [+ data_p for RGBD].
    """
    n_real = len(dataset.image_index)
    datas, datas_p, labels, depths, vts, vws, metas = [], [], [], [], [], [], []
    v_centers_l, v_logz_l, v_valid_l = [], [], []
    gt = np.zeros((max_gt, 13), np.float32)
    gt_valid = np.zeros((max_gt,), bool)
    row = 0
    for bi, idx in enumerate(indices):
        idx = int(idx)
        flip = use_flipped and idx >= n_real
        frame = dataset.load_frame(dataset.image_index[idx % n_real])
        k = np.array(frame.get("intrinsic_matrix", np.eye(3, dtype=np.float32)), np.float32)
        factor = 1000.0
        if "meta" in frame:
            factor = float(np.squeeze(frame["meta"].get("factor_depth", 1000.0)))
        color = frame["color"][..., :3]
        depth_raw = frame.get("depth_raw")
        if scale != 1.0:
            # TRAIN.SCALES_BASE rescale (ref: _get_image_blob
            # minibatch.py:155-175): image bilinear, depth/label
            # nearest; the intrinsics scale with the pixels
            color = resize_bilinear(color, scale).astype(color.dtype)
            if depth_raw is not None:
                depth_raw = resize_nearest(depth_raw, scale)
            k = k.copy()
            k[:2, :] *= scale
        color = _fit_hw(color, height, width)
        if depth_raw is not None:
            depth_raw = _fit_hw(depth_raw.astype(np.float32), height, width)
        data, data_p = build_image_blobs(
            color, depth_raw, k,
            input_mode=input_mode, pixel_means=pixel_means, rng=rng,
            chromatic=chromatic, noise=noise, flip=flip, depth_factor=factor,
        )
        datas.append(data)
        if data_p is not None:
            datas_p.append(data_p)

        label = frame.get("label", np.zeros((height, width), np.int32))
        if scale != 1.0:
            label = resize_nearest(np.asarray(label), scale)
        label = _fit_hw(label, height, width).astype(np.int32)
        if input_mode == "DEPTH" and depth_raw is not None:
            label = label * (depth_raw > 0)  # (ref: minibatch.py:314-319)
        if flip:
            label = label[:, ::-1]
        labels.append(label)

        depth_m = (
            depth_raw.astype(np.float32) / factor
            if depth_raw is not None
            else np.zeros((height, width), np.float32)
        )
        if flip:
            depth_m = depth_m[:, ::-1]
        depths.append(depth_m)

        # GT poses (3,4,N) → (N,3,4); mirrored for flipped frames
        poses = frame.get("poses")
        cls_indexes = frame.get("cls_indexes", np.zeros(0, np.int64))
        if poses is not None:
            if poses.ndim == 2:
                poses = poses[:, :, None]
            poses = np.transpose(poses, (2, 0, 1)).astype(np.float32)
            if flip:
                poses = flip_poses(poses, k, width)
        else:
            poses = np.zeros((0, 3, 4), np.float32)

        centers = frame.get("center")
        if centers is not None:
            centers = np.array(centers, np.float32) * scale
            if flip and len(centers):
                centers[:, 0] = width - centers[:, 0]  # (ref: minibatch.py:394-396)
        elif len(poses) > 0:
            # project translations (ref fallback used by syn data);
            # poses are ALREADY flip-reflected above, so their
            # projection is already mirrored — no second mirror here
            tt = poses[:, :, 3]
            proj = (k @ tt.T).T
            centers = (proj[:, :2] / np.maximum(proj[:, 2:3], 1e-8)).astype(np.float32)
        else:
            centers = np.zeros((0, 2), np.float32)

        zs = poses[:, 2, 3] if len(poses) else np.zeros(0, np.float32)
        if dense_vertex_targets:
            vt, vw = generate_vertex_targets(
                label, cls_indexes, centers, np.maximum(zs, 1e-6), num_classes,
                vertex_w_inside=vertex_w_inside,
            )
            vts.append(vt)
            vws.append(vw)
        else:
            # sparse per-class form (ops/losses.build_vertex_targets
            # builds the dense maps on device — same contract as
            # SyntheticSceneGenerator.minibatch sparse mode)
            vc = np.zeros((num_classes, 2), np.float32)
            vz = np.zeros((num_classes,), np.float32)
            vv = np.zeros((num_classes,), bool)
            for j, ci in enumerate(np.asarray(cls_indexes).astype(int)):
                if 0 < ci < num_classes and not vv[ci] and j < len(centers):
                    vc[ci] = centers[j]
                    vz[ci] = np.log(max(float(zs[j]) if j < len(zs) else 1e-6, 1e-6))
                    vv[ci] = True
            v_centers_l.append(vc)
            v_logz_l.append(vz)
            v_valid_l.append(vv)
        metas.append(build_meta_blob(k))

        for j in range(min(len(cls_indexes), len(poses))):
            if row >= max_gt:
                break
            gt[row, 0] = bi
            gt[row, 1] = float(cls_indexes[j])
            if j < len(centers):
                gt[row, 2:4] = centers[j]
            gt[row, 6:10] = mat_to_quat_np(poses[j, :, :3])
            gt[row, 10:13] = poses[j, :, 3]
            gt_valid[row] = True
            row += 1

    batch = {
        "data": np.stack(datas),
        "label": np.stack(labels),
        "depth": np.stack(depths),
        "meta": np.stack(metas),
        "gt_poses": gt,
        "gt_valid": gt_valid,
    }
    if dense_vertex_targets:
        batch["vertex_targets"] = np.stack(vts)
        batch["vertex_weights"] = np.stack(vws)
    else:
        batch["vertex_centers"] = np.stack(v_centers_l)
        batch["vertex_logz"] = np.stack(v_logz_l)
        batch["vertex_valid"] = np.stack(v_valid_l)
    if datas_p:
        batch["data_p"] = np.stack(datas_p)
    return batch


def get_real_video_minibatch(
    dataset,
    start_indices,
    *,
    num_steps: int,
    height: int,
    width: int,
    pixel_means,
    input_mode: str = "COLOR",
    rng: Optional[np.random.RandomState] = None,
    chromatic: bool = False,
    noise: bool = False,
    voxelizer=None,
    scale: float = 1.0,
) -> dict:
    """Sequences of dataset frames for the recurrent net
    (`posecnn_tpu/data/minibatch.py:518-658`; ref: GtDataLayer
    lib/gt_data_layer/minibatch.py:20-310).

    One sequence per start index: frames t are image_index[start + t]. A
    sequence never crosses a `<video>/<frame>` boundary: where the video id
    changes (or the list ends) the last in-video frame repeats. Flat
    indices (no '/') count as one video. The meta blob carries each
    frame's pose_world2live / live2world relative to the sequence's first
    frame, from the `.mat`'s rotation_translation_matrix (identity without
    one), and the voxel grid set up from the first frame's depth.

    Returns time-major blobs: image (T, B, H, W, 3) mean-subtracted, depth
    (T, B, H, W) metres, meta (T, B, 48), label (T, B, H, W) int32.
    """
    from posecnn_torch.utils.voxelizer import Voxelizer

    n_index = len(dataset.image_index)

    def video_of(idx_str: str) -> str:
        return idx_str.split("/")[0] if "/" in idx_str else ""

    images, depths, metas, labels = [], [], [], []
    for start in start_indices:
        start = int(start) % n_index
        video = video_of(dataset.image_index[start])
        seq_im, seq_d, seq_m, seq_l = [], [], [], []
        rt_world = None
        vox = voxelizer or Voxelizer()
        frame_i, prev_i, frame = start, -1, None
        for t in range(num_steps):
            cand = min(start + t, n_index - 1)
            if video_of(dataset.image_index[cand]) == video:
                frame_i = cand  # else the last in-video frame repeats
            if frame_i != prev_i:
                frame = dataset.load_frame(dataset.image_index[frame_i])
                prev_i = frame_i
            k = np.array(frame.get("intrinsic_matrix", np.eye(3, dtype=np.float32)), np.float32)
            factor = 1000.0
            if "meta" in frame:
                factor = float(np.squeeze(frame["meta"].get("factor_depth", 1000.0)))
            color = frame["color"][..., :3]
            depth_raw = frame.get("depth_raw")
            if scale != 1.0:
                color = resize_bilinear(color, scale).astype(color.dtype)
                if depth_raw is not None:
                    depth_raw = resize_nearest(depth_raw, scale)
                k = k.copy()
                k[:2, :] *= scale
            color = _fit_hw(color, height, width)
            if depth_raw is not None:
                depth_raw = _fit_hw(depth_raw.astype(np.float32), height, width)
            data, _ = build_image_blobs(color, depth_raw, k, input_mode=input_mode,
                                        pixel_means=pixel_means, rng=rng, chromatic=chromatic,
                                        noise=noise, depth_factor=factor)
            seq_im.append(data)
            depth_m = (depth_raw.astype(np.float32) / factor if depth_raw is not None
                       else np.zeros((height, width), np.float32))
            seq_d.append(depth_m)
            label = frame.get("label", np.zeros((height, width), np.int32))
            if scale != 1.0:
                label = resize_nearest(np.asarray(label), scale)
            seq_l.append(_fit_hw(label, height, width).astype(np.int32))

            # camera motion, the world frame being the sequence's first
            # (ref: minibatch.py:216-222 pose_world2live / live2world)
            rt_live = None
            if "meta" in frame and "rotation_translation_matrix" in frame["meta"]:
                rt_live = np.asarray(frame["meta"]["rotation_translation_matrix"],
                                     np.float64).reshape(3, 4)
            if rt_live is None:
                w2l = l2w = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
            else:
                if rt_world is None:
                    rt_world = rt_live
                # w2l = RT_live · RT_world⁻¹
                r_w, t_w = rt_world[:, :3], rt_world[:, 3]
                inv_w = np.concatenate([r_w.T, (-r_w.T @ t_w)[:, None]], 1)
                r_l = rt_live[:, :3]
                w2l = np.concatenate(
                    [r_l @ inv_w[:, :3], (r_l @ inv_w[:, 3] + rt_live[:, 3])[:, None]], 1)
                r2, t2 = w2l[:, :3], w2l[:, 3]
                l2w = np.concatenate([r2.T, (-r2.T @ t2)[:, None]], 1)
            if t == 0:
                vox.setup_from_depth(depth_m, k)
            step, mn = vox.meta_fields()
            seq_m.append(build_meta_blob(k, w2l, l2w, step, mn))
        images.append(np.stack(seq_im))
        depths.append(np.stack(seq_d))
        metas.append(np.stack(seq_m))
        labels.append(np.stack(seq_l))
    return {"image": np.stack(images, axis=1), "depth": np.stack(depths, axis=1),
            "meta": np.stack(metas, axis=1), "label": np.stack(labels, axis=1)}


def label_to_boxes(im_label: np.ndarray, cls_indexes: np.ndarray) -> np.ndarray:
    """GT boxes (N, 5) [x1,y1,x2,y2,cls] from a label map — the roidb
    box source for detection training (ref: gt_roidb box assembly in
    lib/datasets/*.py)."""
    boxes = []
    for c in cls_indexes:
        ys, xs = np.nonzero(im_label == int(c))
        if len(ys) == 0:
            continue
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max(), int(c)])
    if not boxes:
        return np.zeros((0, 5), np.float32)
    return np.asarray(boxes, np.float32)
