"""Center-direction Hough voting for 3D translation + RoI emission.

Counterpart of `posecnn_tpu/ops/hough_voting.py`, for the serving path:
single-instance mode (`vote_threshold <= 0`) in eval (no training
jitters or GT matching). Per image, `_prepare_slots` picks up to
`max_classes` present classes and packs `num_samples` evenly strided
pixels of each into (K, 8, S) samples; the votes run batched over all
(B·K) slots; `_maxima_tail` sizes the box at each slot's maximum; RoIs
and initial poses are emitted into fixed (B·max_objects) buffers with a
validity mask.

Backends: "c2f" (default) is the coarse-to-fine vote of
`ops/hough_kernels.py`, whose two kernels are CUDA on the card;
"dense" is the exhaustive masked reduction of the JAX "xla" backend
(`hough_voting.py:480-527`), plain tensor code, kept as the exact
reference the c2f path is checked against.

Still to port: multi-instance mode (`:393-478`, `:531-559`), training
emission with GT matching (`:952-1025`) and `append_gt_rois`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from posecnn_torch.ops.hough_kernels import hough_votes_c2f

VERTEX_CHANNELS = 3


class HoughOutputs(NamedTuple):
    rois: torch.Tensor  # (R, 7) [batch, cls, x1, y1, x2, y2, score]
    poses_init: torch.Tensor  # (R, 7) [w,x,y,z, tx, ty, tz]
    poses_target: torch.Tensor  # (R, 4C)
    poses_weight: torch.Tensor  # (R, 4C)
    domains: torch.Tensor  # (R,) int32
    valid: torch.Tensor  # (R,) bool


def _projected_box_size(extents_c, fx, fy, px, py, distance):
    """max(width, height) of the projected 3D extent box at a
    camera-frame distance (`hough_voting.py:72-90`)."""
    xh = extents_c[..., 0] * 0.5
    yh = extents_c[..., 1] * 0.5
    zh = extents_c[..., 2] * 0.5
    z_near = torch.clamp(distance - zh, min=1e-6)
    z_far = torch.clamp(distance + zh, min=1e-6)
    max_x = torch.maximum(fx * xh / z_near, fx * xh / z_far)
    max_y = torch.maximum(fy * yh / z_near, fy * yh / z_far)
    width = max_x - (-max_x) + 1.0
    height = max_y - (-max_y) + 1.0
    return torch.maximum(width, height)


def _prepare_slots(
    label,
    vertex_pred,
    extents,
    meta,
    *,
    num_classes,
    label_threshold,
    skip_pixels,
    num_samples,
    max_classes,
    inlier_threshold=0.9,
    vertex_factor=1,
):
    """Class-slot selection and sample extraction for one image
    (`hough_voting.py:116-296`, the same fields).

    label: (H, W) int; vertex_pred: (H/f, W/f, 3C) fp32 NHWC-contiguous;
    extents: (C, 3); meta: (48,)."""
    dev = label.device
    height, width = label.shape
    hw = height * width
    max_classes = min(max_classes, num_classes - 1)
    fx, fy, px, py = meta[0], meta[4], meta[2], meta[5]

    # 1. per-class per-block pixel counts (scanline blocks of 512)
    blk = 512
    n_blk = -(-hw // blk)
    flat_pad = F.pad(label.reshape(hw), (0, n_blk * blk - hw))  # pad pixels are class 0
    lab_blocks = flat_pad.reshape(n_blk, blk)
    class_ids = torch.arange(num_classes, dtype=label.dtype, device=dev)
    blk_counts = (lab_blocks[None] == class_ids[:, None, None]).sum(2)  # (C, n_blk) int64
    counts = blk_counts.sum(1)

    # 2. up to max_classes present foreground classes, in class order
    fg_counts = counts[1:]
    fg_valid = fg_counts > label_threshold
    slot_order = torch.argsort((~fg_valid).to(torch.int32), stable=True)[:max_classes]
    slot_cls = slot_order + 1
    slot_valid = fg_valid[slot_order]
    slot_count = fg_counts[slot_order]
    s = num_samples

    # 3. the j-th sample is the (⌊j·count/S⌋+1)-th class pixel in
    # scanline order: search the block cumsum, then inside the block
    slot_blk_cum = torch.cumsum(blk_counts[1:][slot_order], dim=1)  # (K, n_blk)
    j = torch.arange(s, device=dev)
    targets_j = (j[None, :] * slot_count[:, None]) // s + 1  # (K, S)
    blk_idx = torch.searchsorted(slot_blk_cum, targets_j, right=False).clamp(0, n_blk - 1)
    before = torch.where(
        blk_idx > 0, slot_blk_cum.gather(1, (blk_idx - 1).clamp(min=0)), 0
    )
    within = targets_j - before  # 1-based rank inside the block
    local_mask = lab_blocks[blk_idx] == slot_cls[:, None, None]  # (K, S, blk)
    local_cum = torch.cumsum(local_mask.to(torch.int32), dim=2)
    off = torch.argmax((local_cum >= within[:, :, None]).to(torch.int32), dim=2)
    samp_idx = (blk_idx * blk + off).clamp(0, hw - 1)
    samp_x = (samp_idx % width).float()
    samp_y = (samp_idx // width).float()
    samp_w = slot_count.float() / (skip_pixels * s)
    samp_ok = (slot_valid & (slot_count > 0))[:, None].expand(max_classes, s)

    # per-sample direction + depth from the vertex map
    chan = VERTEX_CHANNELS * slot_cls
    stride_c = VERTEX_CHANNELS * num_classes
    vert = vertex_pred.reshape(-1)
    if vertex_factor == 1:
        def take(c_off):
            return vert[samp_idx * stride_c + chan[:, None] + c_off]

        samp_u, samp_v, samp_d = take(0), take(1), torch.exp(take(2))
    else:
        # bilinear sample of the 1/f map with the frozen upsample's own
        # weights (half-pixel centres, edge clamp): equal to gathering
        # from the upsampled map (hough_voting.py:219-254)
        hl, wl = vertex_pred.shape[0], vertex_pred.shape[1]
        yc = (samp_y + 0.5) / vertex_factor - 0.5
        xc = (samp_x + 0.5) / vertex_factor - 0.5
        y0 = torch.floor(yc)
        x0 = torch.floor(xc)
        wy = yc - y0
        wx = xc - x0
        y0i = y0.long().clamp(0, hl - 1)
        y1i = (y0.long() + 1).clamp(0, hl - 1)
        x0i = x0.long().clamp(0, wl - 1)
        x1i = (x0.long() + 1).clamp(0, wl - 1)

        def interp(c_off):
            def take(yi, xi):
                return vert[(yi * wl + xi) * stride_c + chan[:, None] + c_off]

            return (
                (1.0 - wy) * (1.0 - wx) * take(y0i, x0i)
                + (1.0 - wy) * wx * take(y0i, x1i)
                + wy * (1.0 - wx) * take(y1i, x0i)
                + wy * wx * take(y1i, x1i)
            )

        samp_u, samp_v, samp_d = interp(0), interp(1), torch.exp(interp(2))
    samp_uv_norm = torch.sqrt(samp_u * samp_u + samp_v * samp_v) + 1e-10

    # projected-extent gate per sample, at the sample's own depth
    slot_ext = extents[slot_cls]  # (K, 3)
    samp_thresh = 0.6 * _projected_box_size(slot_ext[:, None, :], fx, fy, px, py, samp_d)

    w_eff = samp_w[:, None] * samp_ok.float()
    # channel 5 carries (threshold·‖uv‖)² so the cone test needs no sqrt
    t_norm2 = (inlier_threshold * samp_uv_norm) ** 2
    packed = torch.stack(
        [samp_x, samp_y, samp_u, samp_v, samp_d, t_norm2, samp_thresh, w_eff], dim=1
    )  # (K, 8, S)
    big = 1e9
    bboxes = torch.stack(
        [
            torch.where(samp_ok, samp_x - samp_thresh, big).amin(1),
            torch.where(samp_ok, samp_x + samp_thresh, -big).amax(1),
            torch.where(samp_ok, samp_y - samp_thresh, big).amin(1),
            torch.where(samp_ok, samp_y + samp_thresh, -big).amax(1),
        ],
        dim=1,
    )  # (K, 4)
    return dict(
        slot_cls=slot_cls,
        slot_valid=slot_valid,
        samp_x=samp_x,
        samp_y=samp_y,
        samp_u=samp_u,
        samp_v=samp_v,
        samp_d=samp_d,
        samp_uv_norm=samp_uv_norm,
        samp_thresh=samp_thresh,
        samp_w=samp_w,
        samp_ok=samp_ok,
        packed=packed.contiguous(),
        bboxes=bboxes.contiguous(),
    )


def _dense_votes(prep, *, cell_stride, grid_h, grid_w, inlier_threshold, sample_chunk=8):
    """Exhaustive vote grid of one image's slots, the JAX "xla" backend's
    chunked masked reduction (`hough_voting.py:480-527`).
    Returns (votes, dsum), each (K, grid_h·grid_w)."""
    dev = prep["samp_x"].device
    cell_x = (torch.arange(grid_w, device=dev) * cell_stride).float()
    cell_y = (torch.arange(grid_h, device=dev) * cell_stride).float()
    cgx = cell_x.repeat(grid_h)
    cgy = cell_y.repeat_interleave(grid_w)
    samp_w = prep["samp_w"]
    k, s = prep["samp_x"].shape
    votes = torch.zeros((k, grid_h * grid_w), device=dev)
    dsum = torch.zeros_like(votes)
    ok = prep["samp_ok"].float()
    for c0 in range(0, s, sample_chunk):
        sl = slice(c0, c0 + sample_chunk)
        dx = cgx[None, None, :] - prep["samp_x"][:, sl, None]
        dy = cgy[None, None, :] - prep["samp_y"][:, sl, None]
        dot = prep["samp_u"][:, sl, None] * dx + prep["samp_v"][:, sl, None] * dy
        dist2 = dx * dx + dy * dy
        t2n2 = ((inlier_threshold * prep["samp_uv_norm"][:, sl]) ** 2)[:, :, None]
        thr = prep["samp_thresh"][:, sl, None]
        inlier = (dot > 0) & (dot * dot > t2n2 * dist2) & (dx.abs() < thr) & (dy.abs() < thr)
        w = inlier.float() * ok[:, sl, None]
        votes = votes + (w * samp_w[:, None, None]).sum(1)
        dsum = dsum + (w * (prep["samp_d"][:, sl] * samp_w[:, None])[:, :, None]).sum(1)
    return votes, dsum


def _maxima_tail(prep, extents, fx, fy, px, py, cand_slot, cand_cls, cand_x, cand_y,
                 cand_votes, cand_dist, cand_valid, *, inlier_threshold=0.9):
    """Box extent at each maximum, from the inlier samples of its slot
    (`hough_voting.py:584-625`, single-instance: no vote-percentage test).
    Returns (bb_width, bb_height, cand_valid)."""
    mx = prep["samp_x"][cand_slot]  # (M, S)
    my = prep["samp_y"][cand_slot]
    mu = prep["samp_u"][cand_slot]
    mv = prep["samp_v"][cand_slot]
    mnorm = prep["samp_uv_norm"][cand_slot]
    mok = prep["samp_ok"][cand_slot]
    mext = extents[cand_cls]

    dx = cand_x[:, None] - mx
    dy = cand_y[:, None] - my
    dist = torch.sqrt(dx * dx + dy * dy) + 1e-10
    cos = (mu * dx + mv * dy) / (mnorm * dist)
    mthresh = 0.6 * _projected_box_size(mext, fx, fy, px, py, cand_dist)[:, None]
    inl = (cos > inlier_threshold) & (dx.abs() < mthresh) & (dy.abs() < mthresh) & mok
    bb_width = 2.0 * torch.where(inl, dx.abs(), -1.0).amax(1)
    bb_height = 2.0 * torch.where(inl, dy.abs(), -1.0).amax(1)
    return bb_width, bb_height, cand_valid & (bb_width > 0) & (bb_height > 0)


def hough_voting(
    label: torch.Tensor,
    vertex_pred: torch.Tensor,
    extents: torch.Tensor,
    meta_data: torch.Tensor,
    *,
    inlier_threshold: float = 0.9,
    label_threshold: int = 500,
    skip_pixels: int = 10,
    num_samples: int = 256,
    max_classes: int = 8,
    max_objects_per_image: int = 16,
    cell_stride: int = 1,
    backend: str = "c2f",
    vertex_factor: int = 1,
) -> HoughOutputs:
    """Batched single-instance Hough voting, eval emission
    (`hough_voting.hough_voting` with is_train=False, vote_threshold <= 0;
    multi-instance mode is not ported).

    label: (B, H, W) int; vertex_pred: (B, H/f, W/f, 3C) with
    f = vertex_factor; extents: (C, 3); meta_data: (B, 48) with the
    intrinsics at [0:9]. Returns HoughOutputs with R = B·max_objects rows.
    """
    if backend not in ("c2f", "dense"):
        raise ValueError(f"unknown hough backend {backend!r}")
    b, height, width = label.shape
    num_classes = extents.shape[0]
    m = max_objects_per_image
    if vertex_pred.shape[1] * vertex_factor != height or (
        vertex_pred.shape[2] * vertex_factor != width
    ):
        raise ValueError(
            f"vertex_pred spatial dims {tuple(vertex_pred.shape[1:3])} × factor "
            f"{vertex_factor} must equal the label dims {(height, width)}"
        )
    vertex_f32 = vertex_pred.float().contiguous()
    hc, wc = height // cell_stride, width // cell_stride
    preps = [
        _prepare_slots(
            label[i], vertex_f32[i], extents, meta_data[i],
            num_classes=num_classes, label_threshold=label_threshold,
            skip_pixels=skip_pixels, num_samples=num_samples, max_classes=max_classes,
            inlier_threshold=inlier_threshold, vertex_factor=vertex_factor,
        )
        for i in range(b)
    ]
    k = preps[0]["packed"].shape[0]

    if backend == "c2f":
        best_v, best_d, best_cy, best_cx = hough_votes_c2f(
            torch.cat([p["packed"] for p in preps]),
            torch.cat([p["bboxes"] for p in preps]),
            cell_stride=cell_stride, grid_h=hc, grid_w=wc,
        )
        slot_x = (best_cx * cell_stride).float().reshape(b, k)
        slot_y = (best_cy * cell_stride).float().reshape(b, k)
        slot_votes = best_v.reshape(b, k)
        slot_dist = (best_d / torch.clamp(best_v, min=1e-10)).reshape(b, k)
        dist_fill = [0.0] * b
    else:
        xs, ys, vs, ds, dist_fill = [], [], [], [], []
        for p in preps:
            votes, dsum = _dense_votes(
                p, cell_stride=cell_stride, grid_h=hc, grid_w=wc,
                inlier_threshold=inlier_threshold,
            )
            cell = torch.argmax(votes, dim=1, keepdim=True)
            v = votes.gather(1, cell)[:, 0]
            xs.append(((cell[:, 0] % wc) * cell_stride).float())
            ys.append(((cell[:, 0] // wc) * cell_stride).float())
            vs.append(v)
            distance = dsum / torch.clamp(votes, min=1e-10)
            ds.append(distance.gather(1, cell)[:, 0])
            # the JAX dense path reads padding rows at (slot 0, cell 0)
            dist_fill.append(distance[0, 0] if k else 0.0)
        slot_x, slot_y, slot_votes, slot_dist = (torch.stack(a) for a in (xs, ys, vs, ds))

    # per image: pad the K slot maxima to M candidates, size their boxes
    rows = []
    for i, p in enumerate(preps):
        pad = max(m - k, 0)

        def padded(a, fill=0.0):
            return F.pad(a, (0, pad), value=float(fill))[:m]

        cand_slot = padded(torch.arange(k, device=label.device))
        cand_cls = p["slot_cls"][cand_slot]
        cand_x, cand_y = padded(slot_x[i]), padded(slot_y[i])
        cand_votes, cand_dist = padded(slot_votes[i]), padded(slot_dist[i], dist_fill[i])
        cand_valid = padded(p["slot_valid"] & (slot_votes[i] > 0))
        meta = meta_data[i]
        bb_w, bb_h, cand_valid = _maxima_tail(
            p, extents, meta[0], meta[4], meta[2], meta[5], cand_slot, cand_cls,
            cand_x, cand_y, cand_votes, cand_dist, cand_valid,
            inlier_threshold=inlier_threshold,
        )
        rows.append((cand_cls, cand_x, cand_y, cand_votes, cand_dist, bb_w, bb_h, cand_valid))
    cand_cls, cand_x, cand_y, cand_votes, cand_dist, bb_width, bb_height, cand_valid = (
        torch.cat(a) for a in zip(*rows)
    )

    batch_idx = torch.arange(b, device=label.device).repeat_interleave(m).float()
    per_row = meta_data.repeat_interleave(m, dim=0)
    fx, fy, px, py = per_row[:, 0], per_row[:, 4], per_row[:, 2], per_row[:, 5]

    # base box: half size · (0.5 + 0.05) around the maximum
    scale = 0.05
    x1 = cand_x - bb_width * (0.5 + scale)
    y1 = cand_y - bb_height * (0.5 + scale)
    x2 = cand_x + bb_width * (0.5 + scale)
    y2 = cand_y + bb_height * (0.5 + scale)

    # initial pose: identity rotation, backprojected centre ray × depth
    rx = (cand_x - px) / fx
    ry = (cand_y - py) / fy
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)
    pose_init = torch.stack([one, zero, zero, zero, rx * cand_dist, ry * cand_dist, cand_dist], -1)
    rois = torch.stack(
        [batch_idx, cand_cls.float(), x1, y1, x2, y2, cand_votes], -1
    )
    zeros = torch.zeros((b * m, 4 * num_classes), device=label.device)
    return HoughOutputs(
        rois=rois,
        poses_init=pose_init,
        poses_target=zeros,
        poses_weight=zeros,
        domains=torch.zeros((b * m,), dtype=torch.int32, device=label.device),
        valid=cand_valid,
    )
