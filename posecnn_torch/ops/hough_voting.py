"""Center-direction Hough voting for 3D translation + RoI emission.

Counterpart of `posecnn_tpu/ops/hough_voting.py`. Per image,
`_prepare_slots` picks up to `max_classes` present classes and packs
`num_samples` evenly strided pixels of each into (K, 8, S) samples; the
votes run batched over all (B·K) slots; the maxima are picked;
`_maxima_tail` sizes the box at each maximum; RoIs and initial poses are
emitted into fixed (B·max_objects) buffers with a validity mask. In training
(`is_train=True`, `:952-1025`) each maximum is matched to the first GT
object of its image and class whose projected 3D box overlaps its box by
IoU > 0.2, gets that object's quaternion as a one-hot-block target, and
is emitted as 9 jittered boxes; `append_gt_rois` (`:1048-1132`) prepends
one exact RoI per GT object.

Two modes, as in the original:
- single instance (`vote_threshold <= 0`): each class slot's vote
  maximum is one candidate;
- multi-instance (`vote_threshold > 0`): every 7×7 local maximum above
  the threshold is a candidate (`:393-478`, `:531-559`), the top
  `max_objects_per_image` of them by votes are kept, and the
  vote-percentage filter drops sparse ones (`:611-614`).

Backends (JAX name in brackets):
- "c2f" [pallas_c2f], the default: the coarse-to-fine vote of
  `ops/hough_kernels.py`, whose two kernels are CUDA on the card;
  multi-instance maxima are found inside its refine windows;
- "exhaustive" [pallas]: the exhaustive vote kernel over the whole grid,
  the exact oracle the c2f path is held to;
- "dense" [xla]: the exhaustive masked reduction of `:480-527`, plain
  tensor code in chunks of 8 samples.

Hough is zero-gradient by contract (`:785-789, 1045`): both entry points
run under `torch.no_grad()`, so the training forward builds no graph
through them and the kernels' wrappers never see a tensor that requires
grad. Their constants (box corners, jitters, the identity quaternion)
are device buffers made once per device (`utils/graph.device_constant`),
so that a CUDA graph can capture the training emission.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from posecnn_torch.ops.hough_kernels import (
    WINDOW,
    hough_votes_c2f,
    hough_votes_c2f_windows,
    hough_votes_exhaustive,
)
from posecnn_torch.utils.bbox import box_iou
from posecnn_torch.utils.graph import device_constant
from posecnn_torch.utils.quaternion import quat_to_mat

VERTEX_CHANNELS = 3
BACKENDS = ("c2f", "exhaustive", "dense")


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


# the 8 corners of an extent box, signs (x, y, z) (`hough_voting.py:102-105`)
_CORNER_SIGNS = [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]


def _gt_projected_boxes(gt_poses, extents, fx, fy, px, py):
    """Project each GT object's 3D extent box to a 2D xyxy box
    (`hough_voting.py:93-113`). gt_poses: (G, 13); fx, fy, px, py: (G,)
    intrinsics of each row's image. Returns (G, 4)."""
    cls = gt_poses[:, 1].long().clamp(0, extents.shape[0] - 1)
    half = extents[cls] * 0.5  # (G, 3)
    signs = device_constant(_CORNER_SIGNS, gt_poses.device)
    corners = signs[None] * half[:, None, :]  # (G, 8, 3)
    r = quat_to_mat(gt_poses[:, 6:10])
    xyz = torch.einsum("gij,gkj->gki", r, corners) + gt_poses[:, None, 10:13]
    z = torch.where(xyz[..., 2].abs() < 1e-6, 1e-6, xyz[..., 2])
    u = fx[:, None] * xyz[..., 0] / z + px[:, None]
    v = fy[:, None] * xyz[..., 1] / z + py[:, None]
    return torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)], -1)


def _gt_rows_intrinsics(gt_poses, meta_data):
    """(fx, fy, px, py) of each GT row's image, (G,) each."""
    bidx = gt_poses[:, 0].long().clamp(0, meta_data.shape[0] - 1)
    return meta_data[bidx, 0], meta_data[bidx, 4], meta_data[bidx, 2], meta_data[bidx, 5]


def _one_hot_blocks(cls, values, num_classes):
    """(R, 4C) rows holding `values` (R, 4) in the 4 columns of each
    row's class `cls` (R,) and 0 elsewhere."""
    rows = cls.shape[0]
    col = 4 * cls.long()[:, None] + torch.arange(4, device=cls.device)[None]
    out = torch.zeros((rows, 4 * num_classes), dtype=torch.float32, device=cls.device)
    return out.scatter_(1, col, values.float())


# jitter offsets of (x1, y1) in units of (0.05·w, 0.05·h): the centre box
# and 8 shifts (`hough_voting.py:632-645`)
_JITTERS = [[0.0, 0.0], [-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0], [0.0, -1.0],
            [-1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]


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


def _top_k(values, m):
    """`jax.lax.top_k` of a 1-D tensor: ties go to the lower index."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:m], i[:m]


def _grid_maxima(votes, dsum, samp_w, *, grid_h, grid_w, m, vote_threshold):
    """Multi-instance candidates of one image's full vote grid
    (`hough_voting.py:531-559`): 7×7 local maxima above the threshold,
    ties broken by a per-cell jitter below one vote quantum, then the
    top `m` by votes over all slots. votes, dsum: (K, n_cells).
    Returns (cand_slot, cand_cell, cand_votes, cand_dist, cand_valid)."""
    k, n_cells = votes.shape
    tie = torch.arange(n_cells, dtype=torch.float32, device=votes.device)[None] * (
        samp_w[:, None] * 1e-6
    )
    vgrid = (votes + tie).reshape(k, 1, grid_h, grid_w)
    # reduce_window(-inf, max, 7×7, SAME): max_pool2d pads with -inf
    local_max = F.max_pool2d(vgrid, 7, stride=1, padding=3)
    is_max = (vgrid >= local_max).reshape(k, n_cells) & (votes > vote_threshold)
    top_v, top_i = _top_k(torch.where(is_max, votes, 0.0).reshape(-1), m)
    slot, cell = top_i // n_cells, top_i % n_cells
    dist = dsum[slot, cell] / torch.clamp(votes[slot, cell], min=1e-10)
    return slot, cell, top_v, dist, top_v > 0


def _window_maxima(votes_w, dsum_w, w_oy, w_ox, w_en, samp_w, *, grid_h, grid_w, m,
                   vote_threshold):
    """Multi-instance candidates of one image inside its c2f refine
    windows (`hough_voting.py:393-478`). votes_w, dsum_w: (K, T, WINDOW²);
    w_oy, w_ox, w_en: (K, T). A cell is a maximum only where its whole
    in-grid 7×7 neighbourhood lies in the window, and a cell that several
    windows can decide counts in the first of them only (containment is
    not enough: `:441-448`). Returns (cand_slot, cand_fy, cand_fx,
    cand_votes, cand_dist, cand_valid); cand_fy/fx in fine cells."""
    k, t_w, n_win = votes_w.shape
    widx = torch.arange(n_win, device=votes_w.device)
    fy = w_oy[:, :, None] + widx // WINDOW  # (K, T, n_win) fine rows
    fx = w_ox[:, :, None] + widx % WINDOW
    in_grid = (fy < grid_h) & (fx < grid_w)
    gidx = (fy * grid_w + fx).float()
    vj = votes_w + gidx * (samp_w[:, None, None] * 1e-6)
    vj = torch.where(in_grid, vj, -torch.inf)
    lmax = F.max_pool2d(vj.reshape(k * t_w, 1, WINDOW, WINDOW), 7, stride=1, padding=3)
    lmax = lmax.reshape(k, t_w, n_win)

    def decides(oy, ox, cy, cx):
        return (
            ((cy - 3).clamp(min=0) >= oy)
            & ((cy + 3).clamp(max=grid_h - 1) <= oy + WINDOW - 1)
            & ((cx - 3).clamp(min=0) >= ox)
            & ((cx + 3).clamp(max=grid_w - 1) <= ox + WINDOW - 1)
        )

    is_max = (
        (vj >= lmax)
        & (votes_w > vote_threshold)
        & decides(w_oy[:, :, None], w_ox[:, :, None], fy, fx)
        & in_grid
        & w_en[:, :, None]
    )
    # decided_by[k, t, t', i]: window t' decides cell i of window t
    decided_by = decides(w_oy[:, None, :, None], w_ox[:, None, :, None], fy[:, :, None],
                         fx[:, :, None])
    t_iota = torch.arange(t_w, device=votes_w.device)
    earlier = (t_iota[:, None] > t_iota[None, :])[None, :, :, None]
    dup = (decided_by & earlier & w_en[:, None, :, None]).any(dim=2)
    is_max = is_max & ~dup
    top_v, top_i = _top_k(torch.where(is_max, votes_w, 0.0).reshape(-1), m)
    dist = dsum_w.reshape(-1)[top_i] / torch.clamp(top_v, min=1e-10)
    return (top_i // (t_w * n_win), fy.reshape(-1)[top_i], fx.reshape(-1)[top_i], top_v, dist,
            top_v > 0)


def _maxima_tail(prep, extents, fx, fy, px, py, cand_slot, cand_cls, cand_x, cand_y,
                 cand_votes, cand_dist, cand_valid, vote_threshold, vote_percentage, *,
                 inlier_threshold=0.9):
    """Box extent at each maximum, from the inlier samples of its slot,
    then in multi-instance mode the vote-percentage filter
    (`hough_voting.py:584-625`). Returns (bb_width, bb_height, cand_valid)."""
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
    cand_valid = cand_valid & (bb_width > 0) & (bb_height > 0)
    if vote_threshold > 0:
        frac = cand_votes / torch.clamp(bb_width * bb_height, min=1e-10)
        cand_valid = cand_valid & (frac >= vote_percentage)
    return bb_width, bb_height, cand_valid


@torch.no_grad()
def prepare_votes(label, vertex_pred, extents, meta_data, *, label_threshold=500,
                  skip_pixels=10, num_samples=256, max_classes=8, inlier_threshold=0.9,
                  vertex_factor=1):
    """`_prepare_slots` for each image of the batch. Returns (the per-image
    dicts, the packed samples (B·K, 8, S) and boxes (B·K, 4) that the vote
    kernels take)."""
    vertex_f32 = vertex_pred.float().contiguous()
    preps = [
        _prepare_slots(
            label[i], vertex_f32[i], extents, meta_data[i],
            num_classes=extents.shape[0], label_threshold=label_threshold,
            skip_pixels=skip_pixels, num_samples=num_samples, max_classes=max_classes,
            inlier_threshold=inlier_threshold, vertex_factor=vertex_factor,
        )
        for i in range(label.shape[0])
    ]
    return (preps, torch.cat([p["packed"] for p in preps]),
            torch.cat([p["bboxes"] for p in preps]))


def hough_voting(
    label: torch.Tensor,
    vertex_pred: torch.Tensor,
    extents: torch.Tensor,
    meta_data: torch.Tensor,
    gt_poses: Optional[torch.Tensor] = None,
    gt_valid: Optional[torch.Tensor] = None,
    *,
    is_train: bool = False,
    inlier_threshold: float = 0.9,
    label_threshold: int = 500,
    vote_threshold: float = -1.0,
    vote_percentage: float = 0.02,
    skip_pixels: int = 10,
    num_samples: int = 256,
    max_classes: int = 8,
    max_objects_per_image: int = 16,
    cell_stride: int = 1,
    backend: str = "c2f",
    vertex_factor: int = 1,
) -> HoughOutputs:
    """Batched Hough voting (`hough_voting.hough_voting`).

    label: (B, H, W) int; vertex_pred: (B, H/f, W/f, 3C) with
    f = vertex_factor; extents: (C, 3); meta_data: (B, 48) with the
    intrinsics at [0:9]. `vote_threshold > 0` selects multi-instance
    mode; `backend` is one of BACKENDS. With `is_train`, gt_poses (G, 13)
    [batch, cls, …, quat at 6:10, t at 10:13] and gt_valid (G,) bool
    (default all) give the training emission. Returns HoughOutputs with
    R = B·max_objects rows, 9 times as many with `is_train`.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown hough backend {backend!r}; expected one of {BACKENDS}")
    b, height, width = label.shape
    num_classes = extents.shape[0]
    m = max_objects_per_image
    multi = vote_threshold > 0
    if vertex_pred.shape[1] * vertex_factor != height or (
        vertex_pred.shape[2] * vertex_factor != width
    ):
        raise ValueError(
            f"vertex_pred spatial dims {tuple(vertex_pred.shape[1:3])} × factor "
            f"{vertex_factor} must equal the label dims {(height, width)}"
        )
    if is_train and gt_poses is None:
        raise ValueError("is_train=True requires gt_poses")
    hc, wc = height // cell_stride, width // cell_stride
    grid = dict(cell_stride=cell_stride, grid_h=hc, grid_w=wc)
    preps, packed, bboxes = prepare_votes(
        label, vertex_pred, extents, meta_data, label_threshold=label_threshold,
        skip_pixels=skip_pixels, num_samples=num_samples, max_classes=max_classes,
        inlier_threshold=inlier_threshold, vertex_factor=vertex_factor,
    )
    k = preps[0]["packed"].shape[0]

    def cell_xy(cell):
        return ((cell % wc) * cell_stride).float(), ((cell // wc) * cell_stride).float()

    def padded(a, fill=0.0):
        """K per-slot values → M candidate rows (single-instance mode)."""
        return F.pad(a, (0, max(m - k, 0)), value=float(fill))[:m]

    # per image: (cand_slot, cand_x, cand_y, cand_votes, cand_dist, cand_valid), M rows each
    cands = []
    if backend == "c2f" and multi:
        # the per-class window budget scales with the caller's object
        # budget, as in the original (hough_voting.py:792-806)
        win = hough_votes_c2f_windows(packed, bboxes, **grid, top_t=max(16, 2 * m),
                                      coarse_local_max=True)
        for i, p in enumerate(preps):
            slot, fy, fx, v, dist, ok = _window_maxima(
                *(a[i * k:(i + 1) * k] for a in win), p["samp_w"], grid_h=hc, grid_w=wc, m=m,
                vote_threshold=vote_threshold,
            )
            cands.append((slot, (fx * cell_stride).float(), (fy * cell_stride).float(), v,
                          dist, ok))
    elif backend == "c2f":
        best_v, best_d, best_cy, best_cx = hough_votes_c2f(packed, bboxes, **grid)
        slot_dist = best_d / torch.clamp(best_v, min=1e-10)
        for i, p in enumerate(preps):
            sl = slice(i * k, (i + 1) * k)
            cands.append((
                padded(torch.arange(k, device=label.device)),
                padded((best_cx[sl] * cell_stride).float()),
                padded((best_cy[sl] * cell_stride).float()),
                padded(best_v[sl]), padded(slot_dist[sl]),
                padded(p["slot_valid"] & (best_v[sl] > 0)),
            ))
    else:
        if backend == "exhaustive":
            votes_all, dsum_all = hough_votes_exhaustive(packed, bboxes, **grid)
            grids = [(votes_all[i * k:(i + 1) * k].reshape(k, hc * wc),
                      dsum_all[i * k:(i + 1) * k].reshape(k, hc * wc)) for i in range(b)]
        else:
            grids = [_dense_votes(p, **grid, inlier_threshold=inlier_threshold) for p in preps]
        for p, (votes, dsum) in zip(preps, grids):
            if multi:
                slot, cell, v, dist, ok = _grid_maxima(
                    votes, dsum, p["samp_w"], grid_h=hc, grid_w=wc, m=m,
                    vote_threshold=vote_threshold,
                )
                cands.append((slot, *cell_xy(cell), v, dist, ok))
                continue
            # single instance: each slot's first maximum; padding rows
            # read (slot 0, cell 0), as the original's do
            cell = torch.argmax(votes, dim=1, keepdim=True)
            v = votes.gather(1, cell)[:, 0]
            distance = dsum / torch.clamp(votes, min=1e-10)
            x, y = cell_xy(cell[:, 0])
            cands.append((
                padded(torch.arange(k, device=label.device)), padded(x), padded(y), padded(v),
                padded(distance.gather(1, cell)[:, 0], distance[0, 0] if k else 0.0),
                padded(p["slot_valid"] & (v > 0)),
            ))

    # per image: size the candidates' boxes
    rows = []
    for p, (cand_slot, cand_x, cand_y, cand_votes, cand_dist, cand_valid), meta in zip(
        preps, cands, meta_data
    ):
        cand_cls = p["slot_cls"][cand_slot]
        bb_w, bb_h, cand_valid = _maxima_tail(
            p, extents, meta[0], meta[4], meta[2], meta[5], cand_slot, cand_cls,
            cand_x, cand_y, cand_votes, cand_dist, cand_valid, vote_threshold,
            vote_percentage, inlier_threshold=inlier_threshold,
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
    if not is_train:
        rois = torch.stack([batch_idx, cand_cls.float(), x1, y1, x2, y2, cand_votes], -1)
        zeros = torch.zeros((b * m, 4 * num_classes), device=label.device)
        return HoughOutputs(
            rois=rois,
            poses_init=pose_init,
            poses_target=zeros,
            poses_weight=zeros,
            domains=torch.zeros((b * m,), dtype=torch.int32, device=label.device),
            valid=cand_valid,
        )

    # GT match: the first GT object of the same image and class whose
    # projected box overlaps the maximum's box by IoU > 0.2 (:958-981)
    gt_poses = gt_poses.float()
    g = gt_poses.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((g,), dtype=torch.bool, device=label.device)
    gt_boxes = _gt_projected_boxes(gt_poses, extents, *_gt_rows_intrinsics(gt_poses, meta_data))
    ious = box_iou(torch.stack([x1, y1, x2, y2], -1), gt_boxes)  # (B·M, G)
    same = ((gt_poses[None, :, 1].long() == cand_cls.long()[:, None])
            & (gt_poses[None, :, 0].long() == batch_idx.long()[:, None]) & gt_valid[None, :])
    matchable = torch.where(same, ious, -1.0) > 0.2
    first_gt = torch.argmax(matchable.to(torch.uint8), dim=1)
    has_match = matchable.any(dim=1) & cand_valid
    targets = _one_hot_blocks(cand_cls, gt_poses[first_gt, 6:10] * has_match[:, None],
                              num_classes)
    weights = _one_hot_blocks(cand_cls, has_match[:, None].float().expand(b * m, 4),
                              num_classes)
    domain = torch.where(gt_valid.any(), 0, 1).to(torch.int32)  # 1: an image set without GT

    # 9 jittered boxes per maximum, one after another (:998-1017)
    jit = device_constant(_JITTERS, label.device) * 0.05
    ww = (x2 - x1)[:, None]
    hh = (y2 - y1)[:, None]
    jx1 = x1[:, None] + jit[None, :, 0] * ww
    jy1 = y1[:, None] + jit[None, :, 1] * hh
    boxes9 = torch.stack([jx1, jy1, jx1 + ww, jy1 + hh], -1).reshape(-1, 4)

    def rep(a):
        return a.repeat_interleave(9, dim=0)

    rois = torch.cat([rep(batch_idx)[:, None], rep(cand_cls.float())[:, None], boxes9,
                      rep(cand_votes)[:, None]], -1)
    return HoughOutputs(
        rois=rois,
        poses_init=rep(pose_init),
        poses_target=rep(targets),
        poses_weight=rep(weights),
        domains=domain.expand(9 * b * m).contiguous(),
        valid=rep(cand_valid),
    )


# the identity rotation of a GT row's pose_init (`hough_voting.py:1110-1113`)
_IDENTITY_QUAT = [[1.0, 0.0, 0.0, 0.0]]


@torch.no_grad()
def append_gt_rois(out: HoughOutputs, gt_poses: torch.Tensor, gt_valid: Optional[torch.Tensor],
                   extents: torch.Tensor, meta_data: torch.Tensor,
                   num_classes: int) -> HoughOutputs:
    """Prepend one exact RoI per GT object to a training Hough output
    (`hough_voting.py:1048-1132`): the projected 3D-extent box, the GT
    quaternion as a weight-1 target in its class's columns, and an
    identity-rotation pose_init at the GT translation. Rows come first so
    that the pose-row compaction (valid first, stable) keeps them."""
    gt_poses = gt_poses.float()
    g = gt_poses.shape[0]
    if gt_valid is None:
        gt_valid = torch.ones((g,), dtype=torch.bool, device=gt_poses.device)
    bidx = gt_poses[:, 0].long().clamp(0, meta_data.shape[0] - 1)
    boxes = _gt_projected_boxes(gt_poses, extents, *_gt_rows_intrinsics(gt_poses, meta_data))
    cls = gt_poses[:, 1].long()
    vf = gt_valid.float()
    safe_cls = cls.clamp(0, num_classes - 1)
    gt_out = HoughOutputs(
        rois=torch.cat([bidx.float()[:, None], cls.float()[:, None], boxes,
                        torch.ones((g, 1), device=gt_poses.device)], -1),
        poses_init=torch.cat([
            device_constant(_IDENTITY_QUAT, gt_poses.device).expand(g, 4),
            gt_poses[:, 10:13]], -1),
        poses_target=_one_hot_blocks(safe_cls, gt_poses[:, 6:10] * vf[:, None], num_classes),
        poses_weight=_one_hot_blocks(safe_cls, vf[:, None].expand(g, 4), num_classes),
        domains=torch.zeros((g,), dtype=torch.int32, device=gt_poses.device),
        valid=gt_valid.bool(),
    )
    return HoughOutputs(*(torch.cat([a, c], 0) for a, c in zip(gt_out, out)))
