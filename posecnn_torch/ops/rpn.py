"""Region Proposal Network ops with static shapes.

Counterpart of `posecnn_tpu/ops/rpn.py`: anchors (numpy, per model
shape), proposals (top-k → decode → clip → size filter → NMS → top
post_nms), the RPN's anchor targets, the RoI sampling with per-class box
and quaternion targets, and a detection's translation from its box.

Random draws: the JAX layers draw their sampling noise from a
`jax.random` key; here the bodies take the uniforms as arguments
(`anchor_target_layer`'s fg/bg keys, `proposal_target_layer`'s), and
`target_noise` draws them from a `torch.Generator`, so a test can feed
both packages the same draw.

Ties: `jax.lax.top_k` puts equal values in index order and `jnp.argsort`
is stable; both are a stable descending sort here (`_top_k`). `argmax`
takes the first maximum in both.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from posecnn_torch.ops.nms import nms
from posecnn_torch.utils.bbox import bbox_transform, bbox_transform_inv, box_iou, clip_boxes
from posecnn_torch.utils.quaternion import quat_to_mat


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """Base anchors (A, 4), ratio-major (`posecnn_tpu/ops/rpn.py:24`)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(anchors, np.float32)


def anchor_grid(height: int, width: int, stride: int, base_anchors: np.ndarray) -> np.ndarray:
    """All shifted anchors (H·W·A, 4) in (h, w, a) order (`rpn.py:47`)."""
    sx, sy = np.meshgrid(np.arange(width) * stride, np.arange(height) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (base_anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4).astype(np.float32)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest, equal values in index order
    (`jax.lax.top_k`'s order)."""
    idx = torch.sort(x, descending=True, stable=True).indices[:k]
    return x[idx], idx


class Proposals(NamedTuple):
    rois: torch.Tensor  # (N, 5) [batch, x1, y1, x2, y2]
    scores: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


def proposal_layer(rpn_cls_prob: torch.Tensor, rpn_bbox_pred: torch.Tensor,
                   anchors: torch.Tensor, im_height: int, im_width: int, *,
                   batch_index: int = 0, pre_nms_topk: int = 2000, post_nms_topk: int = 300,
                   nms_threshold: float = 0.7, min_size: float = 16.0) -> Proposals:
    """rpn_cls_prob (H, W, 2A) softmaxed [bg…, fg…]; rpn_bbox_pred
    (H, W, 4A); anchors (H·W·A, 4). Proposals with `post_nms_topk`
    slots (`rpn.py:63`). The boxes keep their gradient to the deltas, as
    in JAX: the RoI head's pool and box targets read them."""
    a = anchors.shape[0] // (rpn_cls_prob.shape[0] * rpn_cls_prob.shape[1])
    fg_scores = rpn_cls_prob[..., a:].reshape(-1)
    deltas = rpn_bbox_pred.reshape(-1, 4)
    k = min(pre_nms_topk, fg_scores.shape[0])
    top_scores, top_idx = _top_k(fg_scores, k)
    boxes = clip_boxes(bbox_transform_inv(anchors[top_idx], deltas[top_idx]), im_height, im_width)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    size_ok = (ws >= min_size) & (hs >= min_size)
    keep = nms(boxes, top_scores, nms_threshold, valid=size_ok)
    ranked = torch.argsort(-torch.where(keep, top_scores, float("-inf")),
                           stable=True)[:post_nms_topk]
    sel_boxes, sel_scores, sel_valid = boxes[ranked], top_scores[ranked], keep[ranked]
    pad = post_nms_topk - ranked.shape[0]
    if pad > 0:
        # fewer anchors than the RoI budget: invalid rows fill the slots
        sel_boxes = F.pad(sel_boxes, (0, 0, 0, pad))
        sel_scores = F.pad(sel_scores, (0, pad))
        sel_valid = F.pad(sel_valid, (0, pad))
    rois = torch.cat([torch.full((post_nms_topk, 1), float(batch_index), device=boxes.device),
                      sel_boxes], dim=1)
    return Proposals(rois, sel_scores, sel_valid)


def _random_keep(mask: torch.Tensor, max_keep, noise: torch.Tensor) -> torch.Tensor:
    """Keep at most `max_keep` True entries of `mask`, those with the
    largest `noise` (`rpn.py:109`)."""
    key = torch.where(mask, noise, -1.0)
    kth_idx = torch.clamp(torch.as_tensor(max_keep, device=mask.device) - 1, 0, mask.shape[0] - 1)
    kth = torch.sort(key, descending=True).values[kth_idx]
    cut = torch.where(mask.sum() > max_keep, kth, -0.5)
    return mask & (key >= cut)


class TargetNoise(NamedTuple):
    """One step's sampling uniforms: the anchor targets' fg and bg keys
    (A·H·W,) and the RoI sampling's fg and bg keys (post_nms + G,)."""

    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


def target_noise(num_anchors: int, num_rois: int, generator: torch.Generator,
                 device) -> TargetNoise:
    """The four uniforms of a training forward, drawn from `generator`
    on `device` (the JAX model splits its key the same four ways)."""
    def draw(n):
        return torch.rand((n,), generator=generator, device=device)

    return TargetNoise(draw(num_anchors), draw(num_anchors), draw(num_rois), draw(num_rois))


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (N,) 1 fg / 0 bg / -1 ignore
    bbox_targets: torch.Tensor  # (N, 4)
    bbox_inside_weights: torch.Tensor  # (N, 4)
    bbox_outside_weights: torch.Tensor  # (N, 4)


@torch.no_grad()
def anchor_target_layer(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        im_height: int, im_width: int, fg_noise: torch.Tensor,
                        bg_noise: torch.Tensor, *, positive_overlap: float = 0.7,
                        negative_overlap: float = 0.3, batch_size: int = 256,
                        fg_fraction: float = 0.5,
                        clobber_positives: bool = False) -> AnchorTargets:
    """RPN training targets (`rpn.py:128`): anchors labelled by IoU with
    the valid GT boxes (G, 5) [x1, y1, x2, y2, cls], each GT's best inside
    anchor positive, then subsampled to `batch_size` by the noise keys."""
    n = anchors.shape[0]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < im_width)
              & (anchors[:, 3] < im_height))
    ious = torch.where(gt_valid[None, :], box_iou(anchors, gt_boxes[:, :4]), -1.0)
    ious_inside = torch.where(inside[:, None], ious, -1.0)
    max_iou = ious_inside.amax(dim=1)
    argmax_gt = ious_inside.argmax(dim=1)
    # each GT's best inside anchor is positive; a max-scatter, so that a
    # padded GT (its argmax is anchor 0) never clears a True
    best_per_gt = ious_inside.argmax(dim=0).clamp(0, n - 1)
    is_best = torch.zeros((n,), dtype=torch.float32, device=anchors.device).scatter_reduce(
        0, best_per_gt, gt_valid.float(), "amax") > 0

    labels = torch.full((n,), -1, dtype=torch.long, device=anchors.device)
    pos = inside & (is_best | (max_iou >= positive_overlap))
    neg = inside & (max_iou < negative_overlap)
    if clobber_positives:  # negatives last: they clear a best anchor's positive
        labels = torch.where(neg, 0, torch.where(pos, 1, labels))
    else:
        labels = torch.where(pos, 1, torch.where(neg, 0, labels))

    num_fg = int(fg_fraction * batch_size)
    fg_keep = _random_keep(labels == 1, num_fg, fg_noise)
    bg_keep = _random_keep(labels == 0, batch_size - fg_keep.sum(), bg_noise)
    labels = torch.where((labels == 1) & ~fg_keep, -1, labels)
    labels = torch.where((labels == 0) & ~bg_keep, -1, labels)

    targets = bbox_transform(anchors, gt_boxes[argmax_gt.clamp(0, gt_boxes.shape[0] - 1), :4])
    inside_w = (labels == 1).float()[:, None].expand(n, 4)
    n_examples = torch.clamp((labels >= 0).sum(), min=1).float()
    outside_w = torch.where((labels >= 0)[:, None], 1.0 / n_examples, 0.0).expand(n, 4)
    return AnchorTargets(labels, targets, inside_w, outside_w)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor  # (R, 5)
    labels: torch.Tensor  # (R,)
    bbox_targets: torch.Tensor  # (R, 4C)
    bbox_inside_weights: torch.Tensor  # (R, 4C)
    bbox_outside_weights: torch.Tensor  # (R, 4C)
    pose_targets: torch.Tensor  # (R, 4C) quaternions
    pose_weights: torch.Tensor  # (R, 4C)
    valid: torch.Tensor  # (R,)


def proposal_target_layer(proposals: Proposals, gt_boxes: torch.Tensor, gt_poses: torch.Tensor,
                          gt_valid: torch.Tensor, num_classes: int, fg_noise: torch.Tensor,
                          bg_noise: torch.Tensor, *, rois_per_image: int = 128,
                          fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                          bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.0,
                          bbox_normalize_means=None,
                          bbox_normalize_stds=None) -> ProposalTargets:
    """Sample `rois_per_image` RoIs from the proposals and the GT boxes,
    with per-class box and quaternion targets (`rpn.py:206`). gt_poses
    (G, 13) Hough-format rows (quaternion at 6:10); fg_noise and bg_noise
    (post_nms + G,) uniforms. The sampled rows and their box targets keep
    the proposals' gradient, as in JAX."""
    g = gt_boxes.shape[0]
    dev = gt_boxes.device
    gt_rois = torch.cat([torch.zeros((g, 1), device=dev), gt_boxes[:, :4]], dim=1)
    all_rois = torch.cat([proposals.rois, gt_rois])
    all_valid = torch.cat([proposals.valid, gt_valid])

    ious = torch.where(gt_valid[None, :], box_iou(all_rois[:, 1:5], gt_boxes[:, :4]), -1.0)
    max_iou = ious.amax(dim=1)
    gt_idx = ious.argmax(dim=1).clamp(0, g - 1)
    gt_cls = gt_boxes[gt_idx, 4].long()
    is_fg = all_valid & (max_iou >= fg_thresh)
    is_bg = all_valid & (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)

    num_fg = int(fg_fraction * rois_per_image)
    num_bg = rois_per_image - num_fg
    _, fg_sel = _top_k(torch.where(is_fg, fg_noise + 1.0, 0.0), num_fg)
    _, bg_sel = _top_k(torch.where(is_bg, bg_noise, -1.0), num_bg)
    sel = torch.cat([fg_sel, bg_sel])
    sel_is_fg = torch.cat([is_fg[fg_sel], torch.zeros((num_bg,), dtype=torch.bool, device=dev)])
    sel_valid = torch.cat([is_fg[fg_sel], is_bg[bg_sel]])

    rois = all_rois[sel]
    labels = torch.where(sel_is_fg, gt_cls[sel], 0)
    tgt4 = bbox_transform(rois[:, 1:5], gt_boxes[gt_idx[sel], :4])
    if bbox_normalize_means is not None and bbox_normalize_stds is not None:
        means = torch.tensor(bbox_normalize_means, dtype=torch.float32, device=dev)[None, :]
        stds = torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev)[None, :]
        tgt4 = (tgt4 - means) / stds
    fg_f = sel_is_fg[:, None].to(tgt4.dtype)
    cols = 4 * labels[:, None] + torch.arange(4, device=dev)[None, :]
    zeros = torch.zeros((rois_per_image, 4 * num_classes), dtype=tgt4.dtype, device=dev)
    bbox_targets = zeros.scatter(1, cols, tgt4 * fg_f)
    inside_w = zeros.scatter(1, cols, fg_f.expand(rois_per_image, 4))
    pose_targets = zeros.scatter(1, cols, gt_poses[gt_idx[sel], 6:10].to(tgt4.dtype) * fg_f)
    return ProposalTargets(rois, labels, bbox_targets, inside_w, inside_w, pose_targets,
                           inside_w, sel_valid)


def log_depth_grid(d_near: float, d_far: float, num: int, device=None) -> torch.Tensor:
    """exp(linspace(log d_near, log d_far, num)) in fp32, by
    `jnp.linspace`'s formula (start·(1 − i/div) + stop·i/div, then the end
    point). XLA:CPU fuses it differently, and jitted and eager JAX differ
    from each other in the last ulp of some cells; a cell's ulp moves the
    fitted depth by ~1e-7 relative."""
    start = torch.log(torch.tensor(d_near, dtype=torch.float32))
    stop = torch.log(torch.tensor(d_far, dtype=torch.float32))
    step = torch.arange(num - 1, dtype=torch.float32) / float(num - 1)
    grid = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return torch.exp(grid).to(device)


def estimate_translation_from_box(quats: torch.Tensor, boxes: torch.Tensor,
                                  points: torch.Tensor, k: torch.Tensor, *,
                                  d_near: float = 0.1, d_far: float = 5.0,
                                  num_candidates: int = 64) -> torch.Tensor:
    """Each detection's translation from its box (`rpn.py:287`), batched
    over detections: quats (N, 4) wxyz, boxes (N, 4), points (N, P, 3)
    the class model points, k (3, 3). t = centre ray × d, d the depth on a
    log-spaced grid whose projected model box best matches the detected
    box's size, refined by a parabola on (log d, objective) around the
    grid's argmin. Returns (N, 3)."""
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    x = 0.5 * (boxes[:, 0] + boxes[:, 2])
    y = 0.5 * (boxes[:, 1] + boxes[:, 3])
    width = boxes[:, 2] - boxes[:, 0]
    height = boxes[:, 3] - boxes[:, 1]
    rx = (x - px) / fx
    ry = (y - py) / fy
    pr = torch.einsum("npk,njk->npj", points, quat_to_mat(quats))  # (N, P, 3)

    ds = log_depth_grid(d_near, d_far, num_candidates, quats.device)  # (D,)
    t = torch.stack([rx[:, None] * ds, ry[:, None] * ds, ds.expand(rx.shape[0], -1)], -1)
    pc = pr[:, None, :, :] + t[:, :, None, :]  # (N, D, P, 3)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + px
    v = fy * pc[..., 1] / z + py
    w_proj = u.amax(-1) - u.amin(-1)
    h_proj = v.amax(-1) - v.amin(-1)
    obj = (w_proj - width[:, None]) ** 2 + (h_proj - height[:, None]) ** 2  # (N, D)

    i = torch.clamp(obj.argmin(dim=1), 1, num_candidates - 2)[:, None]
    log_ds = torch.log(ds)
    l1, l2 = log_ds[i], log_ds[i + 1]
    f0, f1, f2 = (obj.gather(1, i + o)[:, 0] for o in (-1, 0, 1))
    l1, l2 = l1[:, 0], l2[:, 0]
    denom = f0 - 2.0 * f1 + f2
    step = torch.where(denom.abs() > 1e-12, 0.5 * (f0 - f2) / denom * (l2 - l1), 0.0)
    d_star = torch.exp(torch.clamp(l1 + step, math.log(d_near), math.log(d_far)))
    return torch.stack([rx * d_star, ry * d_star, d_star], dim=-1)
