"""Faster-RCNN-style detection and pose variant of PoseCNN (`posecnn_det`).

Counterpart of `posecnn_tpu/models/detection.py`: the VGG16 trunk →
3×3/512 RPN conv → 1×1 cls (2A) and bbox (4A) heads in fp32 → the
anchor softmax over each (bg, fg) pair → proposals → in training the
anchor and RoI targets → `roi_align` on conv5_3 at 1/16 → fc6 / fc7 in
the compute dtype → cls, bbox and tanh-quaternion heads in fp32.
`detection_losses` is the train_net_det loss: RPN CE + RPN smooth-L1 +
RCNN CE + RCNN smooth-L1, plus the ADD pose loss on the masked,
L2-normalised quaternions when model points are given.

Layout: the RPN heads' outputs are returned NHWC, (B, h, w, 2A) and
(B, h, w, 4A), as the JAX model returns them; every reshape of them
(the softmax pairs, the proposals' (h, w, a) anchor order, the losses)
reads that layout. Module names follow the JAX parameter tree
(`params/trunk/…`, `params/rpn_conv/…`, `params/fc6/…`), so
`core.weights` maps a checkpoint onto the model both ways.

The sampling noise of the targets is an argument (`rpn.TargetNoise`),
drawn by the caller from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import VGG16Trunk, conv, nchw, nhwc
from posecnn_torch.ops.add_loss import average_distance_loss
from posecnn_torch.ops.losses import smooth_l1_loss
from posecnn_torch.ops.roi_align import roi_align
from posecnn_torch.ops.rpn import (
    AnchorTargets,
    ProposalTargets,
    Proposals,
    TargetNoise,
    anchor_grid,
    anchor_target_layer,
    generate_anchors,
    proposal_layer,
    proposal_target_layer,
)


class DetectionOutputs(NamedTuple):
    rpn_cls_logits: torch.Tensor  # (B, h, w, 2A)
    rpn_bbox_pred: torch.Tensor  # (B, h, w, 4A)
    proposals: Proposals
    cls_logits: torch.Tensor  # (R, C)
    bbox_pred: torch.Tensor  # (R, 4C)
    poses_pred: torch.Tensor  # (R, 4C) tanh quaternions
    anchor_targets: Optional[AnchorTargets]
    proposal_targets: Optional[ProposalTargets]


class PoseCNNDet(nn.Module):
    """The detection model; the knobs keep the JAX module's names and
    defaults (`posecnn_tpu/models/detection.py:48-76`)."""

    # the JAX parameter tree's name of the trunk (the flagship's is VGG16Trunk_0)
    JAX_TRUNK = "trunk"

    def __init__(self, num_classes: int, *, anchor_scales=(8, 16, 32),
                 anchor_ratios=(0.5, 1.0, 2.0), feature_stride: int = 16, fc_dim: int = 4096,
                 post_nms_topk: int = 128, pre_nms_topk: int = 2000,
                 rpn_nms_thresh: float = 0.7, rpn_min_size: float = 16.0,
                 rpn_positive_overlap: float = 0.7, rpn_negative_overlap: float = 0.3,
                 rpn_clobber_positives: bool = False, rpn_batchsize: int = 256,
                 rpn_fg_fraction: float = 0.5, rois_per_image: int = 0,
                 fg_fraction: float = 0.25, fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                 bg_thresh_lo: float = 0.1,
                 bbox_normalize_means: Optional[tuple] = (0.0, 0.0, 0.0, 0.0),
                 bbox_normalize_stds: Optional[tuple] = (0.1, 0.1, 0.2, 0.2),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.feature_stride = feature_stride
        self.post_nms_topk = post_nms_topk
        self.proposal_kw = dict(pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk,
                                nms_threshold=rpn_nms_thresh, min_size=rpn_min_size)
        self.anchor_kw = dict(positive_overlap=rpn_positive_overlap,
                              negative_overlap=rpn_negative_overlap, batch_size=rpn_batchsize,
                              fg_fraction=rpn_fg_fraction,
                              clobber_positives=rpn_clobber_positives)
        self.roi_kw = dict(rois_per_image=rois_per_image or post_nms_topk,
                           fg_fraction=fg_fraction, fg_thresh=fg_thresh,
                           bg_thresh_hi=bg_thresh_hi, bg_thresh_lo=bg_thresh_lo,
                           bbox_normalize_means=bbox_normalize_means,
                           bbox_normalize_stds=bbox_normalize_stds)
        self.compute_dtype = compute_dtype
        a = self.num_anchors
        self.trunk = VGG16Trunk(compute_dtype=compute_dtype)
        self.rpn_conv = nn.Conv2d(512, 512, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(512, 2 * a, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * a, 1)
        self.fc6 = nn.Linear(7 * 7 * 512, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, 4 * num_classes)
        self.pose_pred = nn.Linear(fc_dim, 4 * num_classes)
        self._anchors = {}  # (h, w, device) → (h·w·A, 4) anchors

    @classmethod
    def from_config(cls, cfg, num_classes: int, *, train: bool,
                    compute_dtype: torch.dtype = torch.float32) -> "PoseCNNDet":
        """The model a cfg trains (the RPN's train knobs and the targets')
        or evaluates (its test knobs), as the JAX CLIs build it
        (`posecnn_tpu/cli/train_net.py:82-104`, `cli/test_net.py:451-461`)."""
        common = dict(anchor_scales=tuple(cfg.anchor_scales),
                      anchor_ratios=tuple(cfg.anchor_ratios),
                      feature_stride=cfg.feature_stride, fc_dim=cfg.train.fc_dim,
                      compute_dtype=compute_dtype)
        if not train:
            te = cfg.test
            return cls(num_classes, pre_nms_topk=te.rpn_pre_nms_top_n,
                       post_nms_topk=te.rpn_post_nms_top_n, rpn_nms_thresh=te.rpn_nms_thresh,
                       **common)
        t = cfg.train
        norm_on = t.bbox_normalize_targets
        return cls(num_classes, pre_nms_topk=t.rpn_pre_nms_top_n,
                   post_nms_topk=t.rpn_post_nms_top_n, rois_per_image=t.batch_size,
                   rpn_nms_thresh=t.rpn_nms_thresh, rpn_positive_overlap=t.rpn_positive_overlap,
                   rpn_negative_overlap=t.rpn_negative_overlap,
                   rpn_clobber_positives=t.rpn_clobber_positives,
                   rpn_batchsize=t.rpn_batchsize, rpn_fg_fraction=t.rpn_fg_fraction,
                   fg_fraction=t.fg_fraction, fg_thresh=t.fg_thresh,
                   bg_thresh_hi=t.bg_thresh_hi, bg_thresh_lo=t.bg_thresh_lo,
                   bbox_normalize_means=tuple(t.bbox_normalize_means) if norm_on else None,
                   bbox_normalize_stds=tuple(t.bbox_normalize_stds) if norm_on else None,
                   **common)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def rois_per_image(self) -> int:
        return self.roi_kw["rois_per_image"]

    def noise_shapes(self, im_h: int, im_w: int, num_gt: int) -> tuple[int, int]:
        """The lengths of a training forward's `TargetNoise` on an
        im_h×im_w image with `num_gt` GT rows: the anchors of the conv5_3
        map (four ceil-mode halvings) and the proposals plus GT rows."""
        h, w = im_h, im_w
        for _ in range(4):
            h, w = -(-h // 2), -(-w // 2)
        return h * w * self.num_anchors, self.post_nms_topk + num_gt

    def anchors(self, h: int, w: int, device) -> torch.Tensor:
        """The (h·w·A, 4) anchors of an h×w conv5_3 map, made once a shape."""
        key = (h, w, str(device))
        if key not in self._anchors:
            base = generate_anchors(self.feature_stride, self.anchor_ratios, self.anchor_scales)
            self._anchors[key] = torch.from_numpy(
                anchor_grid(h, w, self.feature_stride, base)).to(device)
        return self._anchors[key]

    def rpn(self, data: torch.Tensor):
        """Trunk and RPN heads: conv5_3 (B, h, w, 512) NHWC, the RPN
        logits (B, h, w, 2A) and deltas (B, h, w, 4A) in fp32 NHWC, and
        the anchor softmax over each (bg, fg) pair, (B, h, w, 2A)."""
        _, conv5_3 = self.trunk(data)
        x = F.relu(conv(nchw(conv5_3), self.rpn_conv, self.compute_dtype))
        rpn_cls = nhwc(conv(x, self.rpn_cls_score, torch.float32))
        rpn_bbox = nhwc(conv(x, self.rpn_bbox_pred, torch.float32))
        b, h, w, _ = rpn_cls.shape
        a = self.num_anchors
        cls_prob = F.softmax(rpn_cls.reshape(b, h, w, 2, a), dim=3).reshape(b, h, w, 2 * a)
        return conv5_3, rpn_cls, rpn_bbox, cls_prob

    def propose(self, cls_prob: torch.Tensor, rpn_bbox: torch.Tensor, im_h: int,
                im_w: int) -> Proposals:
        """The RPN's proposals of image 0 (the model is a per-image graph)."""
        h, w = cls_prob.shape[1], cls_prob.shape[2]
        return proposal_layer(cls_prob[0], rpn_bbox[0],
                              self.anchors(h, w, cls_prob.device), im_h, im_w,
                              **self.proposal_kw)

    def head(self, conv5_3: torch.Tensor, rois: torch.Tensor):
        """The RoI head on (R, 5) [batch, x1, y1, x2, y2] rows: cls logits
        (R, C), box deltas (R, 4C) and tanh quaternions (R, 4C), fp32."""
        dt = self.compute_dtype
        r = rois.shape[0]
        ones = torch.ones((r, 1), device=rois.device)
        rois7 = torch.cat([rois[:, :1], torch.zeros_like(ones), rois[:, 1:5], ones], dim=1)
        pooled = roi_align(conv5_3, rois7, pooled_size=7,
                           spatial_scale=1.0 / self.feature_stride)
        x = pooled.reshape(r, -1).to(dt)  # NHWC flatten, fc6's row order
        x = F.relu(F.linear(x, self.fc6.weight.to(dt), self.fc6.bias.to(dt)))
        x = F.relu(F.linear(x, self.fc7.weight.to(dt), self.fc7.bias.to(dt)))
        x = x.float()
        return self.cls_score(x), self.bbox_pred(x), torch.tanh(self.pose_pred(x))

    def forward(self, data: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_poses: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, *, train: bool = False,
                noise: Optional[TargetNoise] = None) -> DetectionOutputs:
        """data (1, H, W, 3) mean-subtracted BGR. In training (`train`),
        gt_boxes (G, 5), gt_poses (G, 13), gt_valid (G,) and the targets'
        `noise` are required, and the head runs on the sampled RoIs."""
        im_h, im_w = data.shape[1], data.shape[2]
        conv5_3, rpn_cls, rpn_bbox, cls_prob = self.rpn(data)
        proposals = self.propose(cls_prob, rpn_bbox, im_h, im_w)
        anchor_targets = proposal_targets = None
        rois = proposals.rois
        if train:
            if gt_boxes is None or noise is None:
                raise ValueError("train mode needs gt_boxes and the targets' noise")
            anchors = self.anchors(rpn_cls.shape[1], rpn_cls.shape[2], data.device)
            anchor_targets = anchor_target_layer(anchors, gt_boxes, gt_valid, im_h, im_w,
                                                 noise.anchor_fg, noise.anchor_bg,
                                                 **self.anchor_kw)
            proposal_targets = proposal_target_layer(proposals, gt_boxes, gt_poses, gt_valid,
                                                     self.num_classes, noise.roi_fg,
                                                     noise.roi_bg, **self.roi_kw)
            rois = proposal_targets.rois
        cls_logits, bbox_pred, poses_pred = self.head(conv5_3, rois)
        return DetectionOutputs(rpn_cls, rpn_bbox, proposals, cls_logits, bbox_pred, poses_pred,
                                anchor_targets, proposal_targets)


def detection_losses(out: DetectionOutputs, num_classes: int,
                     points: Optional[torch.Tensor] = None,
                     symmetry: Optional[torch.Tensor] = None) -> dict:
    """The train_net_det loss terms and their sum under "loss"
    (`posecnn_tpu/models/detection.py:170`); the pose term "loss_pose"
    when points (C, P, 3) and symmetry (C,) are given."""
    at, pt = out.anchor_targets, out.proposal_targets
    a2 = out.rpn_cls_logits.shape[-1] // 2
    # (h, w, 2, A) → (h·w·A, 2): each anchor's (bg, fg) pair
    logits = out.rpn_cls_logits.reshape(-1, 2, a2).movedim(1, -1).reshape(-1, 2)
    mask = at.labels >= 0
    picked = F.log_softmax(logits, dim=-1).gather(1, at.labels.clamp(0, 1)[:, None])[:, 0]
    rpn_cls_loss = -torch.sum(picked * mask) / torch.clamp(mask.sum(), min=1)
    # summed over anchors, the outside weights carrying 1/num_examples
    rpn_box_loss = smooth_l1_loss(out.rpn_bbox_pred.reshape(1, -1),
                                  at.bbox_targets.reshape(1, -1),
                                  at.bbox_inside_weights.reshape(1, -1),
                                  at.bbox_outside_weights.reshape(1, -1), sigma=3.0)
    picked_c = F.log_softmax(out.cls_logits, dim=-1).gather(1, pt.labels[:, None])[:, 0]
    vmask = pt.valid.float()
    rcnn_cls_loss = -torch.sum(picked_c * vmask) / torch.clamp(vmask.sum(), min=1)
    rcnn_box_loss = smooth_l1_loss(out.bbox_pred, pt.bbox_targets, pt.bbox_inside_weights,
                                   pt.bbox_outside_weights)
    total = rpn_cls_loss + rpn_box_loss + rcnn_cls_loss + rcnn_box_loss
    metrics = {"rpn_cls": rpn_cls_loss, "rpn_box": rpn_box_loss, "rcnn_cls": rcnn_cls_loss,
               "rcnn_box": rcnn_box_loss}
    if points is not None and symmetry is not None:
        masked = out.poses_pred * pt.pose_weights
        norm = torch.sqrt(torch.sum(masked * masked, dim=1, keepdim=True) + 1e-12)
        pose_loss = average_distance_loss(masked / norm, pt.pose_targets, pt.pose_weights,
                                          points, symmetry, num_valid=vmask.sum())
        metrics["loss_pose"] = pose_loss
        total = total + pose_loss
    metrics["loss"] = total
    return metrics
