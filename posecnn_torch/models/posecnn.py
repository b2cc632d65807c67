"""PoseCNN: the flagship 6D pose estimation network, inference path.

Counterpart of `posecnn_tpu/models/posecnn.py:53-164, 184-382` for the
COLOR-input eval forward the server runs:

  trunk      VGG16 conv1_1..conv5_3
  seg head   1×1 score convs on conv4_3/conv5_3, ×2 up of the conv5
             score, sum, 1×1 → C, ×8 up; log-softmax and argmax in fp32
  vertex     the same skip topology with 128 channels, 1×1 → 3C, kept at
             1/8 resolution for Hough (full resolution only on request)
  hough      ops.hough_voting on the argmax labels (single instance)
  pose head  dual-scale RoI pool → fc6 → fc7 → fc8 (fp32) → class mask →
             L2 normalise

Dtype policy: fp32 parameters; `compute_dtype` (bf16 on the card, fp32
on the CPU) casts each conv's and dense layer's inputs and weights, as
flax's `dtype=` does. Scores are cast to fp32 before the softmax, the
vertex map before Hough, and fc8 runs in fp32.

Still to port: `DomainHead`, the RGBD tower, dropout, training emission
and `append_gt_rois`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import VGG16Trunk, bilinear_upsample, conv, nchw, nhwc
from posecnn_torch.ops.hough_voting import HoughOutputs, hough_voting
from posecnn_torch.ops.roi_align import roi_pool_fused


class PoseCNNOutputs(NamedTuple):
    log_prob: torch.Tensor  # (B, H, W, C) log-softmax seg scores
    prob: torch.Tensor  # (B, H, W, C) softmax
    label_2d: torch.Tensor  # (B, H, W) argmax labels
    vertex_pred: Optional[torch.Tensor]  # (B, H, W, 3C), with full_vertex=True
    hough: HoughOutputs
    poses_pred: torch.Tensor  # (R, 4C) masked unit quaternions
    poses_tanh: torch.Tensor  # (R, 4C) raw fc8 output (after tanh if chosen)


class SkipHead(nn.Module):
    """Two-scale FCN skip head (`posecnn.py:53-94`). NHWC in and out."""

    def __init__(self, in_channels: int, units: int, out_channels: int, *,
                 relu_scores: bool = True, name_prefix: str = "score",
                 return_lowres: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu_scores = relu_scores
        self.prefix = name_prefix
        self.return_lowres = return_lowres
        self.compute_dtype = compute_dtype
        self.add_module(f"{name_prefix}_conv5", nn.Conv2d(in_channels, units, 1))
        self.add_module(f"{name_prefix}_conv4", nn.Conv2d(in_channels, units, 1))
        self.add_module(f"{name_prefix}_out", nn.Conv2d(units, out_channels, 1))

    def forward(self, conv4_3: torch.Tensor, conv5_3: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        act = F.relu if self.relu_scores else (lambda v: v)
        s5 = act(conv(nchw(conv5_3), getattr(self, f"{self.prefix}_conv5"), dt))
        s5_up = nchw(bilinear_upsample(nhwc(s5), 2))
        s4 = act(conv(nchw(conv4_3), getattr(self, f"{self.prefix}_conv4"), dt))
        # crop to the 1/8 map when H/8 or W/8 is odd (posecnn.py:78)
        added = s4 + s5_up[:, :, : s4.shape[2], : s4.shape[3]]
        # the 1×1 conv runs before the ×8 upsample (they commute)
        out = nhwc(conv(added, getattr(self, f"{self.prefix}_out"), dt))
        return out if self.return_lowres else bilinear_upsample(out, 8)


class PoseHead(nn.Module):
    """RoI → quaternion regression head (`posecnn.py:97-164`), eval."""

    def __init__(self, num_classes: int, in_features: int, fc_dim: int = 4096, *,
                 norm_features: bool = True, quat_activation: str = "linear",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if quat_activation not in ("linear", "tanh"):
            raise ValueError(f"unknown quat_activation {quat_activation!r}")
        self.norm_features = norm_features
        self.quat_activation = quat_activation
        self.compute_dtype = compute_dtype
        self.fc6 = nn.Linear(in_features, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        self.fc8 = nn.Linear(fc_dim, 4 * num_classes)

    def forward(self, pooled: torch.Tensor, poses_weight: torch.Tensor):
        dt = self.compute_dtype
        # NHWC flatten, the order fc6's rows were trained in (posecnn.py:134)
        x = pooled.reshape(pooled.shape[0], -1).float()
        if self.norm_features:
            x = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-6)
        x = F.relu(F.linear(x.to(dt), self.fc6.weight.to(dt), self.fc6.bias.to(dt)))
        x = F.relu(F.linear(x, self.fc7.weight.to(dt), self.fc7.bias.to(dt)))
        x = self.fc8(x.float())
        poses_tanh = torch.tanh(x) if self.quat_activation == "tanh" else x
        masked = poses_tanh * poses_weight
        norm = torch.sqrt(torch.sum(masked * masked, dim=1, keepdim=True) + 1e-12)
        return masked / torch.clamp(norm, min=1e-2), poses_tanh


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded initialisation in flax's defaults: every conv and dense
    kernel LeCun-normal (truncated at ±2σ, variance 1/fan_in), every
    bias zero. Draws from a CPU `torch.Generator`; move the model after."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            # 0.8796… is the std of a unit normal truncated at ±2
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
            nn.init.zeros_(mod.bias)


def _eval_pose_weight(hough: HoughOutputs, num_classes: int) -> torch.Tensor:
    """Weight mask selecting each RoI's own class quaternion (`posecnn.py:374-382`)."""
    cls = hough.rois[:, 1].long().clamp(0, num_classes - 1)
    return F.one_hot(cls, num_classes).float().repeat_interleave(4, dim=1)


class PoseCNN(nn.Module):
    """The PoseCNN eval forward. Module names follow the JAX parameter
    tree, so `core.weights.params_from_jax` maps a checkpoint onto it."""

    def __init__(self, num_classes: int, num_units: int = 64, fc_dim: int = 4096, *,
                 hough_num_samples: int = 256, max_objects: int = 16,
                 pose_pool_size: int = 7, norm_features: bool = True,
                 quat_activation: str = "linear",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        # single instance, stride-1 cells, coarse-to-fine votes: the
        # serving configuration (posecnn_tpu/cli/serve.py:70-79)
        self.hough_kw = dict(num_samples=hough_num_samples, max_objects_per_image=max_objects,
                             vertex_factor=8)
        self.pose_pool_size = pose_pool_size
        self.trunk = VGG16Trunk(compute_dtype=compute_dtype)
        self.seg_head = SkipHead(512, num_units, num_classes, relu_scores=True,
                                 name_prefix="score", compute_dtype=compute_dtype)
        self.vertex_head = SkipHead(512, 128, 3 * num_classes, relu_scores=False,
                                    name_prefix="vertex", return_lowres=True,
                                    compute_dtype=compute_dtype)
        self.pose_head = PoseHead(num_classes, pose_pool_size * pose_pool_size * 512, fc_dim,
                                  norm_features=norm_features, quat_activation=quat_activation,
                                  compute_dtype=compute_dtype)

    @torch.inference_mode()
    def forward(self, data: torch.Tensor, extents: torch.Tensor, meta_data: torch.Tensor, *,
                full_vertex: bool = False) -> PoseCNNOutputs:
        """data: (B, H, W, 3) mean-subtracted BGR; extents: (C, 3);
        meta_data: (B, 48). `full_vertex` also returns the ×8-upsampled
        vertex map, which the serving path never reads."""
        conv4_3, conv5_3 = self.trunk(data)
        score = self.seg_head(conv4_3, conv5_3).float()
        log_prob = F.log_softmax(score, dim=-1)
        prob = F.softmax(score, dim=-1)
        label_2d = torch.argmax(score, dim=-1)

        vertex_lr = self.vertex_head(conv4_3, conv5_3).float()
        vertex_pred = bilinear_upsample(vertex_lr, 8) if full_vertex else None
        hough = hough_voting(label_2d, vertex_lr, extents, meta_data, **self.hough_kw)

        pooled = roi_pool_fused(conv4_3, conv5_3, hough.rois, pooled_size=self.pose_pool_size)
        poses_pred, poses_tanh = self.pose_head(
            pooled, _eval_pose_weight(hough, self.num_classes)
        )
        return PoseCNNOutputs(log_prob, prob, label_2d, vertex_pred, hough, poses_pred,
                              poses_tanh)
