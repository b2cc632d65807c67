"""ResNet50 segmentation backbone (counterpart of `posecnn_tpu/models/resnet50.py`).

Bottleneck blocks with GroupNorm(32) in fp32 around convs in
`compute_dtype` (the JAX model uses GroupNorm, not BatchNorm), and the
two-scale segmentation head of PoseCNN's seg branch on the 1/8 and 1/16
stages.

Padding is flax's SAME, which is not symmetric at stride 2: the
7×7/2 stem pads `total = max((out − 1)·s + k − in, 0)` with `total // 2`
before and the rest after (2 and 3 rows at 480), and the 3×3/2 max pool
pads (0, 1) with −inf at an even side. `same_pad` applies that split
explicitly; 1×1 convs, strided or not, need none.

GroupNorm: eps 1e-6 (flax's; torch's default is 1e-5). Flax computes the
variance as E[x²] − E[x]² in fp32, torch's `group_norm` by a two-pass
formula; the two differ by rounding only (the forward tests hold the
log-probs to 1e-4).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import bilinear_upsample, nchw, nhwc

GN_GROUPS, GN_EPS = 32, 1e-6


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as flax's SAME does for a k×k window at stride s."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def conv_same(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """`layer` (no bias) in `dtype` with flax's SAME padding at its stride."""
    k, s = layer.kernel_size[0], layer.stride[0]
    return F.conv2d(same_pad(x.to(dtype), k, s), layer.weight.to(dtype), stride=s)


def group_norm(x: torch.Tensor, layer: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm in fp32 on `x` cast up, the result cast back to `dtype`."""
    return F.group_norm(x.float(), layer.num_groups, layer.weight.float(), layer.bias.float(),
                        layer.eps).to(dtype)


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, filters, 1, stride=stride, bias=False)
        self.norm1 = _norm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.norm2 = _norm(filters)
        self.conv3 = nn.Conv2d(filters, 4 * filters, 1, bias=False)
        self.norm3 = _norm(4 * filters)
        if in_channels != 4 * filters or stride != 1:
            self.proj = nn.Conv2d(in_channels, 4 * filters, 1, stride=stride, bias=False)
            self.norm_proj = _norm(4 * filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in, NCHW out."""
        dt = self.compute_dtype
        y = F.relu(group_norm(conv_same(x, self.conv1, dt), self.norm1, dt))
        y = F.relu(group_norm(conv_same(y, self.conv2, dt), self.norm2, dt))
        y = group_norm(conv_same(y, self.conv3, dt), self.norm3, dt)
        residual = x
        if hasattr(self, "proj"):
            residual = group_norm(conv_same(x, self.proj, dt), self.norm_proj, dt)
        return F.relu(y + residual)


class ResNet50Trunk(nn.Module):
    """Returns the (1/8, 1/16) NHWC feature maps of stages 2 and 3."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, bias=False)
        self.norm1 = _norm(64)
        cin = 64
        for stage, (blocks, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(blocks):
                stride = 2 if b == 0 and stage > 0 else 1
                self.add_module(f"stage{stage + 1}_block{b + 1}",
                                Bottleneck(cin, f, stride, compute_dtype))
                cin = 4 * f
        self.stage_sizes = tuple(stage_sizes)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        x = nchw(x)
        x = F.relu(group_norm(conv_same(x, self.conv1, dt), self.norm1, dt))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)  # 1/4
        feats = []
        # stage 4 is built (its parameters are the checkpoint's) but its
        # output feeds nothing: the JAX model computes it, and XLA drops it
        for stage, blocks in enumerate(self.stage_sizes[:3]):
            for b in range(blocks):
                x = getattr(self, f"stage{stage + 1}_block{b + 1}")(x)
            feats.append(x)
        return nhwc(feats[1]), nhwc(feats[2])


class ResNet50Seg(nn.Module):
    """ResNet50 and the two-scale segmentation head (ref: resnet50.py)."""

    JAX_TRUNK = "trunk"

    def __init__(self, num_classes: int, num_units: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.trunk = ResNet50Trunk(compute_dtype, stage_sizes)
        self.score_c4 = nn.Conv2d(1024, num_units, 1)
        self.score_c3 = nn.Conv2d(512, num_units, 1)
        self.score = nn.Conv2d(num_units, num_classes, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, 3) → (log_prob (B, H', W', C) fp32, label (B, H', W'))."""
        dt = self.compute_dtype
        c3, c4 = (nchw(f) for f in self.trunk(x))
        s4 = F.relu(F.conv2d(c4, self.score_c4.weight.to(dt), self.score_c4.bias.to(dt)))
        s3 = F.relu(F.conv2d(c3, self.score_c3.weight.to(dt), self.score_c3.bias.to(dt)))
        s4_up = bilinear_upsample(nhwc(s4), 2)[:, : s3.shape[2], : s3.shape[3]]
        up = nchw(bilinear_upsample(nhwc(s3) + s4_up, 8)).float()
        logits = nhwc(F.conv2d(up, self.score.weight.float(), self.score.bias.float()))
        return F.log_softmax(logits, dim=-1), logits.argmax(-1)
