"""FCN-8s semantic segmentation (counterpart of `posecnn_tpu/models/fcn8.py`).

VGG16 with fc6/fc7 as convolutions on a 2×2/2 SAME max pool of conv5_3
(1/32), score layers at 1/32 (`score_fr`), 1/16 (`score_pool5`, on
conv5_3) and 1/8 (`score_pool4`, on conv4_3), fused by two frozen ×2
bilinear upsamplings, each cropped to the next score map, and a final ×8.
Convs run in `compute_dtype` (bf16 on the card), the logits in fp32.

Dropout: the JAX model drops fc6 and fc7 only below `keep_prob` 1, and
its segmentation step never passes one, so neither model drops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import VGG16Trunk, bilinear_upsample, conv, nchw, nhwc


class FCN8(nn.Module):
    JAX_TRUNK = "trunk"

    def __init__(self, num_classes: int, fc_dim: int = 4096,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.trunk = VGG16Trunk(compute_dtype=compute_dtype)
        self.fc6 = nn.Conv2d(512, fc_dim, 7, padding=3)  # flax SAME, stride 1
        self.fc7 = nn.Conv2d(fc_dim, fc_dim, 1)
        self.score_fr = nn.Conv2d(fc_dim, num_classes, 1)
        self.score_pool5 = nn.Conv2d(512, num_classes, 1)
        self.score_pool4 = nn.Conv2d(512, num_classes, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, 3) → (log_prob (B, H', W', C) fp32, label (B, H', W')
        int64), H' = 8 · ceil(H / 8)."""
        dt = self.compute_dtype
        conv4_3, conv5_3 = (nchw(f) for f in self.trunk(x))
        # 2×2/2 SAME: ceil mode pads the end of an odd side with −inf
        pool5 = F.max_pool2d(conv5_3, 2, 2, ceil_mode=True)
        y = F.relu(conv(pool5, self.fc6, dt))
        y = F.relu(conv(y, self.fc7, dt))
        score32 = nhwc(conv(y, self.score_fr, dt))
        score16 = nhwc(conv(conv5_3, self.score_pool5, dt))
        score8 = nhwc(conv(conv4_3, self.score_pool4, dt))
        up32 = bilinear_upsample(score32, 2)[:, : score16.shape[1], : score16.shape[2]]
        up16 = bilinear_upsample(score16 + up32, 2)[:, : score8.shape[1], : score8.shape[2]]
        logits = bilinear_upsample(score8 + up16, 8).float()
        return F.log_softmax(logits, dim=-1), logits.argmax(-1)
