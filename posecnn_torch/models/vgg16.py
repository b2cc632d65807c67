"""VGG16 convolutional trunk, the PoseCNN feature extractor.

Counterpart of `posecnn_tpu/models/vgg16.py`: conv1_1..conv5_3 with 2×2
max pools after stages 1-4 (no pool5), returning conv4_3 (1/8) and
conv5_3 (1/16).

Layout: the public functions take and return NHWC tensors, as the JAX
package does. Inside, an NHWC tensor is viewed as NCHW with
`permute(0, 3, 1, 2)`, which is a `channels_last` tensor at no cost, and
cuDNN runs channels_last convolutions natively.

Dtype: parameters stay fp32; `compute_dtype` casts the inputs, weights
and biases of every conv explicitly, as flax's `dtype=` does (bf16 on the
card, fp32 on the CPU for parity).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (filters, num_convs) per stage — VGG16 (posecnn_tpu/models/vgg16.py:26)
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last memory when `x` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → NHWC view (contiguous when `x` is channels_last)."""
    return x.permute(0, 2, 3, 1)


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """`layer` applied in `dtype` to an NCHW tensor, parameters cast per call."""
    return F.conv2d(
        x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype), padding=layer.padding
    )


class VGG16Trunk(nn.Module):
    """Returns (conv4_3, conv5_3) NHWC feature maps at 1/8 and 1/16."""

    def __init__(self, in_channels: int = 3, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        cin = in_channels
        for stage, (filters, num_convs) in enumerate(VGG16_STAGES, start=1):
            for i in range(1, num_convs + 1):
                self.add_module(f"conv{stage}_{i}", nn.Conv2d(cin, filters, 3, padding=1))
                cin = filters

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = nchw(x)
        conv4_3 = None
        for stage, (_, num_convs) in enumerate(VGG16_STAGES, start=1):
            for i in range(1, num_convs + 1):
                x = F.relu(conv(x, getattr(self, f"conv{stage}_{i}"), self.compute_dtype))
            if stage == 4:
                conv4_3 = x
            if stage < 5:
                # 2×2/2 max pool; flax "SAME" pads the end of an odd
                # side, which is what ceil_mode does (vgg16.py:53)
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return nhwc(conv4_3), nhwc(x)


def bilinear_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Frozen bilinear ×factor upsampling of an NHWC tensor.

    Equals `jax.image.resize(..., "linear")` when upsampling
    (`posecnn_tpu/models/vgg16.py:73-85`): half-pixel centres, edges
    clamped to the first and last texel."""
    b, h, w, c = x.shape
    out = F.interpolate(
        nchw(x), size=(h * factor, w * factor), mode="bilinear", align_corners=False
    )
    return nhwc(out)
