"""GAN models (counterpart of `posecnn_tpu/models/gan.py`).

`FeatureDiscriminator` is the PatchGAN head of the adversarial
vertex-map step (`engine/train.GanTrainStep`): it scores
[255·vertex map ‖ image] per patch. `DCGANGenerator` and
`DCGANDiscriminator` are the dcgan pair. All take and return NHWC
tensors, as the flax modules do, and run in `compute_dtype` with fp32
parameters (fp32 by default, as the JAX modules are built).

Translation notes:
- flax's SAME padding at stride 2 is asymmetric: a 3×3 window on an even
  side pads (0, 1), a 4×4 one (1, 1); `same_pad` splits it explicitly.
- flax's `ConvTranspose` (padding SAME, `transpose_kernel=False`) is a
  convolution of the input dilated by the stride, padded k + s − 2 split
  (2, 2) for k = 4, s = 2, with the kernel as stored (HWIO, not flipped).
  The port keeps that kernel as a `Conv2d` weight (OIHW, the weight
  bridge's usual transpose) and calls `conv_transpose2d` with it flipped
  and its two channel axes swapped, at padding k − 1 − 2 = 1: the same
  sums.
- flax's GroupNorm uses ε = 1e-6 (torch's default is 1e-5).
- the generator's `project` Dense output is reshaped (B, 4, 4, f) NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.resnet50 import same_pad
from posecnn_torch.models.vgg16 import nchw, nhwc

GN_EPS = 1e-6


def conv_same(x: torch.Tensor, layer: nn.Conv2d, stride: int, dtype: torch.dtype):
    """`layer` with its bias on an NCHW tensor in `dtype`, flax's SAME
    padding at `stride`."""
    k = layer.kernel_size[0]
    return F.conv2d(same_pad(x.to(dtype), k, stride), layer.weight.to(dtype),
                    layer.bias.to(dtype), stride=stride)


def conv_transpose_same(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype):
    """flax `ConvTranspose(k=4, strides=2, padding="SAME")` of an NCHW
    tensor, `layer.weight` holding flax's kernel as OIHW: ×2 the side."""
    w = layer.weight.to(dtype).flip(2, 3).transpose(0, 1)
    return F.conv_transpose2d(x.to(dtype), w, layer.bias.to(dtype), stride=2, padding=1)


class FeatureDiscriminator(nn.Module):
    """conv 3×3/2 → 256, leaky ReLU 0.2, conv 3×3/2 → 128, leaky ReLU,
    conv 3×3 → 1 logit in fp32 (`gan.py:66-82`)."""

    def __init__(self, in_channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, 256, 3)
        self.conv2 = nn.Conv2d(256, 128, 3)
        self.logit = nn.Conv2d(128, 1, 3)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.leaky_relu(conv_same(nchw(feats), self.conv1, 2, dt), 0.2)
        x = F.leaky_relu(conv_same(x, self.conv2, 2, dt), 0.2)
        return nhwc(conv_same(x, self.logit, 1, torch.float32))


class DCGANGenerator(nn.Module):
    """z (B, Z) → tanh image (B, 64, 64, out_channels): Dense to 4×4×f,
    three ×2 transposed convs with GroupNorm(8) and ReLU, one to the
    output (`gan.py:20-43`)."""

    def __init__(self, latent_dim: int, out_channels: int = 3, base_features: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = base_features
        self.base_features = f
        self.compute_dtype = compute_dtype
        self.project = nn.Linear(latent_dim, 4 * 4 * f)
        widths = (f, f // 2, f // 4, f // 8)
        for i in range(3):
            self.add_module(f"deconv{i + 1}", nn.Conv2d(widths[i], widths[i + 1], 4))
            self.add_module(f"norm{i + 1}", nn.GroupNorm(8, widths[i + 1], eps=GN_EPS))
        self.deconv_out = nn.Conv2d(widths[3], out_channels, 4)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        f = self.base_features
        x = F.linear(z.to(dt), self.project.weight.to(dt), self.project.bias.to(dt))
        x = nchw(F.relu(x.reshape(z.shape[0], 4, 4, f)))
        for i in range(3):
            x = conv_transpose_same(x, getattr(self, f"deconv{i + 1}"), dt)
            x = F.relu(getattr(self, f"norm{i + 1}")(x))
        return nhwc(torch.tanh(conv_transpose_same(x, self.deconv_out, dt)))


class DCGANDiscriminator(nn.Module):
    """image (B, 64, 64, C) → (B, 1) logit: four 4×4/2 convs with leaky
    ReLU 0.2, then Dense over the NHWC flatten in fp32 (`gan.py:46-63`)."""

    def __init__(self, in_channels: int = 3, base_features: int = 64, image_size: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = base_features
        self.compute_dtype = compute_dtype
        widths = (in_channels, f, f * 2, f * 4, f * 8)
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Conv2d(widths[i], widths[i + 1], 4))
        side = image_size
        for _ in range(4):
            side = -(-side // 2)
        self.logit = nn.Linear(side * side * f * 8, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = nchw(x)
        for i in range(4):
            x = F.leaky_relu(conv_same(x, getattr(self, f"conv{i + 1}"), 2, dt), 0.2)
        return self.logit(nhwc(x).reshape(x.shape[0], -1).float())


def gan_losses(real_logits: torch.Tensor, fake_logits: torch.Tensor):
    """Non-saturating losses (`gan.py:85-93`): d_loss = E softplus(−real)
    + E softplus(fake), g_loss = E softplus(−fake)."""
    d_loss = F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()
    return d_loss, F.softplus(-fake_logits).mean()
