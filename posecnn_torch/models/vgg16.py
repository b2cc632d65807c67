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


def bilinear_upsample_kernel(factor: int, channels: int) -> torch.Tensor:
    """The frozen bilinear deconvolution filter (OIHW, one filter per
    channel on the diagonal), kernel size 2·factor for stride `factor`
    (ref: vgg16_convs.py:122,138); the JAX package's is its HWIO form
    (`posecnn_tpu/models/vgg16.py:57`)."""
    size = 2 * factor
    og = torch.arange(size, dtype=torch.float32)
    center = factor - 0.5 if size % 2 == 0 else factor - 1.0
    filt_1d = 1.0 - torch.abs(og - center) / factor
    filt = filt_1d[:, None] * filt_1d[None, :]
    kernel = torch.zeros((channels, channels, size, size), dtype=torch.float32)
    idx = torch.arange(channels)
    kernel[idx, idx] = filt
    return kernel


def _resize_weights(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """(n_out, n_in): `F.interpolate`'s bilinear weights along one axis
    (align_corners False): output i takes 1 − λ of input ⌊s⌋ and λ of the
    next (the last input again at the edge), s = max((i + ½)·n_in/n_out − ½,
    0), λ = s − ⌊s⌋."""
    dst = torch.arange(n_out, device=device, dtype=dtype)
    src = ((dst + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    lo = src.long()
    hi = torch.where(lo < n_in - 1, lo + 1, lo)
    frac = (src - lo)[:, None]
    cols = torch.arange(n_in, device=device)
    return (1 - frac) * (cols == lo[:, None]) + frac * (cols == hi[:, None])


class _Bilinear(torch.autograd.Function):
    """`F.interpolate`'s bilinear resize (NCHW), with its exact adjoint as
    the backward: two matrix products, in fp32 (fp64 for fp64), on every
    device. PyTorch's own backward adds each output's gradient into its
    inputs with atomics on the card, in a device order and in the
    gradient's dtype, so two runs of one bf16 training step there differed
    by up to ~2% of a gradient's largest entry; the adjoint gives the same
    bits on every run, and is the contraction JAX's resize gradient is."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: tuple) -> torch.Tensor:
        ctx.shape, ctx.size = list(x.shape), list(size)
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        wide = torch.float64 if grad.dtype == torch.float64 else torch.float32
        rows = _resize_weights(ctx.shape[2], ctx.size[0], grad.device, wide)
        cols = _resize_weights(ctx.shape[3], ctx.size[1], grad.device, wide)
        return (rows.t() @ grad.to(wide) @ cols).to(grad.dtype), None


def bilinear_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Frozen bilinear ×factor upsampling of an NHWC tensor.

    Equals `jax.image.resize(..., "linear")` when upsampling
    (`posecnn_tpu/models/vgg16.py:73-85`): half-pixel centres, edges
    clamped to the first and last texel. Its gradient is the exact
    adjoint, the same bits on every run (`_Bilinear`)."""
    b, h, w, c = x.shape
    return nhwc(_Bilinear.apply(nchw(x), (h * factor, w * factor)))
