"""Recurrent multi-frame video segmentation (counterpart of
`posecnn_tpu/models/recurrent.py`).

Per frame: the VGG16 trunk and the two-scale skip features (1×1 convs to
`num_units` at 1/16 and 1/8, ×2 then ×8 bilinear upsampling), the hidden
state of the previous frame warped into this one by `ops/flow.compute_flow`
(depth and relative camera pose from the meta blob), fused by a cell of
`FUSION_CELLS`, then the 1×1 class score. The JAX model runs the frames
under `nn.scan` with the parameters broadcast; here a Python loop over T
calls the same modules each frame, and autograd differentiates through
time. The parameters keep the JAX tree's names (`trunk`, `score_conv4`,
`score_conv5`, `fusion`, `score`).

Cells (NHWC inputs, state and weights):

  gru2d           the reference's running weighted average: u = σ(gate([x, h])),
                  w' = w + u, h' = relu((w·h + u·x) / w'); the gate's kernel
                  starts at zero
  gru2d_original  reset/update gates (kernel 0, bias 1) and a tanh candidate
  vanilla2d       h' = tanh(conv3×3([x, h]))
  add2d           the parameter-free running mean (the step count rides the weights)

`GRU3DCell` is the voxel-grid cell (B, G, G, G, C) with a validity flag.
The models run in fp32 unless given `compute_dtype`; the JAX trainer and
`test_video` build them without one, so they run fp32 on the card too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from posecnn_torch.models.vgg16 import VGG16Trunk, bilinear_upsample
from posecnn_torch.ops.flow import compute_flow


class VideoState(NamedTuple):
    state: torch.Tensor  # (B, H, W, U)
    weights: torch.Tensor  # (B, H, W, U)
    points: torch.Tensor  # (B, H, W, 3)


def pointwise(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A 1×1 (×1) conv `layer` on a channels-last tensor, in `dtype`."""
    return F.linear(x.to(dtype), layer.weight.flatten(1).to(dtype), layer.bias.to(dtype))


class FusionCell(nn.Module):
    """The reference's GRU2D running weighted-average fusion (gru2d.py:25-61)."""

    def __init__(self, num_units: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.gate = nn.Conv2d(2 * num_units, num_units, 1)

    def flax_init(self):
        nn.init.zeros_(self.gate.weight)

    def forward(self, inputs, state, weights):
        xs = torch.cat([inputs, state], -1)
        u = torch.sigmoid(pointwise(xs, self.gate, self.compute_dtype))
        new_w = weights + u
        new_h = F.relu((weights * state + u * inputs) / torch.clamp(new_w, min=1e-10))
        return new_h, new_w


class GRUOriginalCell(nn.Module):
    """Convolutional GRU (gru2d_original.py:23-58): h' = u·h + (1 − u)·c;
    the weights pass through."""

    def __init__(self, num_units: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.gates = nn.Conv2d(2 * num_units, 2 * num_units, 1)
        self.candidate = nn.Conv2d(2 * num_units, num_units, 1)

    def flax_init(self):
        nn.init.zeros_(self.gates.weight)
        nn.init.ones_(self.gates.bias)

    def forward(self, inputs, state, weights):
        ru = torch.sigmoid(pointwise(torch.cat([inputs, state], -1), self.gates,
                                     self.compute_dtype))
        r, u = ru.chunk(2, dim=-1)
        c = torch.tanh(pointwise(torch.cat([inputs, r * state], -1), self.candidate,
                                 self.compute_dtype))
        return u * state + (1 - u) * c, weights


class Vanilla2DCell(nn.Module):
    """h' = tanh(conv3×3([x, h])) (vanilla2d.py:23-40); weights pass through."""

    def __init__(self, num_units: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(2 * num_units, num_units, 3, padding=1)

    def forward(self, inputs, state, weights):
        dt = self.compute_dtype
        xs = torch.cat([inputs, state], -1).permute(0, 3, 1, 2).to(dt)
        y = F.conv2d(xs, self.conv.weight.to(dt), self.conv.bias.to(dt), padding=1)
        return torch.tanh(y.permute(0, 2, 3, 1)), weights


class Add2DCell(nn.Module):
    """Running mean h' = (x + n·h)/(n + 1) (add2d.py:20-24); n rides the weights."""

    def __init__(self, num_units: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()

    def forward(self, inputs, state, weights):
        return (inputs + weights * state) / (weights + 1.0), weights + 1.0


class GRU3DCell(nn.Module):
    """Voxel-grid GRU (gru3d.py:24-63): u = σ(gate([x, h])),
    h' = flag·relu(u·h + (1 − u)·x) + (1 − flag)·h, on (B, G, G, G, U)."""

    def __init__(self, num_units: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.gate = nn.Conv3d(2 * num_units, num_units, 1)

    def flax_init(self):
        nn.init.zeros_(self.gate.weight)

    def forward(self, inputs, flag, state):
        u = torch.sigmoid(pointwise(torch.cat([inputs, state], -1), self.gate,
                                    self.compute_dtype))
        new_state = flag * F.relu(u * state + (1 - u) * inputs)
        return new_state + (1.0 - flag) * state


FUSION_CELLS = {
    "gru2d": FusionCell,
    "gru2d_original": GRUOriginalCell,
    "vanilla2d": Vanilla2DCell,
    "add2d": Add2DCell,
}


class RecurrentSegNet(nn.Module):
    """Frame-recurrent semantic segmentation (ref: vgg16.py:41-166)."""

    JAX_TRUNK = "trunk"

    def __init__(self, num_classes: int, num_units: int = 64, flow_kernel_size: int = 3,
                 flow_threshold: float = 0.02, flow_max_weight: float = 50.0,
                 cell_type: str = "gru2d", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_units = num_units
        self.flow = dict(kernel_size=flow_kernel_size, threshold=flow_threshold,
                         max_weight=flow_max_weight)
        self.compute_dtype = compute_dtype
        self.trunk = VGG16Trunk(compute_dtype=compute_dtype)
        self.score_conv5 = nn.Conv2d(512, num_units, 1)
        self.score_conv4 = nn.Conv2d(512, num_units, 1)
        self.fusion = FUSION_CELLS[cell_type](num_units, compute_dtype)
        self.score = nn.Conv2d(num_units, num_classes, 1)

    def frame_features(self, data: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, H', W', U) fp32 skip features at full size."""
        dt = self.compute_dtype
        conv4_3, conv5_3 = self.trunk(data)
        s5_up = bilinear_upsample(F.relu(pointwise(conv5_3, self.score_conv5, dt)), 2)
        s4 = F.relu(pointwise(conv4_3, self.score_conv4, dt))
        s5_up = s5_up[:, : s4.shape[1], : s4.shape[2]]
        return bilinear_upsample(s4 + s5_up, 8).float()

    def initial_state(self, b: int, h: int, w: int, device) -> VideoState:
        zeros = torch.zeros((b, h, w, self.num_units), dtype=torch.float32, device=device)
        return VideoState(zeros, zeros.clone(),
                          torch.zeros((b, h, w, 3), dtype=torch.float32, device=device))

    def step(self, carry: VideoState, data, depth, meta):
        """One frame: features, the state warp, fusion and the class score."""
        feats = self.frame_features(data)
        warped_state, warped_weights, points = compute_flow(
            carry.state, carry.weights, carry.points, depth, meta, **self.flow)
        fused, new_w = self.fusion(feats, warped_state, warped_weights)
        logits = pointwise(fused, self.score, self.compute_dtype).float()
        return VideoState(fused, new_w, points), (F.log_softmax(logits, -1), logits.argmax(-1))

    def forward(self, frames: torch.Tensor, depths: torch.Tensor, metas: torch.Tensor,
                initial_state: Optional[VideoState] = None):
        """frames (T, B, H, W, 3), depths (T, B, H, W), metas (T, B, 48) →
        (log_probs (T, B, H, W, C), labels (T, B, H, W), final VideoState)."""
        t, b, h, w, _ = frames.shape
        carry = initial_state or self.initial_state(b, h, w, frames.device)
        log_probs, labels = [], []
        for i in range(t):
            carry, (lp, lab) = self.step(carry, frames[i], depths[i], metas[i])
            log_probs.append(lp)
            labels.append(lab)
        return torch.stack(log_probs), torch.stack(labels), carry
