"""Recurrent-state flow warping for the video family.

Counterpart of `posecnn_tpu/ops/flow.py:23-89` (the reference's
`Computeflow` op): each current-frame pixel with depth is backprojected
with K⁻¹ (meta[9:18]), moved by pose_live2world (meta[30:42]) into the
previous frame, projected with K (meta[0:9]), and the previous hidden
state and weights are averaged over the (2k+1)² neighbourhood of the
rounded projection, gated by depth consistency |Z_prev − Z1| < threshold.
Pixels with no match keep weight 1; the matched weights are clamped at
`max_weight`. Also returns the current frame's camera-frame point map.

The 49 shifts (k = 3) are gathers of the flattened state by one int64
index a shift. The gathered state is multiplied by a 0/1 mask that needs
no gradient, so autograd keeps the index and the mask of each shift, not
the gathered (B, H, W, U) state; the gradient reaches the previous step's
state and weights through the gathers' backward (an index accumulation).
A pixel the mask drops reads its own position instead of its clamped
projection: the product is the same 0, but every pixel without depth
projects to one point (the translation), and the backward's accumulation,
which serialises on a repeated index, would spend a minute a step on the
card summing their zeros.

Rounding: `torch.round` and `jnp.round` both round half to even. The
projection is clamped to ±(max(H, W) + k + 1) before the cast to an
integer: every such value is out of bounds for every shift, as JAX's
saturating cast leaves it, where torch's cast of a huge float is
undefined.
"""

from __future__ import annotations

import torch


def compute_flow(state: torch.Tensor, weights: torch.Tensor, points_prev: torch.Tensor,
                 depth: torch.Tensor, meta_data: torch.Tensor, *, kernel_size: int = 3,
                 threshold: float = 0.02, max_weight: float = 50.0):
    """state, weights (B, H, W, U); points_prev (B, H, W, 3); depth (B, H, W)
    metres; meta_data (B, 48) → (warped_state, warped_weights, points)."""
    b, h, w = depth.shape
    dev = depth.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    kinv = meta_data[:, 9:18].reshape(b, 3, 3)
    k = meta_data[:, 0:9].reshape(b, 3, 3)
    live2world = meta_data[:, 30:42].reshape(b, 3, 4)

    def row(m, i):
        return (m[:, i, 0, None, None] * xs + m[:, i, 1, None, None] * ys
                + m[:, i, 2, None, None])

    px_cam = torch.stack([depth * row(kinv, 0), depth * row(kinv, 1), depth * row(kinv, 2)], -1)
    xyz1 = (torch.einsum("bij,bhwj->bhwi", live2world[:, :, :3], px_cam)
            + live2world[:, None, None, :, 3])
    proj = torch.einsum("bij,bhwj->bhwi", k, xyz1)
    z = torch.clamp(proj[..., 2], min=1e-10)
    lim = float(max(h, w) + kernel_size + 1)
    u = torch.round(torch.clamp(proj[..., 0] / z, -lim, lim)).long()
    v = torch.round(torch.clamp(proj[..., 1] / z, -lim, lim)).long()
    z_target = xyz1[..., 2]
    has_depth = depth > 1e-6

    units = state.shape[-1]
    state_flat = state.reshape(-1, units)
    weights_flat = weights.reshape(-1, units)
    z_prev_flat = points_prev[..., 2].reshape(-1)
    base = torch.arange(b, device=dev)[:, None, None] * (h * w)
    own = base + torch.arange(h * w, device=dev).reshape(h, w)
    acc_state = torch.zeros_like(state)
    acc_weight = torch.zeros_like(weights)
    count = torch.zeros((b, h, w, 1), dtype=state.dtype, device=dev)
    for dy in range(-kernel_size, kernel_size + 1):
        for dx in range(-kernel_size, kernel_size + 1):
            uu, vv = u + dx, v + dy
            inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            lin = base + vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)
            ok = inb & has_depth & ((z_prev_flat[lin] - z_target).abs() < threshold)
            lin = torch.where(ok, lin, own)
            okf = ok[..., None].to(state.dtype)
            acc_state = acc_state + state_flat[lin] * okf
            acc_weight = acc_weight + weights_flat[lin] * okf
            count = count + okf

    denom = torch.clamp(count, min=1.0)
    warped_state = acc_state / denom
    # no match keeps weight 1 (the reference initialises the output
    # weights to 1 and writes them only on a match)
    warped_weights = torch.where(count > 0, torch.clamp(acc_weight / denom, max=max_weight),
                                 1.0)
    return warped_state, warped_weights, px_cam
