"""Non-maximum suppression with fixed shapes.

Counterpart of `posecnn_tpu/ops/nms.py`: greedy descending-score
suppression with the reference's +1 area convention, returning a keep
mask aligned with the input rows. `nms` is class-agnostic (the RPN's
proposals, the detection head's per-class boxes); `nms_per_class`
suppresses only within each (batch, class) pair of Hough RoIs.

The (N, N) suppression matrix is built on the device in one pass. The
greedy scan over the score-sorted rows, which JAX runs as a `lax.scan`
(`posecnn_tpu/ops/nms.py:34-40`), runs where the matrix is:
`greedy_scan` launches the CUDA kernel `nms_scan_kernel`
(`csrc/nms_scan.cu`) for a CUDA tensor, with no host read, so that a
CUDA graph captures it (the detection family's compiled training step
and `test_net` programs), and takes its plain PyTorch version,
`greedy_scan_plain`, for a tensor on the CPU; the two agree bit for bit.
Nothing falls back: a failed build or launch raises. `nms` runs the
scan so. A row that is still alive suppresses the later rows it
overlaps; equal scores keep their input order (a stable sort, as
`jnp.argsort`). `per_class_suppression` is the device part of
`nms_per_class`, which the serving, demo and posecnn `test_net`
forwards capture; `greedy_keep`, their scan after it, still runs on the
host over the matrix, fetched once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from posecnn_torch.ops import _cuda
from posecnn_torch.utils.bbox import box_iou


class Suppression(NamedTuple):
    """NMS's device part over (…, N) rows: `order`, the score-sorted row
    indices; `kill[…, i, j]`, that sorted row i, if kept, suppresses
    sorted row j (j > i); `sorted_valid`, the valid mask in sorted order."""

    order: torch.Tensor
    kill: torch.Tensor
    sorted_valid: torch.Tensor


def greedy_keep(suppression: Suppression) -> torch.Tensor:
    """The greedy scan over the sorted rows, on the host after one fetch.
    Returns the (…, N) keep mask in the input order, on the device of
    `order`."""
    order, kill, sorted_valid = suppression
    n = order.shape[-1]
    kill_np = kill.cpu().numpy().reshape(-1, n, n)
    valid_np = sorted_valid.cpu().numpy().reshape(-1, n)
    kept = np.zeros(valid_np.shape, bool)
    for b in range(kept.shape[0]):
        suppressed = ~valid_np[b]
        for i in range(n):
            if not suppressed[i]:
                kept[b, i] = True
                suppressed |= kill_np[b, i]
    kept_t = torch.from_numpy(kept.reshape(order.shape)).to(order.device)
    return torch.zeros_like(kept_t).scatter(-1, order, kept_t)


def greedy_scan_plain(kill: torch.Tensor, sorted_valid: torch.Tensor) -> torch.Tensor:
    """`greedy_scan` in PyTorch ops, one sorted row at a time, on any
    device: kill (…, N, N) bool, sorted_valid (…, N) bool → kept_sorted
    (…, N) bool (`lax.scan`'s `step`, `posecnn_tpu/ops/nms.py:34-37`)."""
    suppressed = ~sorted_valid
    kept = torch.zeros_like(sorted_valid)
    for i in range(kill.shape[-1]):
        alive = ~suppressed[..., i]
        kept[..., i] = alive
        suppressed = suppressed | (kill[..., i, :] & alive[..., None])
    return kept


def greedy_scan(kill: torch.Tensor, sorted_valid: torch.Tensor) -> torch.Tensor:
    """The greedy scan over the score-sorted rows, each leading index its
    own: a valid row not yet suppressed is kept and suppresses the later
    rows it kills. kill (…, N, N) bool (`Suppression.kill`), sorted_valid
    (…, N) bool → kept_sorted (…, N) bool, in sorted order. On a CUDA
    tensor one launch of `nms_scan_kernel`; on the CPU `greedy_scan_plain`."""
    if kill.device.type == "cpu":
        return greedy_scan_plain(kill, sorted_valid)
    n = kill.shape[-1]
    batch = sorted_valid.numel() // n if n else 0
    if kill.shape[-2:] != (n, n) or sorted_valid.shape != kill.shape[:-1]:
        raise ValueError(f"greedy_scan: kill (…, N, N) and sorted_valid (…, N), got "
                         f"{tuple(kill.shape)} and {tuple(sorted_valid.shape)}")
    for name, t in (("kill", kill), ("sorted_valid", sorted_valid)):
        if t.dtype != torch.bool or not t.is_contiguous() or t.device != kill.device:
            raise ValueError(f"greedy_scan: {name} must be a contiguous bool tensor on "
                             f"{kill.device}, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    kept = torch.empty_like(sorted_valid)
    if kept.numel() == 0:
        return kept
    packed = torch.empty((batch, n, -(-n // 32)), dtype=torch.int32, device=kill.device)
    lib = _cuda.library("nms_scan")
    with torch.cuda.device(kill.device):
        status = lib.nms_scan(kill.data_ptr(), sorted_valid.data_ptr(), kept.data_ptr(),
                              packed.data_ptr(), batch, n,
                              _cuda.device_counter(kill.device, "scan"),
                              torch.cuda.current_stream().cuda_stream)
    _cuda.check(status, "nms_scan_kernel")
    _cuda.count("scan")
    return kept


def _sorted(scores: torch.Tensor, valid: torch.Tensor):
    """Descending-score order with invalid rows last; stable on ties."""
    return torch.argsort(-torch.where(valid, scores, float("-inf")), dim=-1, stable=True)


def _later(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(diagonal=1)


@torch.no_grad()
def box_suppression(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
                    valid: Optional[torch.Tensor] = None) -> Suppression:
    """The device part of `nms`: boxes (…, N, 4) xyxy, scores (…, N), valid
    (…, N) bool; each leading index its own rows."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    valid = valid.expand(scores.shape)
    order = _sorted(scores, valid)
    sb = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    kill = (box_iou(sb, sb) > threshold) & _later(n, boxes.device)
    return Suppression(order, kill, valid.gather(-1, order))


@torch.no_grad()
def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes (…, N, 4) xyxy, scores (…, N), valid (…, N) bool. Returns the
    (…, N) bool keep mask, each leading index an independent NMS
    (`posecnn_tpu/ops/nms.py:20`; the detection head runs one per class),
    on the device of `boxes`, with no host read: `box_suppression`, then
    `greedy_scan`."""
    order, kill, sorted_valid = box_suppression(boxes, scores, threshold, valid)
    kept = greedy_scan(kill, sorted_valid)
    return torch.zeros_like(kept).scatter(-1, order, kept)


@torch.no_grad()
def per_class_suppression(rois: torch.Tensor, threshold: float,
                          valid: Optional[torch.Tensor] = None) -> Suppression:
    """The device part of `nms_per_class`: rois (R, 7) Hough format,
    valid (R,) bool; suppression only within each (batch, class) pair."""
    n = rois.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=rois.device)
    order = _sorted(rois[:, 6], valid)
    sr = rois[order]
    key = sr[:, :2].long()
    same = (key[:, None, :] == key[None, :, :]).all(-1)
    kill = same & (box_iou(sr[:, 2:6], sr[:, 2:6]) > threshold) & _later(n, rois.device)
    return Suppression(order, kill, valid[order])


def nms_per_class(rois: torch.Tensor, threshold: float, valid: Optional[torch.Tensor] = None):
    """rois: (R, 7) Hough format; valid: (R,) bool. Returns (R,) bool
    (`posecnn_tpu/ops/nms.py:44`)."""
    return greedy_keep(per_class_suppression(rois, threshold, valid))
