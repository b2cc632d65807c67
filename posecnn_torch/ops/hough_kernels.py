"""Hough vote accumulation: the CUDA kernels, their wrappers, their plain
PyTorch versions and the coarse-to-fine glue.

Counterpart of `posecnn_tpu/ops/hough_pallas.py`. Two of its three
Pallas kernels are on the serving path and are ported here, to
`posecnn_torch/csrc/hough_vote.cu` (its header says what bounds them on
the card and what the design does about it):

  hough_votes_flat     → flat_vote_kernel    (was _flat_vote_kernel, :191-330)
  hough_votes_windows  → window_vote_kernel  (was _window_vote_kernel, :333-415,
                                              called in hough_votes_c2f_windows)

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in `LAUNCHES`; a failed build or launch raises. Only a tensor on the CPU
takes the plain version (`*_plain`), which is also what the tests and
`chip_smoke.py` hold the kernels against. The plain versions accumulate
sample by sample with the kernels' arithmetic and skip tests, so the
three (Pallas, CUDA, plain) agree bit for bit, ties included.

The glue — top-`top_t` coarse cells, window-origin clamp, final argmax
(`hough_votes_c2f_windows`, `hough_votes_c2f`) — is plain tensor code on
whatever device the samples are on. Hough is zero-gradient by contract
(`posecnn_tpu/ops/hough_voting.py:1045`): nothing here has a backward.

Still to port: the exhaustive `_vote_kernel` (`hough_votes_pallas`) and
the multi-instance greedy candidate pick.
"""

from __future__ import annotations

import torch

from posecnn_torch.ops import _cuda

TILE = 1024  # cells in one Pallas (8, 128) tile, and in one window
WINDOW = 32  # refine-window side (WINDOW² == TILE)
TOP_T = 4  # refine windows per slot (hough_pallas.hough_votes_c2f default)
COARSE = 4  # coarse-pass cell stride, in fine cells

# kernel launches since the last reset, by kernel; chip_smoke.py reads
# them to show that the serving path went through the kernels
LAUNCHES = {"flat": 0, "window": 0}


def votes_at(samples, cell_y, cell_x, in_grid, hit, group):
    """Plain vote accumulation at arbitrary cells, sample by sample.

    samples: (R, 8, S) fp32 packed channels; cell_y, cell_x: (R, N) fp32
    pixel coordinates of each row's cells; in_grid: (R, N) bool;
    hit: (R, S, G) bool, whether sample j is tested at all in cell group
    g (the kernels' block-uniform skips); group: (N,) long, the group of
    each cell. Returns (votes, dsum), each (R, N) fp32.
    """
    ch = samples.unbind(1)
    acc_v = torch.zeros_like(cell_y)
    acc_d = torch.zeros_like(cell_y)
    for j in range(samples.shape[2]):
        x, y, u, v, d, t2n2, thr, w = (c[:, j, None] for c in ch)
        dx = cell_x - x
        dy = cell_y - y
        dot = u * dx + v * dy
        dist2 = dx * dx + dy * dy
        inl = (
            (dot > 0.0)
            & (dot * dot > t2n2 * dist2)
            & (dx.abs() < thr)
            & (dy.abs() < thr)
            & in_grid
        )
        wv = torch.where(inl, w, 0.0)
        tested = hit[:, j][:, group]
        acc_v = torch.where(tested, acc_v + wv, acc_v)
        acc_d = torch.where(tested, acc_d + wv * d, acc_d)
    return acc_v, acc_d


def hough_votes_flat_plain(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Plain version of `hough_votes_flat`, with the Pallas tile skips."""
    dev = samples.device
    n_cells = grid_h * grid_w
    n_tiles = -(-n_cells // TILE)
    idx = torch.arange(n_tiles * TILE, device=dev)
    fy = idx // grid_w
    cy = (fy.float() * cell_stride)[None]
    cx = ((idx - fy * grid_w).float() * cell_stride)[None]
    base = torch.arange(n_tiles, device=dev) * TILE
    tile_y0 = ((base // grid_w) * cell_stride).float()
    tile_y1 = (((base + TILE - 1) // grid_w) * cell_stride).float()
    y, thr, w = samples[:, 1, :, None], samples[:, 6, :, None], samples[:, 7, :, None]
    overlap = (bboxes[:, 3, None] >= tile_y0) & (bboxes[:, 2, None] <= tile_y1)  # (K, T)
    hit = overlap[:, None] & (y + thr >= tile_y0) & (y - thr <= tile_y1) & (w > 0.0)
    votes, dsum = votes_at(samples, cy, cx, (fy < grid_h)[None], hit, idx // TILE)
    return votes[:, :n_cells], dsum[:, :n_cells]


def hough_votes_windows_plain(samples, origins, *, cell_stride: int, grid_h: int,
                              grid_w: int):
    """Plain version of `hough_votes_windows`, with the Pallas window skips."""
    dev = samples.device
    top_t = _windows_per_slot(samples, origins)
    rows = samples.repeat_interleave(top_t, dim=0)  # window p votes with slot p // top_t
    oy, ox, enable = origins[:, 0, None], origins[:, 1, None], origins[:, 2, None] > 0
    widx = torch.arange(TILE, device=dev)
    fy = oy + widx // WINDOW
    fx = ox + widx % WINDOW
    x0, x1 = (ox * cell_stride).float(), ((ox + WINDOW) * cell_stride).float()
    y0, y1 = (oy * cell_stride).float(), ((oy + WINDOW) * cell_stride).float()
    x, y = rows[:, 0], rows[:, 1]
    thr, w = rows[:, 6], rows[:, 7]
    hit = (
        enable & (x + thr >= x0) & (x - thr < x1) & (y + thr >= y0) & (y - thr < y1) & (w > 0.0)
    )
    return votes_at(
        rows, fy.float() * cell_stride, fx.float() * cell_stride,
        (fy < grid_h) & (fx < grid_w), hit[:, :, None], torch.zeros_like(widx),
    )


def _windows_per_slot(samples, origins) -> int:
    k, n = max(samples.shape[0], 1), origins.shape[0]
    if n % k:
        raise ValueError(f"{n} windows do not split evenly over {k} slots")
    return n // k


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {shape}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})"
        )


def hough_votes_flat(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Vote accumulation over a flat, row-major (grid_h, grid_w) cell grid
    at pixel stride `cell_stride` (`hough_pallas.hough_votes_flat`).

    samples: (K, 8, S) fp32; bboxes: (K, 4) fp32 [x_lo, x_hi, y_lo, y_hi].
    Returns (votes, dsum), each (K, grid_h·grid_w) fp32."""
    if samples.device.type == "cpu":
        return hough_votes_flat_plain(
            samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
        )
    k, _, s = samples.shape
    _require(samples, "samples", torch.float32, (k, 8, s))
    _require(bboxes, "bboxes", torch.float32, (k, 4))
    votes = torch.empty((k, grid_h * grid_w), dtype=torch.float32, device=samples.device)
    dsum = torch.empty_like(votes)
    lib = _cuda.library()
    with torch.cuda.device(samples.device):
        status = lib.hough_flat_votes(
            samples.data_ptr(), bboxes.data_ptr(), votes.data_ptr(), dsum.data_ptr(),
            k, s, cell_stride, grid_h, grid_w, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(status, "flat_vote_kernel")
    LAUNCHES["flat"] += 1
    return votes, dsum


def hough_votes_windows(samples, origins, *, cell_stride: int, grid_h: int, grid_w: int):
    """Exact vote accumulation on one WINDOW×WINDOW patch of fine cells per
    (slot, candidate) (the `_window_vote_kernel` launch of
    `hough_pallas.hough_votes_c2f_windows`).

    samples: (K, 8, S) fp32; origins: (K·T, 3) int32 [oy, ox, enable] in
    fine-cell units, T windows per slot, window p voting with slot p // T.
    Returns (votes_w, dsum_w), each (K·T, WINDOW²) fp32, window cells
    row-major."""
    if samples.device.type == "cpu":
        return hough_votes_windows_plain(
            samples, origins, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
        )
    top_t = _windows_per_slot(samples, origins)
    k, _, s = samples.shape
    _require(samples, "samples", torch.float32, (k, 8, s))
    _require(origins, "origins", torch.int32, (k * top_t, 3))
    votes = torch.empty((k * top_t, TILE), dtype=torch.float32, device=samples.device)
    dsum = torch.empty_like(votes)
    lib = _cuda.library()
    with torch.cuda.device(samples.device):
        status = lib.hough_window_votes(
            samples.data_ptr(), origins.data_ptr(), votes.data_ptr(), dsum.data_ptr(),
            k * top_t, s, cell_stride, grid_h, grid_w, top_t,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(status, "window_vote_kernel")
    LAUNCHES["window"] += 1
    return votes, dsum


def hough_votes_c2f_windows(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Coarse pass, then exact re-vote windows around the top coarse cells
    (single-instance form of `hough_pallas.hough_votes_c2f_windows`, at its
    defaults top_t = 4 and coarse_factor = 4).

    Returns (votes_w, dsum_w, oy, ox, enable): (K, TOP_T, WINDOW²) fp32
    window votes and depth sums, (K, TOP_T) long window origins in
    fine-cell units, and (K, TOP_T) bool, False for dead candidates."""
    k = samples.shape[0]
    f, top_t = COARSE, TOP_T
    ch, cw = -(-grid_h // f), -(-grid_w // f)
    votes_c, _ = hough_votes_flat(samples, bboxes, cell_stride=cell_stride * f,
                                  grid_h=ch, grid_w=cw)
    # jax.lax.top_k puts the lower index first on ties; a stable
    # descending sort does too (empty slots tie everywhere at 0)
    top_v, top_i = torch.sort(votes_c, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :top_t], top_i[:, :top_t]
    oy = ((top_i // cw) * f + f // 2 - WINDOW // 2).clamp(0, max(grid_h - WINDOW, 0))
    ox = ((top_i % cw) * f + f // 2 - WINDOW // 2).clamp(0, max(grid_w - WINDOW, 0))
    enable = top_v > 0
    origins = torch.stack([oy, ox, enable.long()], dim=-1).reshape(k * top_t, 3).int()
    votes_w, dsum_w = hough_votes_windows(
        samples, origins, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
    )
    return (votes_w.reshape(k, top_t, TILE), dsum_w.reshape(k, top_t, TILE), oy, ox, enable)


def hough_votes_c2f(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Coarse-to-fine single-instance vote maximum per class slot
    (`hough_pallas.hough_votes_c2f`). Returns (best_votes, best_dsum,
    best_cy, best_cx), each (K,); the cell coordinates in fine cells."""
    k = samples.shape[0]
    vw3, dw3, oy, ox, _ = hough_votes_c2f_windows(
        samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
    )
    vw = vw3.reshape(k, TOP_T * TILE)
    dw = dw3.reshape(k, TOP_T * TILE)
    best = torch.argmax(vw, dim=1, keepdim=True)  # first maximum, as jnp.argmax
    t_idx = best // TILE
    cell = (best % TILE)[:, 0]
    best_cy = oy.gather(1, t_idx)[:, 0] + cell // WINDOW
    best_cx = ox.gather(1, t_idx)[:, 0] + cell % WINDOW
    return vw.gather(1, best)[:, 0], dw.gather(1, best)[:, 0], best_cy, best_cx
