"""Hough vote accumulation: the CUDA kernels, their wrappers, their plain
PyTorch versions and the coarse-to-fine glue.

Counterpart of `posecnn_tpu/ops/hough_pallas.py`. Its three Pallas
kernels are ported to `posecnn_torch/csrc/hough_vote.cu` (its header
says what bounds them on the card and what the design does about it):

  hough_votes_exhaustive → tile_vote_kernel    (was _vote_kernel, :39-188,
                                                hough_votes_pallas)
  hough_votes_flat       → flat_vote_kernel    (was _flat_vote_kernel, :191-330)
  hough_votes_windows    → window_vote_kernel  (was _window_vote_kernel, :333-415,
                                                called in hough_votes_c2f_windows)

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in `LAUNCHES`; a failed build or launch raises. Only a tensor on the CPU
takes the plain version (`*_plain`), which is also what the tests and
`chip_smoke.py` hold the kernels against. The plain versions accumulate
sample by sample with the kernels' arithmetic and skip tests, so the
three (Pallas, CUDA, plain) agree bit for bit, ties included.

The glue — the top-`top_t` coarse cells or, for multi-instance, their
greedy pick-and-suppress, the window-origin clamp and the final argmax
(`hough_votes_c2f_windows`, `hough_votes_c2f`) — is plain tensor code on
whatever device the samples are on. Hough is zero-gradient by contract
(`posecnn_tpu/ops/hough_voting.py:1045`): nothing here has a backward.
"""

from __future__ import annotations

import torch

from posecnn_torch.ops import _cuda

TILE_H, TILE_W = 8, 128  # a Pallas tile of the exhaustive vote
TILE = TILE_H * TILE_W  # cells in one Pallas tile, and in one window
WINDOW = 32  # refine-window side (WINDOW² == TILE)
TOP_T = 4  # refine windows per slot (hough_pallas.hough_votes_c2f default)
COARSE = 4  # coarse-pass cell stride, in fine cells

# kernel launches since the last reset, by kernel; chip_smoke.py reads
# them to show that each path went through its kernels
LAUNCHES = {"tile": 0, "flat": 0, "window": 0}


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


def tile_cells(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """The cells and skips of the exhaustive vote (`_vote_kernel`).

    Returns (cy, cx, in_grid, group, hit): (1, N) pixel coordinates of the
    grid's cells, row-major; (1, N) bool, all True; (N,) the Pallas
    (TILE_H, TILE_W) tile of each cell; (K, S, n_tiles) whether the tile
    overlaps the slot's vote box and sample j's ±thr box reaches it
    (`hough_pallas.py:76-81, 97-103`)."""
    dev = samples.device
    tiles_x = -(-grid_w // TILE_W)
    tiles = torch.arange(-(-grid_h // TILE_H) * tiles_x, device=dev)
    ti, tj = tiles // tiles_x, tiles % tiles_x
    x0, x1 = (tj * TILE_W * cell_stride).float(), ((tj + 1) * TILE_W * cell_stride).float()
    y0, y1 = (ti * TILE_H * cell_stride).float(), ((ti + 1) * TILE_H * cell_stride).float()
    overlap = ((bboxes[:, 1, None] >= x0) & (bboxes[:, 0, None] < x1)
               & (bboxes[:, 3, None] >= y0) & (bboxes[:, 2, None] < y1))  # (K, n_tiles)
    x, y = samples[:, 0, :, None], samples[:, 1, :, None]
    thr, w = samples[:, 6, :, None], samples[:, 7, :, None]
    hit = (overlap[:, None] & (x + thr >= x0) & (x - thr < x1) & (y + thr >= y0)
           & (y - thr < y1) & (w > 0.0))
    row = torch.arange(grid_h, device=dev).repeat_interleave(grid_w)
    col = torch.arange(grid_w, device=dev).repeat(grid_h)
    group = (row // TILE_H) * tiles_x + col // TILE_W
    in_grid = torch.ones((1, row.numel()), dtype=torch.bool, device=dev)
    return ((row * cell_stride).float()[None], (col * cell_stride).float()[None], in_grid,
            group, hit)


def flat_cells(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """The cells and skips of the flat vote (`_flat_vote_kernel`), the
    same fields as `tile_cells`: N covers whole 1024-cell tiles, so
    in_grid is False past the grid's last cell."""
    dev = samples.device
    n_tiles = -(-(grid_h * grid_w) // TILE)
    idx = torch.arange(n_tiles * TILE, device=dev)
    fy = idx // grid_w
    base = torch.arange(n_tiles, device=dev) * TILE
    tile_y0 = ((base // grid_w) * cell_stride).float()
    tile_y1 = (((base + TILE - 1) // grid_w) * cell_stride).float()
    y, thr, w = samples[:, 1, :, None], samples[:, 6, :, None], samples[:, 7, :, None]
    overlap = (bboxes[:, 3, None] >= tile_y0) & (bboxes[:, 2, None] <= tile_y1)  # (K, T)
    hit = overlap[:, None] & (y + thr >= tile_y0) & (y - thr <= tile_y1) & (w > 0.0)
    return ((fy.float() * cell_stride)[None], ((idx - fy * grid_w).float() * cell_stride)[None],
            (fy < grid_h)[None], idx // TILE, hit)


def window_cells(samples, origins, *, cell_stride: int, grid_h: int, grid_w: int):
    """The cells and skips of the window vote (`_window_vote_kernel`):
    (rows, cy, cx, in_grid, group, hit) with rows the (K·T, 8, S) samples
    each window votes with, cy, cx, in_grid (K·T, WINDOW²), group all 0
    and hit (K·T, S, 1)."""
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
    return (rows, fy.float() * cell_stride, fx.float() * cell_stride,
            (fy < grid_h) & (fx < grid_w), torch.zeros_like(widx), hit[:, :, None])


def hough_votes_exhaustive_plain(samples, bboxes, *, cell_stride: int, grid_h: int,
                                 grid_w: int):
    """Plain version of `hough_votes_exhaustive`, with the Pallas tile skips."""
    cy, cx, in_grid, group, hit = tile_cells(
        samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
    )
    votes, dsum = votes_at(samples, cy, cx, in_grid, hit, group)
    k = samples.shape[0]
    return votes.reshape(k, grid_h, grid_w), dsum.reshape(k, grid_h, grid_w)


def hough_votes_flat_plain(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Plain version of `hough_votes_flat`, with the Pallas tile skips."""
    cy, cx, in_grid, group, hit = flat_cells(
        samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
    )
    votes, dsum = votes_at(samples, cy, cx, in_grid, hit, group)
    n_cells = grid_h * grid_w
    return votes[:, :n_cells], dsum[:, :n_cells]


def hough_votes_windows_plain(samples, origins, *, cell_stride: int, grid_h: int,
                              grid_w: int):
    """Plain version of `hough_votes_windows`, with the Pallas window skips."""
    rows, cy, cx, in_grid, group, hit = window_cells(
        samples, origins, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
    )
    return votes_at(rows, cy, cx, in_grid, hit, group)


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


def hough_votes_exhaustive(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int):
    """Exhaustive vote accumulation over the full (grid_h, grid_w) cell
    grid at pixel stride `cell_stride` (`hough_pallas.hough_votes_pallas`).

    samples: (K, 8, S) fp32; bboxes: (K, 4) fp32 [x_lo, x_hi, y_lo, y_hi].
    Returns (votes, dsum), each (K, grid_h, grid_w) fp32."""
    if samples.device.type == "cpu":
        return hough_votes_exhaustive_plain(
            samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w
        )
    k, _, s = samples.shape
    _require(samples, "samples", torch.float32, (k, 8, s))
    _require(bboxes, "bboxes", torch.float32, (k, 4))
    votes = torch.empty((k, grid_h, grid_w), dtype=torch.float32, device=samples.device)
    dsum = torch.empty_like(votes)
    lib = _cuda.library()
    with torch.cuda.device(samples.device):
        status = lib.hough_tile_votes(
            samples.data_ptr(), bboxes.data_ptr(), votes.data_ptr(), dsum.data_ptr(),
            k, s, cell_stride, grid_h, grid_w, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(status, "tile_vote_kernel")
    LAUNCHES["tile"] += 1
    return votes, dsum


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


def hough_votes_c2f_windows(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int,
                            top_t: int = TOP_T, coarse_factor: int = COARSE,
                            coarse_local_max: bool = False):
    """Coarse pass, then exact re-vote windows around `top_t` coarse
    cells per slot (`hough_pallas.hough_votes_c2f_windows`).

    The candidates are the top-`top_t` coarse cells or, with
    `coarse_local_max` (multi-instance mode), `top_t` rounds of a greedy
    pick: the slot's first maximum, then every coarse cell within
    WINDOW / (2·coarse_factor) of it set to 0 (`hough_pallas.py:494-510`).

    Returns (votes_w, dsum_w, oy, ox, enable): (K, top_t, WINDOW²) fp32
    window votes and depth sums, (K, top_t) long window origins in
    fine-cell units, and (K, top_t) bool, False for dead candidates."""
    k = samples.shape[0]
    f = coarse_factor
    ch, cw = -(-grid_h // f), -(-grid_w // f)
    votes_c, _ = hough_votes_flat(samples, bboxes, cell_stride=cell_stride * f,
                                  grid_h=ch, grid_w=cw)
    if coarse_local_max:
        r = WINDOW // (2 * f)
        cy = torch.arange(ch, device=samples.device)[None, :, None]
        cx = torch.arange(cw, device=samples.device)[None, None, :]
        avail = votes_c.reshape(k, ch, cw)
        picks_v, picks_i = [], []
        for _ in range(top_t):
            flat = avail.reshape(k, ch * cw)
            i = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
            picks_v.append(flat.gather(1, i[:, None])[:, 0])
            picks_i.append(i)
            py, px = (i // cw)[:, None, None], (i % cw)[:, None, None]
            supp = ((cy - py).abs() <= r) & ((cx - px).abs() <= r)
            avail = torch.where(supp, 0.0, avail)
        top_v, top_i = torch.stack(picks_v, 1), torch.stack(picks_i, 1)
    else:
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


def hough_votes_c2f(samples, bboxes, *, cell_stride: int, grid_h: int, grid_w: int,
                    top_t: int = TOP_T, coarse_factor: int = COARSE):
    """Coarse-to-fine single-instance vote maximum per class slot
    (`hough_pallas.hough_votes_c2f`): the coarse pass at stride
    `coarse_factor`, then `top_t` windows a slot. Returns (best_votes,
    best_dsum, best_cy, best_cx), each (K,); the cell coordinates in fine
    cells."""
    k = samples.shape[0]
    vw3, dw3, oy, ox, _ = hough_votes_c2f_windows(
        samples, bboxes, cell_stride=cell_stride, grid_h=grid_h, grid_w=grid_w, top_t=top_t,
        coarse_factor=coarse_factor,
    )
    vw = vw3.reshape(k, top_t * TILE)
    dw = dw3.reshape(k, top_t * TILE)
    best = torch.argmax(vw, dim=1, keepdim=True)  # first maximum, as jnp.argmax
    t_idx = best // TILE
    cell = (best % TILE)[:, 0]
    best_cy = oy.gather(1, t_idx)[:, 0] + cell // WINDOW
    best_cx = ox.gather(1, t_idx)[:, 0] + cell % WINDOW
    return vw.gather(1, best)[:, 0], dw.gather(1, best)[:, 0], best_cy, best_cx
