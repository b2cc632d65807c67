// Hough vote accumulation for NVIDIA Hopper (sm_90a): the exhaustive
// vote and the two kernels of the coarse-to-fine vote.
//
// Replaces the three Pallas TPU kernels of posecnn_tpu/ops/hough_pallas.py:
//   tile_vote_kernel   <- _vote_kernel        (:39, exhaustive vote over the
//                         full (grid_h, grid_w) cell grid, hough_votes_pallas)
//   flat_vote_kernel   <- _flat_vote_kernel   (:191, coarse pass over a flat,
//                         row-major cell grid, hough_votes_flat)
//   window_vote_kernel <- _window_vote_kernel (:333, exact stride-1 re-vote
//                         on one 32x32 window per (slot, candidate),
//                         hough_votes_c2f_windows)
//
// Per cell and per tested sample of the cell's class slot, all three run
// the same vote: the algebraic cone test
//   dot > 0  &&  dot^2 > (t*|uv|)^2 * dist^2  &&  |dx| < thr  &&  |dy| < thr
// then votes += (inside ? w : 0) and dsum += (inside ? w : 0) * d.
// Samples are (K, 8, S) fp32 with channels [x, y, u, v, d, (t*|uv|)^2,
// thr, w] (packed by ops/hough_voting._prepare_slots).
//
// What all three keep, so that they equal the Pallas kernels and the
// plain PyTorch versions in ops/hough_kernels.py bit for bit:
//   * a sample is tested at a cell exactly when the Pallas kernel tests
//     it there: the cell's Pallas unit (the (8, 128) tile, the 1024-cell
//     flat tile, the 32x32 window) passes the unit's test, the sample's
//     +-thr box reaches the unit, and w > 0;
//   * every tested sample adds, inside the cone or not, so a tested
//     sample at d = inf adds 0 * inf = NaN to dsum outside its cone; a
//     skipped one adds nothing;
//   * each cell sums in sample order, in registers, with no atomics; the
//     products and sums use the _rn intrinsics so nvcc cannot contract
//     them into FMAs, which would move the cone test's edge.
//
// What bounds them on the card: fp32 instruction issue on the CUDA
// cores. On chip_smoke.py's planted 480x640 scene (8 slots, 3 live,
// S = 1024) the exhaustive vote tests 2.5e8 (cell, sample) pairs, the
// flat pass 2.8e7 and the 32 windows 1.3e7, on ~32 KB of input per
// slot. Each pair is 13 fp32 adds and multiplies, 4 compares and a
// select; no tensor-core work exists. Only 6 of the 13 depend on both
// the cell and the sample: dx, u*dx and dx*dx depend on the column
// alone and dy, v*dy and dy*dy on the row alone, so the function needs
// ~6.4 a pair when each side is computed once per column or row of a
// unit (what chip_smoke.py's bound counts). Without FMAs the fp32 pipes
// issue at most 33.5e12 of those operations a second, half of the
// 67 TFLOP/s peak that counts an FMA as two.
//
// All three vote through vote_tested below. Staging every sample in
// shared memory and letting every thread evaluate every sample's skip
// test (4 scalar shared loads, 4 compares and a branch each, tested or
// not) costs about as many instructions as the votes: on the planted
// scene the flat pass tests ~486 of 1024 samples a tile, the exhaustive
// vote ~595. The data-dependent skip also keeps nvcc from unrolling the
// loop, which leaves each vote a dependent chain of ~10 operations with
// nothing to overlap it. Instead:
//   * per chunk of 256 samples, each thread loads its samples straight
//     from the (K, 8, S) input (coalesced per channel) and evaluates the
//     unit's skip test; a block-wide ordered compaction (__ballot_sync
//     and __popc for the rank in the warp, the counts of the earlier
//     warps for the offset) writes the tested ones into shared memory in
//     sample order, as two float4 records [x, y, u, v], [d, t2n2, thr, w];
//     zero records pad the count to a multiple of the unroll (w = d = 0
//     adds +0, which leaves every sum as it was, NaN and inf included);
//   * the vote loop walks only tested samples, with no branch: each step
//     takes kUnroll samples, computes their weights side by side, then
//     adds them in order, while the next step's records (two 128-bit
//     broadcast loads a sample) are already in flight. Written as a plain
//     unrolled loop, ptxas ran the samples' chains one after another and
//     waited on each shared load at once;
//   * two buffers of 256 + kUnroll records (16.6-16.9 KB in all): chunk
//     c is compacted into one while chunk c - 1 is voted from the other
//     and chunk c + 1 is loaded into registers, one __syncthreads a chunk;
//   * a block covers a Pallas unit or part of one and compacts with the
//     unit's test: the result is the unit's, and a unit split over
//     several blocks repeats the compaction per block (a few percent of
//     the work at the serve shapes).
// The three differ in how much parallel work they have:
//   * tile (406 live (tile, slot) pairs at the serve shapes, 595 tested
//     samples each on average and up to all 1024, 2.5e8 tested pairs):
//     4 blocks of 128 threads per Pallas (8, 128) tile and slot, each
//     thread a column of 2 cells (rows 2p, 2p + 1 of the tile for block
//     p). Per tested sample a thread computes the x side (dx, |dx| < thr,
//     u*dx, dx*dx) once for its 2 cells, and per cell the y side and the
//     two sums: the same operations on the same operands as one cell
//     alone, so every bit stays. Unrolled by 8, a step has 16 independent
//     weights; the vote loop is ~18 instructions a tested pair, against
//     ~39 when every thread tested every sample. It is bound by
//     instruction throughput and by how evenly the tiles' unequal work
//     spreads over the SMs: one block per tile with 8 cells per thread
//     (fewer instructions a pair) measured slower, since its 406 blocks
//     leave the busiest SMs with far more than the mean work; 4 blocks per
//     tile spread it closely, at the price of compacting each tile 4 times
//     (a few percent of the instructions). 2 cells a thread and an unroll
//     of 8 measured fastest of 1, 2, 4 and 8 cells, 32-256 threads and
//     unrolls of 1-16. It writes straight into (K, grid_h, grid_w) and
//     does not write the cells of a ragged tile past the grid (they still
//     vote, so every thread reaches every __syncthreads).
//   * flat (~58k live cells at the serve shapes, ~486 tested samples
//     each): 128 cells per block, one per thread, an eighth of a flat
//     tile, unrolled by 4. The 3 live slots make 456 working blocks,
//     1824 warps, ~3.5 per scheduler of the 528 (132 SMs x 4): enough
//     warps to hide each other's latency, so the kernel is bound by
//     issue. Several cells per thread (one sample's loads for all of them)
//     measured slower: they cut the warps per scheduler below 1-2, and
//     ptxas serialised the cells' chains.
//   * window (12 live windows of 1024 cells at the serve shapes, every
//     cell testing all 1024 samples): 12,288 cells make only 384 warps,
//     fewer than the schedulers, and each cell's samples are a serial sum,
//     so the kernel is bound by one warp's latency. One cell per thread
//     keeps all 384 warps; unrolling by 8 gives each warp 8 independent
//     weights a step. 8 blocks of 128 cells (4 rows) per window; the
//     multi-instance path (96 live of 256 windows) gives 3072 warps.
//     A cell past the grid votes with x = +inf, where |dx| < thr never
//     holds: weight 0, as the Pallas kernel's in_grid mask gives.
//
// Build (ops/_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libhough_vote.so hough_vote.cu
// The entry points have a plain C interface for ctypes; each launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // cells in a Pallas (8, 128) tile or a 32x32 window
constexpr int kTileH = 8;    // rows of a Pallas tile
constexpr int kTileW = 128;  // columns of a Pallas tile
constexpr int kWindow = 32;  // refine-window side (hough_pallas.WINDOW)
constexpr int kChunk = 256;  // samples compacted at a time
constexpr int kChannels = 8;
constexpr int kTileThreads = 128;  // one column of a Pallas tile per thread
constexpr int kTileRows = 2;       // cells per thread: 2 rows of its column
constexpr int kTileUnroll = 8;     // tested samples per step of the tile vote loop
constexpr int kFlatThreads = 128;   // one cell per thread, an eighth of a flat tile
constexpr int kFlatUnroll = 4;      // tested samples per step of the flat vote loop
constexpr int kWindowThreads = 128;  // one cell per thread, 4 rows of a window
constexpr int kWindowUnroll = 8;
constexpr int kTileParts = kTileH / kTileRows;  // blocks per Pallas tile
static_assert(kTileThreads == kTileW && kTileH % kTileRows == 0, "blocks split a tile by rows");
constexpr int kFlatParts = kTile / kFlatThreads;      // blocks per flat tile
constexpr int kWindowParts = kTile / kWindowThreads;  // blocks per window

// This thread's samples of the chunk at `base`: sample base + p * kBlock +
// threadIdx.x in r[p]; past the last sample, zeros (w = 0: never tested).
template <int kBlock>
__device__ __forceinline__ void load_chunk(const float* __restrict__ slot, int num_samples,
                                           int base, float (&r)[kChunk / kBlock][kChannels]) {
#pragma unroll
  for (int p = 0; p < kChunk / kBlock; ++p) {
    const int j = base + p * kBlock + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) r[p][c] = j < num_samples ? slot[c * num_samples + j] : 0.f;
  }
}

// The vote of every sample of one slot that `hit` tests, at this
// thread's kRows cells (rows cy[r] of one column cx), by compaction (see
// the header). `hit` is the test of the block's Pallas unit; a cell past
// the grid comes with cx = +inf or is not written. Must be reached by
// every thread of a block of kBlock threads.
template <int kBlock, int kRows, int kUnroll, class Hit>
__device__ __forceinline__ void vote_tested(const float* __restrict__ slot, int num_samples,
                                            Hit hit, const float (&cy)[kRows], float cx,
                                            float (&votes)[kRows], float (&dsum)[kRows]) {
  static_assert(kChunk % kBlock == 0 && kChunk % kUnroll == 0, "chunk must split evenly");
  constexpr int kPer = kChunk / kBlock;  // samples per thread per chunk
  constexpr int kWarps = kBlock / 32;
  // a chunk's tested samples, padded to a multiple of kUnroll; the vote
  // loop reads up to kUnroll records past the padding, and drops them
  __shared__ float4 tested[2][kChunk + kUnroll][2];
  __shared__ int counts[2][kChunk / 32];  // tested samples per (p, warp) of a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc_v[kRows], acc_d[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc_v[i] = acc_d[i] = 0.f;

  float r[kPer][kChannels];
  load_chunk<kBlock>(slot, num_samples, 0, r);
  const int n_chunks = (num_samples + kChunk - 1) / kChunk;
  int n_voted = 0;  // padded count of the chunk compacted last
  for (int c = 0; c <= n_chunks; ++c) {
    const int b = c & 1;
    bool pass[kPer];
    unsigned ballot[kPer];
    if (c < n_chunks) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        pass[p] = hit(r[p][0], r[p][1], r[p][6]) && r[p][7] > 0.f;
        ballot[p] = __ballot_sync(0xffffffffu, pass[p]);
        if (lane == 0) counts[b][p * kWarps + warp] = __popc(ballot[p]);
      }
    }
    // chunk c's counts are in, chunk c - 1 is compacted into buffer b ^ 1,
    // and every thread is done voting chunk c - 2 from buffer b
    __syncthreads();
    int n_next = 0;
    if (c < n_chunks) {
      int off[kPer], total = 0;
#pragma unroll
      for (int q = 0; q < kChunk / 32; ++q) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          if (q == p * kWarps + warp) off[p] = total;
        }
        total += counts[b][q];
      }
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        if (pass[p]) {
          const int e = off[p] + __popc(ballot[p] & below);
          tested[b][e][0] = make_float4(r[p][0], r[p][1], r[p][2], r[p][3]);
          tested[b][e][1] = make_float4(r[p][4], r[p][5], r[p][6], r[p][7]);
        }
      }
      n_next = (total + kUnroll - 1) / kUnroll * kUnroll;
      if (static_cast<int>(threadIdx.x) < n_next - total) {
        tested[b][total + threadIdx.x][0] = make_float4(0.f, 0.f, 0.f, 0.f);
        tested[b][total + threadIdx.x][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (c + 1 < n_chunks) load_chunk<kBlock>(slot, num_samples, (c + 1) * kChunk, r);
    }

    // vote chunk c - 1: a step's records are loaded one step ahead; its
    // kUnroll x kRows weights are computed side by side, then summed in
    // sample order, each cell its own chain
    const float4(*t)[2] = tested[b ^ 1];
    float4 a[kUnroll], q[kUnroll];  // [x, y, u, v], [d, t2n2, thr, w]
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = t[u][0];
      q[u] = t[u][1];
    }
    for (int e = 0; e < n_voted; e += kUnroll) {
      float4 a_next[kUnroll], q_next[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a_next[u] = t[e + kUnroll + u][0];
        q_next[u] = t[e + kUnroll + u][1];
      }
      float wv[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // the x side once for the column's cells
        const float dx = __fsub_rn(cx, a[u].x);
        const float udx = __fmul_rn(a[u].z, dx);
        const float dx2 = __fmul_rn(dx, dx);
        const bool x_in = fabsf(dx) < q[u].z;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float dy = __fsub_rn(cy[i], a[u].y);
          const float dot = __fadd_rn(udx, __fmul_rn(a[u].w, dy));
          const float dist2 = __fadd_rn(dx2, __fmul_rn(dy, dy));
          const bool inl = (dot > 0.f) & (__fmul_rn(dot, dot) > __fmul_rn(q[u].y, dist2)) &
                           x_in & (fabsf(dy) < q[u].z);
          wv[u][i] = inl ? q[u].w : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc_v[i] = __fadd_rn(acc_v[i], wv[u][i]);
          acc_d[i] = __fadd_rn(acc_d[i], __fmul_rn(wv[u][i], q[u].x));
        }
        a[u] = a_next[u];
        q[u] = q_next[u];
      }
    }
    n_voted = n_next;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    votes[i] = acc_v[i];
    dsum[i] = acc_d[i];
  }
}

// Sample reaches the tile's rows [y0, y1] (inclusive), hough_pallas.py:244-248.
struct RowSpan {
  float y0, y1;
  __device__ bool operator()(float, float y, float thr) const {
    return y + thr >= y0 && y - thr <= y1;
  }
};

// Sample's +-thr box reaches the window or tile [x0, x1) x [y0, y1),
// hough_pallas.py:381-387 (windows) and :97-103 (tiles).
struct WindowBox {
  float x0, x1, y0, y1;
  __device__ bool operator()(float x, float y, float thr) const {
    return x + thr >= x0 && x - thr < x1 && y + thr >= y0 && y - thr < y1;
  }
};

// One launch of the calling kernel, counted on the device by its first
// thread (hough_kernels.device_launches): a CUDA graph's replays call no
// host wrapper, so only the kernel itself sees them.
__device__ __forceinline__ void count_launch(int* launches) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) atomicAdd(launches, 1);
}

// grid (tiles_y * tiles_x * kTileParts, K); block kTileThreads. Block
// part p of a (kTileH, kTileW) Pallas tile holds its kTileRows rows from
// p * kTileRows; thread t owns column t of them. Cell (row, col) lies at
// pixel (col, row) * cell_stride.
__global__ void __launch_bounds__(kTileThreads)
tile_vote_kernel(const float* __restrict__ samples, const float* __restrict__ bboxes,
                 float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                 int cell_stride, int grid_h, int grid_w, int* __restrict__ launches) {
  count_launch(launches);
  const int k = blockIdx.y;
  const int tiles_x = (grid_w + kTileW - 1) / kTileW;
  const int tile = blockIdx.x / kTileParts;
  const int ti = tile / tiles_x, tj = tile % tiles_x;
  const int row0 = ti * kTileH + (blockIdx.x % kTileParts) * kTileRows;
  const int col = tj * kTileW + threadIdx.x;
  float cy[kTileRows], acc_v[kTileRows], acc_d[kTileRows];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    cy[i] = static_cast<float>((row0 + i) * cell_stride);
    acc_v[i] = acc_d[i] = 0.f;
  }

  // the tile's pixel box [x0, x1) x [y0, y1), hough_pallas.py:72-81
  const float x0 = static_cast<float>(tj * kTileW * cell_stride);
  const float x1 = static_cast<float>((tj + 1) * kTileW * cell_stride);
  const float y0 = static_cast<float>(ti * kTileH * cell_stride);
  const float y1 = static_cast<float>((ti + 1) * kTileH * cell_stride);
  const float* box = bboxes + k * 4;
  if (box[1] >= x0 && box[0] < x1 && box[3] >= y0 && box[2] < y1) {
    vote_tested<kTileThreads, kTileRows, kTileUnroll>(
        samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples,
        WindowBox{x0, x1, y0, y1}, cy, static_cast<float>(col * cell_stride), acc_v, acc_d);
  }
  // cells past the grid voted but are not written: Pallas's in_grid mask
  // changes no stored value
  if (col < grid_w) {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      if (row0 + i < grid_h) {
        const size_t out = (static_cast<size_t>(k) * grid_h + row0 + i) * grid_w + col;
        votes[out] = acc_v[i];
        dsum[out] = acc_d[i];
      }
    }
  }
}

// grid (n_tiles * kFlatParts, K); block kFlatThreads. Cell idx is flat
// row-major over (grid_h, grid_w) at pixel stride cell_stride.
__global__ void __launch_bounds__(kFlatThreads)
flat_vote_kernel(const float* __restrict__ samples, const float* __restrict__ bboxes,
                 float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                 int cell_stride, int grid_h, int grid_w, int* __restrict__ launches) {
  count_launch(launches);
  const int k = blockIdx.y;
  const int idx = blockIdx.x * kFlatThreads + threadIdx.x;
  const int base = (idx / kTile) * kTile;  // first cell of this Pallas tile
  const int tile_y0 = (base / grid_w) * cell_stride;
  const int tile_y1 = ((base + kTile - 1) / grid_w) * cell_stride;
  const int fy = idx / grid_w;
  const float cy[1] = {static_cast<float>(fy * cell_stride)};
  const float cx = static_cast<float>((idx - fy * grid_w) * cell_stride);

  // cells at or past grid_h * grid_w (fy >= grid_h) are not written, so
  // they need no in_grid mask
  float acc_v[1] = {0.f}, acc_d[1] = {0.f};
  const float y_lo = bboxes[k * 4 + 2], y_hi = bboxes[k * 4 + 3];
  if (y_hi >= static_cast<float>(tile_y0) && y_lo <= static_cast<float>(tile_y1)) {
    vote_tested<kFlatThreads, 1, kFlatUnroll>(
        samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples,
        RowSpan{static_cast<float>(tile_y0), static_cast<float>(tile_y1)}, cy, cx, acc_v, acc_d);
  }
  const int n_cells = grid_h * grid_w;
  if (idx < n_cells) {
    votes[static_cast<size_t>(k) * n_cells + idx] = acc_v[0];
    dsum[static_cast<size_t>(k) * n_cells + idx] = acc_d[0];
  }
}

// grid (K * top_t * kWindowParts); block kWindowThreads. origins is
// (K * top_t, 3) int32 [oy, ox, enable] in fine-cell units; window p
// belongs to slot p / top_t. Window cell i is (i / 32, i % 32).
__global__ void __launch_bounds__(kWindowThreads)
window_vote_kernel(const float* __restrict__ samples, const int* __restrict__ origins,
                   float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                   int cell_stride, int grid_h, int grid_w, int top_t,
                   int* __restrict__ launches) {
  count_launch(launches);
  const int p = blockIdx.x / kWindowParts;
  const int k = p / top_t;
  const int oy = origins[p * 3 + 0], ox = origins[p * 3 + 1];
  const bool enable = origins[p * 3 + 2] > 0;
  const int widx = (blockIdx.x % kWindowParts) * kWindowThreads + threadIdx.x;
  const int fy = oy + widx / kWindow;
  const int fx = ox + widx % kWindow;
  const float cy[1] = {static_cast<float>(fy * cell_stride)};
  // a cell past the grid votes at x = +inf, where |dx| < thr never holds
  const float cx = fy < grid_h && fx < grid_w ? static_cast<float>(fx * cell_stride)
                                              : __int_as_float(0x7f800000);

  float acc_v[1] = {0.f}, acc_d[1] = {0.f};
  if (enable) {
    const WindowBox box{static_cast<float>(ox * cell_stride),
                        static_cast<float>((ox + kWindow) * cell_stride),
                        static_cast<float>(oy * cell_stride),
                        static_cast<float>((oy + kWindow) * cell_stride)};
    vote_tested<kWindowThreads, 1, kWindowUnroll>(
        samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples, box, cy, cx,
        acc_v, acc_d);
  }
  votes[static_cast<size_t>(p) * kTile + widx] = acc_v[0];
  dsum[static_cast<size_t>(p) * kTile + widx] = acc_d[0];
}

}  // namespace

extern "C" {

// votes, dsum: (K, grid_h, grid_w) fp32.
int hough_tile_votes(const float* samples, const float* bboxes, float* votes, float* dsum,
                     int num_slots, int num_samples, int cell_stride, int grid_h, int grid_w,
                     int* launches, void* stream) {
  if (num_slots == 0 || grid_h == 0 || grid_w == 0) return 0;
  const int n_tiles = ((grid_h + kTileH - 1) / kTileH) * ((grid_w + kTileW - 1) / kTileW);
  const dim3 grid(n_tiles * kTileParts, num_slots);
  tile_vote_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, bboxes, votes, dsum, num_samples, cell_stride, grid_h, grid_w, launches);
  return static_cast<int>(cudaGetLastError());
}

// votes, dsum: (K, grid_h * grid_w) fp32.
int hough_flat_votes(const float* samples, const float* bboxes, float* votes, float* dsum,
                     int num_slots, int num_samples, int cell_stride, int grid_h, int grid_w,
                     int* launches, void* stream) {
  const int n_cells = grid_h * grid_w;
  if (num_slots == 0 || n_cells == 0) return 0;
  const int n_tiles = (n_cells + kTile - 1) / kTile;
  const dim3 grid(n_tiles * kFlatParts, num_slots);
  flat_vote_kernel<<<grid, kFlatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, bboxes, votes, dsum, num_samples, cell_stride, grid_h, grid_w, launches);
  return static_cast<int>(cudaGetLastError());
}

// votes, dsum: (num_windows, 1024) fp32; num_windows = K * top_t.
int hough_window_votes(const float* samples, const int* origins, float* votes, float* dsum,
                       int num_windows, int num_samples, int cell_stride, int grid_h,
                       int grid_w, int top_t, int* launches, void* stream) {
  if (num_windows == 0) return 0;
  const dim3 grid(num_windows * kWindowParts);
  window_vote_kernel<<<grid, kWindowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, origins, votes, dsum, num_samples, cell_stride, grid_h, grid_w, top_t,
      launches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
