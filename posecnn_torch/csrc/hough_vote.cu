// Hough vote accumulation for NVIDIA Hopper (sm_90a): the exhaustive
// vote and the two kernels of the coarse-to-fine vote.
//
// Replaces the three Pallas TPU kernels of posecnn_tpu/ops/hough_pallas.py:
//   tile_vote_kernel   <- _vote_kernel        (:39, exhaustive vote over the
//                         full (grid_h, grid_w) cell grid, hough_votes_pallas)
//   flat_vote_kernel   <- _flat_vote_kernel   (coarse pass over a flat,
//                         row-major cell grid, hough_votes_flat)
//   window_vote_kernel <- _window_vote_kernel (exact stride-1 re-vote on
//                         one 32x32 window per (slot, candidate),
//                         hough_votes_c2f_windows)
//
// Per cell and per sample of the cell's class slot, all run the same
// vote body (vote_slot below): the algebraic cone test
//   dot > 0  &&  dot^2 > (t*|uv|)^2 * dist^2  &&  |dx| < thr  &&  |dy| < thr
// then votes += w and dsum += w*d. Samples are (K, 8, S) fp32 with
// channels [x, y, u, v, d, (t*|uv|)^2, thr, w] (packed by
// ops/hough_voting._prepare_slots).
//
// What bounds it on the card: fp32 arithmetic on the CUDA cores. At the
// serve config (480x640, 8 slots, S = 1024) the exhaustive vote makes at
// most 8 * 307,200 * 1024 = 2.5e9 cell-sample tests, the flat pass 1.6e8
// and the 32 windows 3.4e7, before their skips (on chip_smoke.py's
// planted scene the skips leave 2.5e8, 2.8e7 and 1.3e7). Each test is
// 13 fp32 adds and multiplies plus compares, on ~32 KB of input per
// slot, against at most 19.7 MB of output for the exhaustive grid; no
// tensor-core work exists. Design:
//   * one thread per cell, 256 cells per block;
//   * the slot's samples are staged through shared memory in chunks of
//     256 (8 KB), so shared memory does not grow with S;
//   * every thread of a block reads the same sample, so the per-sample
//     hit test is block-uniform and costs no divergence;
//   * each thread accumulates in registers, in sample order, with no
//     atomics: the result is deterministic and equal, bit for bit, to the
//     Pallas kernel's and to the plain PyTorch loop in
//     ops/hough_kernels.py. Products and sums use the _rn intrinsics so
//     nvcc cannot contract them into FMAs, which would move the cone
//     test's edge against those two;
//   * the skip tests are those of the Pallas kernels, on the Pallas
//     kernels' 1024-cell tiles and windows (a block covers a quarter of
//     one): skipping a sample is then exactly the Pallas kernel's skip,
//     also when a depth d is inf and 0*d would be NaN;
//   * tile_vote_kernel writes straight into the (K, grid_h, grid_w)
//     output and masks the ragged edge of the (8, 128) tiles itself.
//
// Build (ops/_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -o libhough_vote.so hough_vote.cu
// The entry points have a plain C interface for ctypes; each launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;    // cells in a Pallas (8, 128) tile or a 32x32 window
constexpr int kTileH = 8;      // rows of a Pallas tile
constexpr int kTileW = 128;    // columns of a Pallas tile
constexpr int kWindow = 32;    // refine-window side (hough_pallas.WINDOW)
constexpr int kThreads = 256;  // one cell per thread
constexpr int kChunk = 256;    // samples staged in shared memory at a time
constexpr int kChannels = 8;

// The vote of every sample of one slot at this thread's cell. `hit`
// decides per sample, uniformly across the block, whether the sample is
// tested at all. Must be reached by every thread of the block.
template <class Hit>
__device__ __forceinline__ void vote_slot(const float* __restrict__ slot, int num_samples,
                                          Hit hit, float cy, float cx, bool in_grid,
                                          float& votes, float& dsum) {
  __shared__ float s[kChannels][kChunk];
  float acc_v = 0.f, acc_d = 0.f;
  for (int base = 0; base < num_samples; base += kChunk) {
    const int n = min(kChunk, num_samples - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kChannels * kChunk; i += blockDim.x) {
      const int c = i / kChunk, j = i % kChunk;
      if (j < n) s[c][j] = slot[c * num_samples + base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float x = s[0][j], y = s[1][j], thr = s[6][j], w = s[7][j];
      if (!(hit(x, y, thr) && w > 0.f)) continue;  // same for every thread
      const float u = s[2][j], v = s[3][j], d = s[4][j], t2n2 = s[5][j];
      const float dx = __fsub_rn(cx, x);
      const float dy = __fsub_rn(cy, y);
      const float dot = __fadd_rn(__fmul_rn(u, dx), __fmul_rn(v, dy));
      const float dist2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const bool inl = dot > 0.f && __fmul_rn(dot, dot) > __fmul_rn(t2n2, dist2) &&
                       fabsf(dx) < thr && fabsf(dy) < thr && in_grid;
      const float wv = inl ? w : 0.f;
      acc_v = __fadd_rn(acc_v, wv);
      acc_d = __fadd_rn(acc_d, __fmul_rn(wv, d));
    }
  }
  votes = acc_v;
  dsum = acc_d;
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

// grid (tiles_y * tiles_x * kTile / kThreads, K); block kThreads. A block
// covers kThreads / kTileW rows of one (kTileH, kTileW) Pallas tile; cell
// (row, col) at pixel (col, row) * cell_stride.
__global__ void __launch_bounds__(kThreads)
tile_vote_kernel(const float* __restrict__ samples, const float* __restrict__ bboxes,
                 float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                 int cell_stride, int grid_h, int grid_w) {
  constexpr int kParts = kTile / kThreads;
  const int k = blockIdx.y;
  const int tiles_x = (grid_w + kTileW - 1) / kTileW;
  const int tile = blockIdx.x / kParts;
  const int ti = tile / tiles_x, tj = tile % tiles_x;
  const int row = ti * kTileH + (blockIdx.x % kParts) * (kThreads / kTileW) + threadIdx.x / kTileW;
  const int col = tj * kTileW + threadIdx.x % kTileW;
  const bool in_grid = row < grid_h && col < grid_w;

  // the tile's pixel box [x0, x1) x [y0, y1), hough_pallas.py:72-81
  const float x0 = static_cast<float>(tj * kTileW * cell_stride);
  const float x1 = static_cast<float>((tj + 1) * kTileW * cell_stride);
  const float y0 = static_cast<float>(ti * kTileH * cell_stride);
  const float y1 = static_cast<float>((ti + 1) * kTileH * cell_stride);
  const float* box = bboxes + k * 4;
  float acc_v = 0.f, acc_d = 0.f;
  if (box[1] >= x0 && box[0] < x1 && box[3] >= y0 && box[2] < y1) {
    vote_slot(samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples,
              WindowBox{x0, x1, y0, y1}, static_cast<float>(row * cell_stride),
              static_cast<float>(col * cell_stride), in_grid, acc_v, acc_d);
  }
  if (in_grid) {
    const size_t out = (static_cast<size_t>(k) * grid_h + row) * grid_w + col;
    votes[out] = acc_v;
    dsum[out] = acc_d;
  }
}

// grid (n_tiles * kTile / kThreads, K); block kThreads. Cell idx is flat
// row-major over (grid_h, grid_w) at pixel stride cell_stride.
__global__ void __launch_bounds__(kThreads)
flat_vote_kernel(const float* __restrict__ samples, const float* __restrict__ bboxes,
                 float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                 int cell_stride, int grid_h, int grid_w) {
  const int k = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int base = (idx / kTile) * kTile;  // first cell of this Pallas tile
  const int tile_y0 = (base / grid_w) * cell_stride;
  const int tile_y1 = ((base + kTile - 1) / grid_w) * cell_stride;
  const int fy = idx / grid_w;
  const int fx = idx - fy * grid_w;
  const float cy = static_cast<float>(fy * cell_stride);
  const float cx = static_cast<float>(fx * cell_stride);

  float acc_v = 0.f, acc_d = 0.f;
  const float y_lo = bboxes[k * 4 + 2], y_hi = bboxes[k * 4 + 3];
  if (y_hi >= static_cast<float>(tile_y0) && y_lo <= static_cast<float>(tile_y1)) {
    vote_slot(samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples,
              RowSpan{static_cast<float>(tile_y0), static_cast<float>(tile_y1)}, cy, cx,
              fy < grid_h, acc_v, acc_d);
  }
  const int n_cells = grid_h * grid_w;
  if (idx < n_cells) {
    votes[static_cast<size_t>(k) * n_cells + idx] = acc_v;
    dsum[static_cast<size_t>(k) * n_cells + idx] = acc_d;
  }
}

// grid (K * top_t * kTile / kThreads); block kThreads. origins is
// (K * top_t, 3) int32 [oy, ox, enable] in fine-cell units; window p
// belongs to slot p / top_t. Window cell i is (i / 32, i % 32).
__global__ void __launch_bounds__(kThreads)
window_vote_kernel(const float* __restrict__ samples, const int* __restrict__ origins,
                   float* __restrict__ votes, float* __restrict__ dsum, int num_samples,
                   int cell_stride, int grid_h, int grid_w, int top_t) {
  constexpr int kParts = kTile / kThreads;
  const int p = blockIdx.x / kParts;
  const int k = p / top_t;
  const int oy = origins[p * 3 + 0], ox = origins[p * 3 + 1];
  const bool enable = origins[p * 3 + 2] > 0;
  const int widx = (blockIdx.x % kParts) * kThreads + threadIdx.x;
  const int fy = oy + widx / kWindow;
  const int fx = ox + widx % kWindow;
  const float cy = static_cast<float>(fy * cell_stride);
  const float cx = static_cast<float>(fx * cell_stride);

  float acc_v = 0.f, acc_d = 0.f;
  if (enable) {
    const WindowBox box{static_cast<float>(ox * cell_stride),
                        static_cast<float>((ox + kWindow) * cell_stride),
                        static_cast<float>(oy * cell_stride),
                        static_cast<float>((oy + kWindow) * cell_stride)};
    vote_slot(samples + static_cast<size_t>(k) * kChannels * num_samples, num_samples, box, cy,
              cx, fy < grid_h && fx < grid_w, acc_v, acc_d);
  }
  votes[static_cast<size_t>(p) * kTile + widx] = acc_v;
  dsum[static_cast<size_t>(p) * kTile + widx] = acc_d;
}

}  // namespace

extern "C" {

// votes, dsum: (K, grid_h, grid_w) fp32.
int hough_tile_votes(const float* samples, const float* bboxes, float* votes, float* dsum,
                     int num_slots, int num_samples, int cell_stride, int grid_h, int grid_w,
                     void* stream) {
  if (num_slots == 0 || grid_h == 0 || grid_w == 0) return 0;
  const int n_tiles = ((grid_h + kTileH - 1) / kTileH) * ((grid_w + kTileW - 1) / kTileW);
  const dim3 grid(n_tiles * (kTile / kThreads), num_slots);
  tile_vote_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, bboxes, votes, dsum, num_samples, cell_stride, grid_h, grid_w);
  return static_cast<int>(cudaGetLastError());
}

// votes, dsum: (K, grid_h * grid_w) fp32.
int hough_flat_votes(const float* samples, const float* bboxes, float* votes, float* dsum,
                     int num_slots, int num_samples, int cell_stride, int grid_h, int grid_w,
                     void* stream) {
  const int n_cells = grid_h * grid_w;
  if (num_slots == 0 || n_cells == 0) return 0;
  const int n_tiles = (n_cells + kTile - 1) / kTile;
  const dim3 grid(n_tiles * (kTile / kThreads), num_slots);
  flat_vote_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, bboxes, votes, dsum, num_samples, cell_stride, grid_h, grid_w);
  return static_cast<int>(cudaGetLastError());
}

// votes, dsum: (num_windows, 1024) fp32; num_windows = K * top_t.
int hough_window_votes(const float* samples, const int* origins, float* votes, float* dsum,
                       int num_windows, int num_samples, int cell_stride, int grid_h,
                       int grid_w, int top_t, void* stream) {
  if (num_windows == 0) return 0;
  const dim3 grid(num_windows * (kTile / kThreads));
  window_vote_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, origins, votes, dsum, num_samples, cell_stride, grid_h, grid_w, top_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
