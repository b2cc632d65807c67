// Greedy non-maximum suppression's scan for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the device counterpart of the lax.scan
// in posecnn_tpu/ops/nms.py:34-40 (nms's `step`), which the detection
// family's compiled programs need: a scan of N dependent rows written as
// PyTorch ops would put thousands of nodes into a CUDA graph, and a host
// scan cannot be captured at all. ops/nms.greedy_scan launches it;
// ops/nms.greedy_scan_plain is its plain PyTorch version, and the two agree
// bit for bit (the output is boolean).
//
// What it computes, for each leading index b: kill (B, N, N) bool is the
// score-sorted suppression matrix (kill[b, i, j]: sorted row i, if kept,
// suppresses sorted row j), sorted_valid (B, N) bool the valid rows in
// that order. The rows are walked in order; a row that is valid and not
// yet suppressed is kept and suppresses the rows it kills. The result is
// kept (B, N) bool. A row's kills of rows at or before it change nothing:
// those rows are decided already.
//
// What bounds it on the card: the walk. Row i's decision needs every kept
// row before it, so the N decisions are one dependent chain in one block
// per b, a few shared-memory operations each. The bytes are few: the
// RPN's (1, 2000) matrix is 4 MB of bool, of which the walk needs the
// upper triangle of the kept rows (chip_smoke.py's bound counts those,
// over the memory rate). Two kernels:
//   * pack_kill_kernel spreads the reading of kill over the whole card:
//     one warp per 32 columns of a row reads 32 consecutive bytes and
//     __ballot_sync makes them one 32-bit word (bit j % 32 of word j / 32),
//     into the (B, N, W) scratch the wrapper allocates, W = ceil(N / 32).
//     Words wholly left of the diagonal are skipped: the walk never reads
//     them.
//   * nms_scan_kernel, one block per b: the suppressed set is a bit mask
//     of W words in shared memory, ~valid at the start. The packed rows
//     come in tiles of R rows, double-buffered in shared memory: while
//     warp 0 walks tile t, the other warps copy tile t + 1 (coalesced
//     32-bit loads), and one __syncthreads ends each tile. Per row, lane 0
//     reads the row's bit and broadcasts it (__shfl_sync); a kept row's
//     words from its own word on are OR-ed into the mask by the lanes,
//     one __syncwarp a row. Lane 0 writes kept.
// R is 32, fewer where (1 + 2R) * W words would pass 48 KB (N > 6048);
// past N = 65,535 (the pack grid's y limit) the launch is refused.
//
// Each scan launch counts itself on the device (its first thread adds one
// to *launches), as the vote kernels do: a CUDA graph's replays call no
// host wrapper.
//
// Build (ops/_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libnms_scan.so nms_scan.cu
// The entry point has a plain C interface for ctypes; it launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPackWarps = 8;       // words packed by one pack block
constexpr int kScanThreads = 1024;  // warp 0 walks, the other 31 load
constexpr int kMaxTileRows = 32;
constexpr int kSmemWords = 48 * 1024 / 4;
constexpr unsigned kFull = 0xffffffffu;

// grid (ceil(W / kPackWarps), N, B); block kPackWarps warps. Warp p of
// block x packs word w = x * kPackWarps + p of row (blockIdx.z, blockIdx.y).
__global__ void __launch_bounds__(kPackWarps * 32)
pack_kill_kernel(const uint8_t* __restrict__ kill, uint32_t* __restrict__ packed, int n,
                 int words) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  // uniform per warp: a word past the row, or wholly left of the diagonal
  if (w >= words || w < (static_cast<int>(blockIdx.y) >> 5)) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * n + blockIdx.y;
  const int j = 32 * w + lane;
  const unsigned bits = __ballot_sync(kFull, j < n && kill[row * n + j] != 0);
  if (lane == 0) packed[row * words + w] = bits;
}

// Copy rows [r0, r0 + rows) of one leading index's packed words into dst,
// by the threads `first`..blockDim.x - 1.
__device__ __forceinline__ void load_tile(uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src, int r0, int rows,
                                          int words, int first) {
  const int count = rows * words;
  const int stride = static_cast<int>(blockDim.x) - first;
  src += static_cast<size_t>(r0) * words;
  for (int q = static_cast<int>(threadIdx.x) - first; q < count; q += stride) dst[q] = src[q];
}

// grid (B); block kScanThreads; dynamic shared memory (1 + 2 * tile_rows) *
// words 32-bit words: the mask, then two tiles of tile_rows packed rows.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint32_t* __restrict__ packed, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ kept, int n, int words, int tile_rows,
                int* __restrict__ launches) {
  extern __shared__ uint32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1);
  uint32_t* suppressed = smem;
  uint32_t* tiles[2] = {smem + words, smem + words + tile_rows * words};
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* rows = packed + static_cast<size_t>(b) * n * words;
  const uint8_t* row_valid = valid + static_cast<size_t>(b) * n;
  uint8_t* row_kept = kept + static_cast<size_t>(b) * n;

  // the mask starts as ~valid (and 1 past the last row)
  for (int w = warp; w < words; w += kScanThreads / 32) {
    const int j = 32 * w + lane;
    const unsigned dead = __ballot_sync(kFull, j >= n || row_valid[j] == 0);
    if (lane == 0) suppressed[w] = dead;
  }
  load_tile(tiles[0], rows, 0, min(tile_rows, n), words, 0);
  __syncthreads();

  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * tile_rows;
    if (warp == 0) {
      const uint32_t* tile = tiles[t & 1];
      const int rows_here = min(tile_rows, n - r0);
      for (int r = 0; r < rows_here; ++r) {
        const int i = r0 + r;
        // lane 0's read, broadcast: no lane writes the mask before it
        const uint32_t word = __shfl_sync(kFull, lane == 0 ? suppressed[i >> 5] : 0u, 0);
        const bool alive = ((word >> (i & 31)) & 1u) == 0;
        if (lane == 0) row_kept[i] = alive;
        if (alive) {
          for (int w = (i >> 5) + lane; w < words; w += 32) suppressed[w] |= tile[r * words + w];
        }
        __syncwarp();
      }
    } else if (t + 1 < n_tiles) {
      const int r1 = r0 + tile_rows;
      load_tile(tiles[(t + 1) & 1], rows, r1, min(tile_rows, n - r1), words, 32);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// kill: (batch, n, n) bool; valid, kept: (batch, n) bool; packed: (batch,
// n, ceil(n / 32)) 32-bit scratch. Returns cudaErrorInvalidValue for a
// shape it cannot take (n past the grid's y limit or past one tile).
int nms_scan(const uint8_t* kill, const uint8_t* valid, uint8_t* kept, uint32_t* packed,
             int batch, int n, int* launches, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int words = (n + 31) / 32;
  const int fit = (kSmemWords / words - 1) / 2;
  const int tile_rows = fit < kMaxTileRows ? fit : kMaxTileRows;
  if (tile_rows < 1 || n > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 pack_grid((words + kPackWarps - 1) / kPackWarps, n, batch);
  pack_kill_kernel<<<pack_grid, kPackWarps * 32, 0, s>>>(kill, packed, n, words);
  const cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  const size_t smem = static_cast<size_t>(1 + 2 * tile_rows) * words * sizeof(uint32_t);
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(packed, valid, kept, n, words, tile_rows,
                                                    launches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
