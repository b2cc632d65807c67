// Greedy non-maximum suppression's scan for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the device counterpart of the lax.scan
// in posecnn_tpu/ops/nms.py:34-40 (nms's `step`) and :60-66
// (nms_per_class's), which JAX jits with the programs around it: a scan of
// N dependent rows written as PyTorch ops would put thousands of nodes into
// a CUDA graph, and a host scan cannot be captured at all. ops/nms.greedy_scan
// launches it (the RPN's NMS, the detection head's per-class NMS, and the
// serving, demo and test_net programs' per-class NMS over the Hough RoIs);
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
// What bounds it on the card: a dependent chain, not bytes. Row i's
// decision needs every kept row before it. The bytes the walk needs are
// each kept row's kills of the rows after it, the valid mask and the kept
// mask: at most half the matrix, ~1.3 MB of the RPN's 4 MB (1, 2000) one
// (chip_smoke.py's `scan_bound` counts them over the memory rate). What is
// left is latency: a load round trip for each group of 32 rows that keeps
// a row, and the decisions inside a group.
//
// The design (one warp per leading index, four leading indices a block,
// one warp per scheduler of an SM), two launches a call:
//   * pack_kill_kernel turns the kill bytes into 32-bit words over the
//     whole card: packed[b][i][w] is word w of row i (bit j for column
//     32w + j). A warp packs a row from its diagonal word's piece of 16
//     words on, each lane 16 columns (one 16-byte load where N is a
//     multiple of 16), two lanes a word.
//   * nms_scan_kernel decides the rows 32 at a time, in registers. Group
//     g's rows (32g ... 32g + 31) depend on mask word g (the rows already
//     suppressed, ~valid at the start, 1 past the last row) and on the
//     group's diagonal words: lane r holds word g of row 32g + r, the row's
//     kills within its own group. Lane g % 32 broadcasts word g; the walk
//     then decides the group in rounds of two warp reductions
//     (__reduce_or_sync): a row that no undecided row before it kills is
//     kept, and the rows the newly kept ones kill are dropped. Each round
//     decides at least the first undecided row; a group whose live rows do
//     not kill each other takes one. No shared memory, no __syncwarp.
//   * Only what the walk needs is read: a group's kept rows' words right
//     of the diagonal, lanes across words (one coalesced row a load), each
//     load predicated on its row being kept (no branch, so the loads of
//     all the group's kept rows are in flight together). A suppressed
//     row's words are never read.
//   * The mask lives in registers for N <= 2048 (each lane two words);
//     past that, in shared memory (each warp N / 8 bytes), up to
//     N = 65,535.
//   * The loads are kept off the chain (registers): group g + 1 needs from
//     group g only its kept rows' word g + 1, which a warp reduction takes
//     from words every lane loaded ahead (word g + 1 of its row, beside
//     the diagonal word). Group g's loads of its kept rows' further words
//     are OR-ed into the mask only after group g + 1's walk, so their round
//     trip overlaps it; group g + 1's diagonal words are loaded before
//     group g is walked.
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

constexpr int kPackWarps = 8;       // rows packed by one pack block, one a warp
constexpr int kScanWarps = 4;       // leading indices a scan block walks, one a warp
constexpr int kRegisterWords = 64;  // the mask in registers up to N = 2048
constexpr int kValidInFlight = 16;  // the valid mask's words loaded together
constexpr unsigned kFull = 0xffffffffu;

// A load that happens only where p holds (else 0): a predicated load, no
// branch, so a run of them stays in flight together.
__device__ __forceinline__ unsigned load_word_if(bool p, const uint32_t* a) {
  unsigned v = 0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.global.nc.b32 %0, [%1];\n\t}"
      : "+r"(v) : "l"(a), "r"(static_cast<int>(p)));
  return v;
}

__device__ __forceinline__ unsigned load_byte_if(bool p, const uint8_t* a) {
  unsigned v = 0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.global.nc.u8 %0, [%1];\n\t}"
      : "+r"(v) : "l"(a), "r"(static_cast<int>(p)));
  return v;
}

// 4 bytes -> 4 bits: bit k set where byte k is not 0
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// grid (ceil(B·N / kPackWarps)); block kPackWarps warps. Warp p of block x
// packs row x * kPackWarps + p of the (B·N)-row matrix from its diagonal
// word's piece of 16 words on: lane l turns columns 16l ... 16l + 15 of a
// 512-column piece into 16 bits (kVec: one 16-byte load, N a multiple of
// 16 and kill 16-byte aligned), and lanes 2k and 2k + 1 make word k.
template <bool kVec>
__global__ void __launch_bounds__(kPackWarps * 32)
pack_kill_kernel(const uint8_t* __restrict__ kill, uint32_t* __restrict__ packed, size_t rows,
                 int n, int words) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const uint8_t* src = kill + row * n;
  uint32_t* dst = packed + row * words;
  for (int c = static_cast<int>(row % n) >> 9; 512 * c < n; ++c) {
    const int col = 512 * c + 16 * lane;
    unsigned bits = 0;
    if (kVec) {
      if (col < n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + col));
        bits = nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12;
      }
    } else {
      for (int k = 0; k < 16 && col + k < n; ++k) {
        bits |= static_cast<unsigned>(src[col + k] != 0) << k;
      }
    }
    const unsigned word = bits | __shfl_down_sync(kFull, bits, 1) << 16;
    const int w = 16 * c + (lane >> 1);
    if ((lane & 1) == 0 && w < words) dst[w] = word;
  }
}

// the walk of one group, in rounds over its undecided rows (neither
// suppressed nor invalid): a row that no undecided row before it kills is
// kept, and the rows it kills are dropped. cur: the group's mask word;
// diag: lane r's row's word of the group. Returns the kept rows' bits.
__device__ __forceinline__ unsigned walk(unsigned cur, unsigned diag, int lane) {
  const unsigned later = diag & ~((2u << lane) - 1u);  // lane's row's kills after it
  unsigned undecided = ~cur, kept_bits = 0;
  while (undecided) {
    const unsigned blocked = __reduce_or_sync(kFull, (undecided >> lane) & 1u ? later : 0u);
    const unsigned now = undecided & ~blocked;
    kept_bits |= now;
    const unsigned killed = __reduce_or_sync(kFull, (now >> lane) & 1u ? later : 0u);
    undecided &= ~(now | killed);
  }
  return kept_bits;
}

// grid (ceil(B / kScanWarps)); block min(B, kScanWarps) warps; warp k of
// block x walks leading index b = x * kScanWarps + k, reading
// pack_kill_kernel's words. kShared: the mask in dynamic shared memory,
// `words` 32-bit words a warp; else two a lane in registers (words <=
// kRegisterWords), the loads kept off the chain.
template <bool kShared>
__global__ void __launch_bounds__(kScanWarps * 32)
nms_scan_kernel(const uint32_t* __restrict__ packed, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ kept, int batch, int n, int* __restrict__ launches) {
  extern __shared__ uint32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kScanWarps + warp;
  if (b >= batch) return;  // uniform per warp
  const int words = (n + 31) >> 5;
  const uint8_t* row_valid = valid + static_cast<size_t>(b) * n;
  uint8_t* row_kept = kept + static_cast<size_t>(b) * n;
  // row i's words: rows + i * words
  const uint32_t* rows = packed + static_cast<size_t>(b) * n * words;
  uint32_t* mask = smem + warp * words;  // kShared
  unsigned m0 = 0, m1 = 0;               // !kShared: words lane and lane + 32

  // the mask starts as ~valid (and 1 past the last row)
  for (int w0 = 0; w0 < words; w0 += kValidInFlight) {
    unsigned v[kValidInFlight];
#pragma unroll
    for (int k = 0; k < kValidInFlight; ++k) {
      const int j = 32 * (w0 + k) + lane;
      v[k] = load_byte_if(j < n, row_valid + j);
    }
#pragma unroll
    for (int k = 0; k < kValidInFlight; ++k) {
      const int w = w0 + k;
      if (w >= words) break;  // uniform
      const unsigned dead = __ballot_sync(kFull, 32 * w + lane >= n || v[k] == 0);
      if (kShared) {
        if (lane == 0) mask[w] = dead;
      } else if (lane == (w & 31)) {
        if (w < 32) m0 = dead; else m1 = dead;
      }
    }
  }

  // lane r's row of group g: its words g (diagonal) and g + 1
  const auto row_word = [&](int g, int w) {
    const int i = 32 * g + lane;
    return load_word_if(i < n && w < words, rows + static_cast<size_t>(i) * words + w);
  };
  unsigned diag = row_word(0, 0);

  if (kShared) {
    __syncwarp();
    for (int g = 0; g < words; ++g) {
      const unsigned next = row_word(g + 1, g + 1);  // in flight during the walk
      const int i0 = 32 * g;
      const unsigned kept_bits = walk(mask[g], diag, lane);
      if (i0 + lane < n) row_kept[i0 + lane] = (kept_bits >> lane) & 1u;
      // the kept rows' words right of the diagonal: lane's words w = lane,
      // lane + 32, ..., every kept row's load of a word in flight together
      for (int w = lane; w < words; w += 32) {
        const uint32_t* col = rows + static_cast<size_t>(i0) * words + w;
        unsigned acc = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q)
          acc |= load_word_if(((kept_bits >> q) & 1u) && w > g,
                              col + static_cast<size_t>(q) * words);
        mask[w] |= acc;
      }
      __syncwarp();  // the owners' writes before word g + 1 is read
      diag = next;
    }
    return;
  }

  // registers: group g's loads of its kept rows' words past g + 1 go into
  // one buffer while the other's, group g - 1's, are OR-ed into the mask
  unsigned right = row_word(0, 1);  // word g + 1 of lane's row of group g
  unsigned carry = 0;               // group g - 1's kept rows' word g
  unsigned a0[32], a1[32], b0[32], b1[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) b0[q] = b1[q] = 0u;
  const auto group = [&](int g, unsigned (&out0)[32], unsigned (&out1)[32], unsigned (&in0)[32],
                         unsigned (&in1)[32]) {
    const unsigned next_diag = row_word(g + 1, g + 1), next_right = row_word(g + 1, g + 2);
    const int i0 = 32 * g;
    const unsigned cur = __shfl_sync(kFull, g < 32 ? m0 : m1, g & 31) | carry;
    const unsigned kept_bits = walk(cur, diag, lane);
    if (i0 + lane < n) row_kept[i0 + lane] = (kept_bits >> lane) & 1u;
    carry = __reduce_or_sync(kFull, (kept_bits >> lane) & 1u ? right : 0u);
    const uint32_t* col = rows + static_cast<size_t>(i0) * words + lane;
    const bool own0 = lane > g + 1 && lane < words, own1 = lane + 32 > g + 1 && lane + 32 < words;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const bool live = (kept_bits >> q) & 1u;
      out0[q] = load_word_if(live && own0, col + static_cast<size_t>(q) * words);
      out1[q] = load_word_if(live && own1, col + static_cast<size_t>(q) * words + 32);
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      m0 |= in0[q];
      m1 |= in1[q];
    }
    diag = next_diag;
    right = next_right;
  };
  for (int g = 0; g < words; g += 2) {
    group(g, a0, a1, b0, b1);
    if (g + 1 < words) group(g + 1, b0, b1, a0, a1);
  }
}

}  // namespace

extern "C" {

// kill: (batch, n, n) bool; valid, kept: (batch, n) bool; packed: (batch,
// n, ceil(n / 32)) 32-bit scratch. Returns cudaErrorInvalidValue for a
// shape it cannot take (n or batch past 65,535).
int nms_scan(const uint8_t* kill, const uint8_t* valid, uint8_t* kept, uint32_t* packed,
             int batch, int n, int* launches, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + 31) / 32;
  const size_t rows = static_cast<size_t>(batch) * n;
  const dim3 pack_grid(static_cast<unsigned>((rows + kPackWarps - 1) / kPackWarps));
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(kill) % 16 == 0) {
    pack_kill_kernel<true><<<pack_grid, kPackWarps * 32, 0, s>>>(kill, packed, rows, n, words);
  } else {
    pack_kill_kernel<false><<<pack_grid, kPackWarps * 32, 0, s>>>(kill, packed, rows, n, words);
  }
  const cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  const int warps = batch < kScanWarps ? batch : kScanWarps;
  const dim3 grid((batch + kScanWarps - 1) / kScanWarps);
  if (words <= kRegisterWords) {
    nms_scan_kernel<false><<<grid, 32 * warps, 0, s>>>(packed, valid, kept, batch, n, launches);
  } else {
    const size_t smem = static_cast<size_t>(warps) * words * sizeof(uint32_t);
    nms_scan_kernel<true><<<grid, 32 * warps, smem, s>>>(packed, valid, kept, batch, n, launches);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
