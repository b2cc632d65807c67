// RANSAC's rigid-pose kernels for NVIDIA Hopper (sm_90a): the rotation of
// batched weighted Kabsch alignments, and the two kernels that are
// refine/ransac.estimate_pose_3d on the card.
//
// Replaces no Pallas kernel. They stand for the jitted body of
// posecnn_tpu/refine/ransac.py:135-189 (`estimate_pose_3d`), which
// refine/ransac.estimate_pose_3d needs as a compiled program: PyTorch's
// torch.linalg.svd on a CUDA tensor copies its solver's status to the host
// to check it, and a CUDA graph capture refuses that copy.
//
//   kabsch_kernel           the SVD and reflection fix inside `_kabsch`
//                           (ransac.py:112-125) for n covariances; launched
//                           by refine/ransac.kabsch_rotation, plain version
//                           kabsch_rotation_plain. Since estimate_pose_3d
//                           became the two kernels below it runs on no
//                           program path: it is the port's rotation op and
//                           the unit check of kabsch_one, which they share.
//   pose_hypotheses_kernel  the vmapped `hyp` (ransac.py:155-163): each
//                           hypothesis' fit to its three correspondences
//                           and its inlier count over all N points;
//                           refine/ransac.pose_hypotheses, plain version
//                           pose_hypotheses_plain.
//   pose_refine_kernel      `best`, `any_ok`, the lax.scan refinement and
//                           the final count (ransac.py:165-189);
//                           refine/ransac.pose_refine, plain version
//                           pose_refine_plain.
//
// The rotation (kabsch_one): cov (3, 3) fp32 row-major is a weighted
// cross-covariance sum_k w_k (s_k - mu_s)(d_k - mu_d)^T of source and
// destination points, and the result is the rotation R that maximises
// trace(R cov), so that d ~ R s + t: with cov = U S V^T,
// R = V diag(1, 1, det(V U^T)) U^T. Written with the two largest singular
// pairs only, that is
//   R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T,
// which needs neither the third pair nor a determinant: the cross products
// complete both bases to right-handed ones, and the product of the two
// completions carries the sign fix. R is unique where s2 > 0 (and s2 > s3
// when det(cov) < 0); U and V themselves are not (their signs are free), so
// only R is compared with the plain version. The matrix is scaled by its
// largest |entry| (R does not change under a positive scale, and no square
// under- or overflows), then one-sided Jacobi (Hestenes) sweeps rotate
// pairs of its columns, and the same rotations the columns of V (from the
// identity), until no pair of columns is further from orthogonal than
// FLT_EPSILON of the product of their norms, at most kMaxSweeps sweeps. The
// columns are then the singular vectors u_j times s_j = |column j|. The two
// longest give u1, u2 (ties to the lower column) and v1, v2. A matrix of
// rank 1 completes u2 (and v2) with the unit vector orthogonal to u1 (v1)
// made from the axis least aligned with it; the zero matrix gives the
// identity. It is one thread's chain of dependent fp32 operations (3-6
// sweeps of 3 column rotations): a few microseconds, whatever else runs.
//
// kabsch_kernel, one thread a matrix; each thread writes the sweeps it ran
// where `sweeps` is not null (chip_smoke.py's operation counts read them).
// What bounds it: nothing on the card, 72 bytes a matrix and ~60 fp32
// operations a column rotation: a launch's worth of work.
//
// pose_hypotheses_kernel: a block of kHypThreads threads a hypothesis.
// Thread 0 gathers its three pairs and their valid flags, forms the
// weighted means and the centred cross-covariance in the order of
// refine/ransac.weighted_covariance, runs kabsch_one and t = mu_d - R mu_s,
// and puts (R, t) in shared memory. Every thread takes its points from
// device memory (N * 25 bytes, in L2 after the first blocks) kBatch at a
// time, all of a batch's loads in flight together, the first batch while
// the fit runs, and tests each against the fit: |R s + t - d| < threshold
// (the square root and `<`, as the plain version compares, so the edge
// cases agree) and valid. A warp counts its inliers by
// __popc(__ballot_sync(...)), and the warps' counts are summed in shared
// memory. Scores are the counts, or -1 where the triple holds an invalid
// entry (an index outside [0, N) counts as one; the plain version would
// raise on it). Each point is read once a block, so it is not staged in
// shared memory. Blocks that took 2-8 hypotheses each (fewer blocks, each
// point's L2 read shared by their fits) were slower on an H100 at 4096 and
// at 65536 points, about in step with the fits a block (PERF.md §6). What
// bounds it: ~28 fp32 operations a (hypothesis, point) pair, Hyp * N of
// them, against N * 25 + Hyp * 80 bytes; at (4096, 256) both are well under
// the chain of one fit, so a launch is a fit's latency plus the scoring.
//
// pose_refine_kernel: one block of kRefineThreads threads. Where N is at
// most kRefineThreads * kBatch (4096), each thread loads its points once,
// while the argmax runs, and keeps them in registers for all the passes
// below; beyond that every pass streams them a batch at a time. The argmax
// of the scores, the first maximum on ties (as torch.argmax and
// jnp.argmax), by a strided scan and a shuffle reduction; then `num_refine`
// rounds, each two passes over the points as the plain version's two-pass
// covariance: the inliers' count and sums of s and d (the means), then the centred
// sum_w (s - mu_s)(d - mu_d)^T, each reduced by warp shuffles and one
// shared-memory step in a fixed order (no atomics: the same bits on every
// launch, so a compiled call equals the eager one); thread 0 runs
// kabsch_one and t = mu_d - R mu_s, and (R, t) is replaced only where at
// least 3 points are inliers (where fewer are the rotation is not computed:
// the plain version computes it and throws it away). Then the final inlier
// count and the count of valid entries: inliers and score = inliers /
// max(valid, 1), both 0 where no hypothesis was usable. A point that is no
// inlier is skipped where the plain version adds it times w = 0, so its
// coordinates must be finite for the two to agree. What bounds it: N * 25
// bytes and ~28 operations a point a round, a launch's worth; the time is
// two fits' chains, the block's barriers and, past 4096 points, the
// streamed passes.
//
// Each launch counts itself on the device (its first thread adds one to
// *launches), as the vote kernels and the NMS scan do: a CUDA graph's
// replays call no host wrapper.
//
// Build (ops/_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libkabsch.so kabsch.cu
// The entry points have a plain C interface for ctypes; each launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 16;
constexpr int kHypThreads = 256;     // pose_hypotheses_kernel's block
constexpr int kRefineThreads = 512;  // pose_refine_kernel's one block
constexpr int kBatch = 8;            // points a thread loads at once, all in flight together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// b := the unit vector orthogonal to the unit vector a, made from the axis
// least aligned with a.
__device__ __forceinline__ void orthogonal_unit(const float a[3], float b[3]) {
  float axis[3] = {0.0f, 0.0f, 0.0f};
  const float x = fabsf(a[0]), y = fabsf(a[1]), z = fabsf(a[2]);
  axis[(x <= y && x <= z) ? 0 : (y <= z ? 1 : 2)] = 1.0f;
  cross(a, axis, b);
  const float norm = sqrtf(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  for (int r = 0; r < 3; ++r) b[r] /= norm;
}

// The rotation of one covariance c (row-major 3x3) into r; returns the
// sweeps run.
__device__ int kabsch_one(const float* __restrict__ c, float* __restrict__ r) {
  float a[3][3], v[3][3];
  float scale = 0.0f;
  for (int i = 0; i < 9; ++i) scale = fmaxf(scale, fabsf(c[i]));
  if (!(scale > 0.0f)) {  // the zero matrix: the identity
    for (int i = 0; i < 9; ++i) r[i] = (i % 4 == 0) ? 1.0f : 0.0f;
    return 0;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = c[3 * i + j] / scale;
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  int sweep = 0;
  for (bool rotated = true; rotated && sweep < kMaxSweeps; ++sweep) {
    rotated = false;
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
      for (int i = 0; i < 3; ++i) {
        alpha += a[i][p] * a[i][p];
        beta += a[i][q] * a[i][q];
        gamma += a[i][p] * a[i][q];
      }
      if (!(fabsf(gamma) > FLT_EPSILON * sqrtf(alpha * beta))) continue;
      rotated = true;
      const float zeta = (beta - alpha) / (2.0f * gamma);
      const float t = copysignf(1.0f, zeta) / (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
      const float cs = 1.0f / sqrtf(1.0f + t * t), sn = cs * t;
      for (int i = 0; i < 3; ++i) {
        const float ap = a[i][p], aq = a[i][q];
        a[i][p] = cs * ap - sn * aq;
        a[i][q] = sn * ap + cs * aq;
        const float vp = v[i][p], vq = v[i][q];
        v[i][p] = cs * vp - sn * vq;
        v[i][q] = sn * vp + cs * vq;
      }
    }
  }
  float norm2[3];
  for (int j = 0; j < 3; ++j) norm2[j] = a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j];
  // the two longest columns, ties to the lower index
  const int j1 = (norm2[0] >= norm2[1] && norm2[0] >= norm2[2]) ? 0 : (norm2[1] >= norm2[2] ? 1 : 2);
  const int k1 = j1 == 0 ? 1 : 0, k2 = j1 == 2 ? 1 : 2;
  const int j2 = norm2[k1] >= norm2[k2] ? k1 : k2;
  float u1[3], u2[3], v1[3], v2[3], u3[3], v3[3];
  const float s1 = sqrtf(norm2[j1]), s2 = sqrtf(norm2[j2]);
  for (int i = 0; i < 3; ++i) {
    u1[i] = a[i][j1] / s1;
    v1[i] = v[i][j1];
    v2[i] = v[i][j2];
  }
  if (s2 > 0.0f) {
    for (int i = 0; i < 3; ++i) u2[i] = a[i][j2] / s2;
  } else {  // rank 1: any completion is a maximiser
    orthogonal_unit(u1, u2);
    orthogonal_unit(v1, v2);
  }
  cross(u1, u2, u3);
  cross(v1, v2, v3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = v1[i] * u1[j] + v2[i] * u2[j] + v3[i] * u3[j];
  return sweep;
}

// grid ceil(n / kThreads), block kThreads: thread i handles matrix i.
__global__ void __launch_bounds__(kThreads)
kabsch_kernel(const float* __restrict__ cov, float* __restrict__ rot, int* __restrict__ sweeps,
              int n, int* __restrict__ launches) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) atomicAdd(launches, 1);
  if (i >= n) return;
  const int ran = kabsch_one(cov + 9 * static_cast<size_t>(i), rot + 9 * static_cast<size_t>(i));
  if (sweeps != nullptr) sweeps[i] = ran;
}

// t = mu_d - R mu_s, as refine/ransac._kabsch forms it.
__device__ __forceinline__ void translation(const float r[9], const float mu_s[3],
                                            const float mu_d[3], float t[3]) {
  for (int j = 0; j < 3; ++j)
    t[j] = mu_d[j] - (r[3 * j] * mu_s[0] + r[3 * j + 1] * mu_s[1] + r[3 * j + 2] * mu_s[2]);
}

// Whether the point (s, d, valid v) is an inlier of the pose f (R
// row-major, then t): |R s + t - d| < threshold and v.
__device__ __forceinline__ bool inlier(const float f[12], const float s[3], const float d[3],
                                       bool v, float threshold) {
  const float e0 = f[0] * s[0] + f[1] * s[1] + f[2] * s[2] + f[9] - d[0];
  const float e1 = f[3] * s[0] + f[4] * s[1] + f[5] * s[2] + f[10] - d[1];
  const float e2 = f[6] * s[0] + f[7] * s[1] + f[8] * s[2] + f[11] - d[2];
  return v && sqrtf(e0 * e0 + e1 * e1 + e2 * e2) < threshold;
}

// One batch of a thread's points: base + u * kStride + threadIdx.x for
// u < kBatch (neighbouring threads on neighbouring points), their loads
// issued together; past n, invalid zeros.
struct Batch {
  float s[kBatch][3], d[kBatch][3];
  bool v[kBatch];
};

template <int kStride>
__device__ __forceinline__ void load_batch(const float* __restrict__ obj,
                                           const float* __restrict__ cam,
                                           const unsigned char* __restrict__ valid, int n,
                                           int base, Batch& b) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = base + u * kStride + static_cast<int>(threadIdx.x);
    const bool in = i < n;
    for (int k = 0; k < 3; ++k) {
      b.s[u][k] = in ? obj[3 * static_cast<size_t>(i) + k] : 0.0f;
      b.d[u][k] = in ? cam[3 * static_cast<size_t>(i) + k] : 0.0f;
    }
    b.v[u] = in && valid[i] != 0;
  }
}

// The fit of one hypothesis' three correspondences (indices idx, weights
// valid[idx]) into f (R, then t): weighted means and centred
// cross-covariance as refine/ransac.weighted_covariance forms them, then
// kabsch_one. Returns whether all three are valid.
__device__ bool fit_triple(const float* __restrict__ obj, const float* __restrict__ cam,
                          const unsigned char* __restrict__ valid,
                          const long long* __restrict__ idx, int n, float f[12]) {
  float s[3][3], d[3][3], w[3];
  for (int k = 0; k < 3; ++k) {
    const long long i = idx[k];
    const bool in_range = i >= 0 && i < n;
    w[k] = in_range && valid[i] ? 1.0f : 0.0f;
    for (int j = 0; j < 3; ++j) {
      s[k][j] = in_range ? obj[3 * i + j] : 0.0f;
      d[k][j] = in_range ? cam[3 * i + j] : 0.0f;
    }
  }
  const float total = w[0] + w[1] + w[2];
  const float wsum = fmaxf(total, 1e-10f);
  float mu_s[3], mu_d[3], cov[9];
  for (int j = 0; j < 3; ++j) {
    mu_s[j] = (s[0][j] * w[0] + s[1][j] * w[1] + s[2][j] * w[2]) / wsum;
    mu_d[j] = (d[0][j] * w[0] + d[1][j] * w[1] + d[2][j] * w[2]) / wsum;
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float c = 0.0f;
      for (int k = 0; k < 3; ++k) c += ((s[k][a] - mu_s[a]) * w[k]) * (d[k][b] - mu_d[b]);
      cov[3 * a + b] = c;
    }
  kabsch_one(cov, f);
  translation(f, mu_s, mu_d, f + 9);
  return total == 3.0f;
}

// grid hyp, block kHypThreads: block h scores hypothesis h over all n
// points.
__global__ void __launch_bounds__(kHypThreads)
pose_hypotheses_kernel(const float* __restrict__ obj, const float* __restrict__ cam,
                       const unsigned char* __restrict__ valid,
                       const long long* __restrict__ triples, float* __restrict__ rs,
                       float* __restrict__ ts, long long* __restrict__ scores, int n, int hyp,
                       float threshold, int* __restrict__ launches) {
  __shared__ float fit[12];
  __shared__ bool usable;
  __shared__ unsigned warp_counts[kHypThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x;
  if (h == 0 && threadIdx.x == 0) atomicAdd(launches, 1);
  Batch b;  // the first batch's loads run while the fit does
  load_batch<kHypThreads>(obj, cam, valid, n, 0, b);
  if (threadIdx.x == 0) {
    float f[12] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    bool ok = false;
    if (h < hyp) {  // hyp = 0 launches one block, which only counts itself
      ok = fit_triple(obj, cam, valid, triples + 3 * static_cast<size_t>(h), n, f);
      for (int k = 0; k < 9; ++k) rs[9 * static_cast<size_t>(h) + k] = f[k];
      for (int k = 0; k < 3; ++k) ts[3 * static_cast<size_t>(h) + k] = f[9 + k];
    }
    for (int k = 0; k < 12; ++k) fit[k] = f[k];
    usable = ok;
  }
  __syncthreads();
  unsigned count = 0;
  for (int base = 0; base < n; base += kHypThreads * kBatch) {  // warp-uniform trip count
    if (base > 0) load_batch<kHypThreads>(obj, cam, valid, n, base, b);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      count += __popc(__ballot_sync(kFull, inlier(fit, b.s[u], b.d[u], b.v[u], threshold)));
  }
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0 && h < hyp) {
    long long total = 0;
    for (int w = 0; w < kHypThreads / 32; ++w) total += warp_counts[w];
    scores[h] = usable ? total : -1;
  }
}

// The sums of K per-thread values over the block into out (shared), in a
// fixed order: each warp by shuffles, then warp 0 over the warps' sums.
// Every thread of the block calls it; out is ready when it returns.
// partial holds K values a warp.
template <int K, typename T>
__device__ void block_sum(T (&v)[K], T* partial, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
  if (lane == 0)
    for (int k = 0; k < K; ++k) partial[K * warp + k] = v[k];
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < K; ++k) {
      T x = lane < kRefineThreads / 32 ? partial[K * lane + k] : T(0);
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) out[k] = x;
    }
  }
  __syncthreads();
}

// grid 1, block kRefineThreads.
__global__ void __launch_bounds__(kRefineThreads)
pose_refine_kernel(const float* __restrict__ obj, const float* __restrict__ cam,
                   const unsigned char* __restrict__ valid, const float* __restrict__ rs,
                   const float* __restrict__ ts, const long long* __restrict__ scores, int n,
                   int hyp, float threshold, int num_refine, float* __restrict__ rotation,
                   float* __restrict__ translation_out, float* __restrict__ inliers,
                   float* __restrict__ score, int* __restrict__ launches) {
  constexpr int kWarps = kRefineThreads / 32;
  __shared__ long long best_score[kWarps];
  __shared__ int best_index[kWarps];
  __shared__ float pose[12];
  __shared__ float fpartial[kWarps * 9];
  __shared__ int ipartial[kWarps * 2];
  __shared__ float fsum[9];
  __shared__ int isum[2];
  __shared__ bool any_ok;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) atomicAdd(launches, 1);
  // where the points fit in one batch a thread, they stay in its registers
  // for every pass (loaded while the argmax runs); else each pass streams
  // them a batch at a time
  constexpr int kSpan = kRefineThreads * kBatch;
  const bool resident = n <= kSpan;
  Batch b;
  if (resident) load_batch<kRefineThreads>(obj, cam, valid, n, 0, b);

  // the first maximum: each thread's over its ascending stride, then the
  // larger score or, on a tie, the lower index
  long long bv = LLONG_MIN;
  int bi = INT_MAX;
  for (int h = threadIdx.x; h < hyp; h += kRefineThreads)
    if (scores[h] > bv) {
      bv = scores[h];
      bi = h;
    }
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_score[warp] = bv;
    best_index[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (best_score[w] > bv || (best_score[w] == bv && best_index[w] < bi)) {
        bv = best_score[w];
        bi = best_index[w];
      }
    any_ok = bv >= 0;
    for (int k = 0; k < 9; ++k) pose[k] = rs[9 * static_cast<size_t>(bi) + k];
    for (int k = 0; k < 3; ++k) pose[9 + k] = ts[3 * static_cast<size_t>(bi) + k];
  }
  __syncthreads();

  for (int round = 0; round < num_refine; ++round) {
    // pass 1: the inliers' count and sums of s and d
    float f[12];
    for (int k = 0; k < 12; ++k) f[k] = pose[k];
    int cnt[1] = {0};
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = 0; base < n; base += kSpan) {
      if (!resident) load_batch<kRefineThreads>(obj, cam, valid, n, base, b);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (inlier(f, b.s[u], b.d[u], b.v[u], threshold)) {
          ++cnt[0];
          for (int k = 0; k < 3; ++k) {
            acc[k] += b.s[u][k];
            acc[3 + k] += b.d[u][k];
          }
        }
    }
    block_sum<1>(cnt, ipartial, isum);
    block_sum<6>(acc, fpartial, fsum);
    const int w_count = isum[0];
    const float wsum = fmaxf(static_cast<float>(w_count), 1e-10f);
    float mu_s[3], mu_d[3];
    for (int k = 0; k < 3; ++k) {
      mu_s[k] = fsum[k] / wsum;
      mu_d[k] = fsum[3 + k] / wsum;
    }
    // pass 2: the centred cross-covariance of the same inliers
    float cov[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = 0; base < n; base += kSpan) {
      if (!resident) load_batch<kRefineThreads>(obj, cam, valid, n, base, b);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (inlier(f, b.s[u], b.d[u], b.v[u], threshold))
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c)
              cov[3 * r + c] += (b.s[u][r] - mu_s[r]) * (b.d[u][c] - mu_d[c]);
    }
    block_sum<9>(cov, fpartial, fsum);
    if (threadIdx.x == 0 && static_cast<float>(w_count) >= 3.0f) {
      float g[12];
      kabsch_one(fsum, g);
      translation(g, mu_s, mu_d, g + 9);
      for (int k = 0; k < 12; ++k) pose[k] = g[k];
    }
    __syncthreads();
  }

  // the final count, and the valid entries'
  float f[12];
  for (int k = 0; k < 12; ++k) f[k] = pose[k];
  int cnt[2] = {0, 0};
  for (int base = 0; base < n; base += kSpan) {
    if (!resident) load_batch<kRefineThreads>(obj, cam, valid, n, base, b);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      cnt[0] += inlier(f, b.s[u], b.d[u], b.v[u], threshold);
      cnt[1] += b.v[u];
    }
  }
  block_sum<2>(cnt, ipartial, isum);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) rotation[k] = f[k];
    for (int k = 0; k < 3; ++k) translation_out[k] = f[9 + k];
    const float inl = static_cast<float>(isum[0]);
    inliers[0] = any_ok ? inl : 0.0f;
    score[0] = any_ok ? inl / static_cast<float>(max(isum[1], 1)) : 0.0f;
  }
}

}  // namespace

extern "C" int kabsch_rotations(const float* cov, float* rot, int* sweeps, int n, int* launches,
                                cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;  // n = 0 still counts its launch
  kabsch_kernel<<<blocks, kThreads, 0, stream>>>(cov, rot, sweeps, n, launches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_hypotheses(const float* obj, const float* cam, const unsigned char* valid,
                               const long long* triples, float* rs, float* ts, long long* scores,
                               int n, int hyp, float threshold, int* launches,
                               cudaStream_t stream) {
  if (n < 0 || hyp < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = hyp > 0 ? hyp : 1;  // hyp = 0 still counts its launch
  pose_hypotheses_kernel<<<blocks, kHypThreads, 0, stream>>>(obj, cam, valid, triples, rs, ts,
                                                             scores, n, hyp, threshold, launches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_refine(const float* obj, const float* cam, const unsigned char* valid,
                           const float* rs, const float* ts, const long long* scores, int n,
                           int hyp, float threshold, int num_refine, float* rotation,
                           float* translation, float* inliers, float* score, int* launches,
                           cudaStream_t stream) {
  if (n < 0 || hyp < 1 || num_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
  pose_refine_kernel<<<1, kRefineThreads, 0, stream>>>(obj, cam, valid, rs, ts, scores, n, hyp,
                                                       threshold, num_refine, rotation,
                                                       translation, inliers, score, launches);
  return static_cast<int>(cudaGetLastError());
}
