// The rotation of batched weighted Kabsch alignments for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. It stands for the SVD inside the jitted
// `_kabsch` of posecnn_tpu/refine/ransac.py:112-125 (jnp.linalg.svd of
// the 3x3 cross-covariance, then the reflection fix), which
// refine/ransac.estimate_pose_3d needs as a compiled program: PyTorch's
// torch.linalg.svd on a CUDA tensor copies its solver's status to the host
// to check it, and a CUDA graph capture refuses that copy.
// refine/ransac.kabsch_rotation launches it; kabsch_rotation_plain (the SVD
// and the sign fix in PyTorch ops) is its plain version.
//
// What it computes, for each of n matrices: cov (n, 3, 3) fp32 row-major
// is a weighted cross-covariance sum_k w_k (s_k - mu_s)(d_k - mu_d)^T of
// source and destination points, and the result is the rotation R (n, 3, 3)
// that maximises trace(R cov), so that d ~ R s + t:
// with cov = U S V^T, R = V diag(1, 1, det(V U^T)) U^T. Written with the two
// largest singular pairs only, that is
//   R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T,
// which needs neither the third pair nor a determinant: the cross products
// complete both bases to right-handed ones, and the product of the two
// completions carries the sign fix. R is unique where s2 > 0 (and s2 > s3
// when det(cov) < 0); U and V themselves are not (their signs are free), so
// only R is compared with the plain version.
//
// How, one thread per matrix (n is a few hundred: the RANSAC hypotheses,
// or 1 for a refinement): the matrix is scaled by its largest |entry| (R
// does not change under a positive scale, and no square under- or
// overflows), then one-sided Jacobi (Hestenes) sweeps rotate pairs of its
// columns, and the same rotations the columns of V (from the identity),
// until no pair of columns is further from orthogonal than FLT_EPSILON of
// the product of their norms, at most kMaxSweeps sweeps. The columns are
// then the singular vectors u_j times s_j = |column j|. The two longest
// give u1, u2 (ties to the lower column) and v1, v2. A matrix of rank 1
// completes u2 (and v2) with the unit vector orthogonal to u1 (v1) made from
// the axis least aligned with it; the zero matrix gives the identity.
// Each thread writes the number of sweeps it ran where `sweeps` is not
// null (chip_smoke.py's operation count reads it).
//
// What bounds it: nothing on the card. 72 bytes a matrix, ~60 fp32
// operations a column rotation, 3 rotations a sweep and 3-6 sweeps: a
// launch's worth of work.
//
// Each launch counts itself on the device (its first thread adds one to
// *launches), as the vote kernels and the NMS scan do: a CUDA graph's
// replays call no host wrapper.
//
// Build (ops/_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libkabsch.so kabsch.cu
// The entry point has a plain C interface for ctypes; it launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 16;

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

}  // namespace

extern "C" int kabsch_rotations(const float* cov, float* rot, int* sweeps, int n, int* launches,
                                cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;  // n = 0 still counts its launch
  kabsch_kernel<<<blocks, kThreads, 0, stream>>>(cov, rot, sweeps, n, launches);
  return static_cast<int>(cudaGetLastError());
}
