// The jittered 6x6 Cholesky solve of a Gauss-Newton step on one thread, in
// float32: the function of the JAX package's
// open3d_slam_tpu/ops/registration.py::_solve6, in one fixed order of
// operations, shared by solve6.cu (the solve alone) and gn_step.cu (the
// whole step after a sweep), so that the two cannot drift apart:
//   scale = max(trace(A) * (1/6), 1e-12);  A' = A + 1e-6 * scale * I;
//   L = cholesky(A') (lower);  x = L^-T L^-1 (-r).
// The trace sums the diagonal in index order and is scaled by the float
// nearest 1/6 (PyTorch divides a CUDA tensor by a scalar so); the factor is
// left-looking (each entry is its A entry less the products of the finished
// columns, in column order, then a division by the pivot); both
// substitutions subtract in index order.  Built with -fmad=false, and sqrt
// and division IEEE-rounded (no fast math), so each operation rounds like
// PyTorch's separate elementwise operations: ops/cuda_solve6.solve6_plain
// repeats them on (B,) vectors and gives the same bits.
#pragma once

#include <math.h>

namespace gn {

// A (6x6, only its lower triangle and diagonal are read) and r (6) in
// registers; x (6) out.
__device__ __forceinline__ void solve6(const float A[6][6], const float r[6], float x[6]) {
  float tr = A[0][0];
#pragma unroll
  for (int i = 1; i < 6; ++i) tr = tr + A[i][i];
  float scale = tr * (1.0f / 6.0f);
  scale = scale < 1e-12f ? 1e-12f : scale;   // NaN stays NaN, as torch.clamp
  const float jitter = 1e-6f * scale;
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j] + jitter;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

}  // namespace gn
