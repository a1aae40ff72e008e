// Batched 6x6 jittered Cholesky solve of the Gauss-Newton step, for Hopper
// (sm_90a).
//
// Replaces, for a batch of more than one pose, the library route of
// open3d_slam_torch/ops/registration.py::_solve6 (torch.linalg.cholesky_ex and
// torch.cholesky_solve), which at B > 1 goes to MAGMA's batched potrs: that
// synchronises with the host and cannot be captured into the CUDA graph of a
// Gauss-Newton loop (ops/gn_graph.py).  It computes the function of the JAX
// package's open3d_slam_tpu/ops/registration.py::_solve6 (an XLA function, not
// a Pallas kernel), in its order of operations:
//   scale = max(trace(JtJ) * (1/6), 1e-12);  A = JtJ + 1e-6 * scale * I;
//   L = cholesky(A) (lower);  x = L^-T L^-1 (-Jtr).
// The trace sums the diagonal in index order and is scaled by the float
// nearest 1/6 (PyTorch divides a CUDA tensor by a scalar so); the factor is
// left-looking (each entry is its A entry less the products of the finished
// columns, in column order, then a division by the pivot); both
// substitutions subtract in index order.  Built with -fmad=false, and sqrt and division are IEEE-rounded
// (no fast math), so each operation rounds like PyTorch's separate
// elementwise operations: the plain version (ops/cuda_solve6.solve6_plain),
// which repeats these operations on (B,) vectors, gives the same bits.
//
// What bounds it on this card: nothing but the launch.  B x 42 floats in,
// B x 6 out, ~200 operations a system; one thread a system, the 36 entries in
// registers.  JtJ and Jtr are read through their strides, so the views of the
// fused kernels' (B, 8, 128) output go in without a copy.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void solve6_kernel(const float* __restrict__ jtj, long long jb, long long jr,
                              long long jc, const float* __restrict__ jtr, long long rb,
                              long long re, float* __restrict__ out, int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* a = jtj + b * jb;
  const float* r = jtr + b * rb;
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = a[i * jr + j * jc];
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
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -r[i * re];
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
#pragma unroll
  for (int i = 0; i < 6; ++i) out[b * 6 + i] = x[i];
}

}  // namespace

extern "C" int solve6_launch(const float* jtj, long long jb, long long jr, long long jc,
                             const float* jtr, long long rb, long long re, float* out,
                             int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  solve6_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      jtj, jb, jr, jc, jtr, rb, re, out, B);
  return (int)cudaGetLastError();
}
