// Batched 6x6 jittered Cholesky solve of the Gauss-Newton step, for Hopper
// (sm_90a).
//
// Replaces, for a batch of more than one pose, the library route of
// open3d_slam_torch/ops/registration.py::_solve6 (torch.linalg.cholesky_ex and
// torch.cholesky_solve), which at B > 1 goes to MAGMA's batched potrs: that
// synchronises with the host and cannot be captured into the CUDA graph of a
// Gauss-Newton loop (ops/gn_graph.py).  It computes the function of the JAX
// package's open3d_slam_tpu/ops/registration.py::_solve6 (an XLA function, not
// a Pallas kernel) through gn::solve6 (solve6.cuh, its order of operations
// stated there), which gn_step.cu shares: the plain version
// (ops/cuda_solve6.solve6_plain), which repeats those operations on (B,)
// vectors, gives the same bits.
//
// What bounds it on this card: nothing but the launch.  B x 42 floats in,
// B x 6 out, ~200 operations a system; one thread a system, the 36 entries in
// registers.  JtJ and Jtr are read through their strides, so the views of the
// fused kernels' (B, 8, 128) output go in without a copy.
#include <cuda_runtime.h>

#include "solve6.cuh"

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
  float rr[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rr[i] = r[i * re];
  gn::solve6(A, rr, x);
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
