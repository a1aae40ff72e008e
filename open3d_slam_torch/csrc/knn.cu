// Exact brute-force nearest neighbour (running min / argmin) for Hopper (sm_90a).
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_knn.py::nn_argmin (body
// _nn_kernel).  It computes the same function: for every query q, over all
// targets t, the running (min, argmin) of the expansion-form squared distance
//     d2 = (|q|^2 + |t|^2) - 2 (q . t)
// with invalid targets masked by |t|^2 = +inf.  Ties go to the lowest target
// index, as the Pallas kernel's in-tile jnp.argmin and its strict
// cross-tile update give.  Outputs: (M,) int32 index, (M,) float32 d2.
//
// What bounds it on this card: operations.  The sweep is M x N pairs of ~9
// float32 operations (32768 x 65536 on the loop-closure path: ~19 GFLOP),
// while it moves about 1.5 MB.  The bound at 67 TFLOP/s is ~0.29 ms.
//
// What the design does about it (simple and right first):
//   * one thread per query keeps its running (min d2, argmin) in registers;
//     target tiles of 256 points are staged through shared memory as float4
//     (x, y, z, |t|^2) and read as warp-wide broadcasts (the layout of K1's
//     csrc/gicp.cu);
//   * the target axis is split across blocks (grid.y) so that the grid fills
//     all SMs; each split writes its own (d2, index) and a second kernel
//     merges the splits in index order with a strict <, so the result is the
//     global first minimum whatever order the blocks ran in;
//   * the dot product and the sum are rounded term by term in the JAX
//     operand order (__fmul_rn / __fadd_rn / __fsub_rn) and the file is
//     built with -fmad=false, so the kernel's d2 equals the plain PyTorch
//     version's elementwise d2 bit for bit and the indices are equal;
//   * no float atomics: results are bit-reproducible run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 256;      // targets per shared-memory tile

__device__ __forceinline__ float expansion_d2(float qx, float qy, float qz,
                                              float q2, float4 t) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, t.x), __fmul_rn(qy, t.y)),
                              __fmul_rn(qz, t.z));
  return __fsub_rn(__fadd_rn(q2, t.w), __fmul_rn(2.0f, dot));
}

// grid (q_blocks, splits); block kThreads.
__global__ void knn_partial(const float* __restrict__ q,
                            const float* __restrict__ q2,
                            const float* __restrict__ t_t,
                            const float* __restrict__ t2,
                            float* __restrict__ part_d2,
                            int* __restrict__ part_idx,
                            int M, int N, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool active = i < M;
  float qx = 0.f, qy = 0.f, qz = 0.f, qq = 0.f;
  if (active) {
    qx = q[(size_t)i * 3 + 0];
    qy = q[(size_t)i * 3 + 1];
    qz = q[(size_t)i * 3 + 2];
    qq = q2[i];
  }
  float best = __int_as_float(0x7f800000);   // +inf: a fully masked row keeps 0
  int arg = 0;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int base = t * kTile;
    for (int k = tid; k < kTile; k += kThreads) {
      const int j = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < N) {
        v.x = t_t[j];
        v.y = t_t[(size_t)N + j];
        v.z = t_t[(size_t)2 * N + j];
        v.w = t2[j];
      }
      tile[k] = v;
    }
    __syncthreads();
    const int cnt = min(kTile, N - base);
    for (int k = 0; k < cnt; ++k) {
      const float d = expansion_d2(qx, qy, qz, qq, tile[k]);
      if (d < best) {
        best = d;
        arg = base + k;
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t o = (size_t)split * M + i;
    part_d2[o] = best;
    part_idx[o] = arg;
  }
}

// grid ceil(M / kThreads); block kThreads: the splits merged in index order.
__global__ void knn_merge(const float* __restrict__ part_d2,
                          const int* __restrict__ part_idx,
                          int* __restrict__ out_idx,
                          float* __restrict__ out_d2, int M, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  float best = part_d2[i];
  int arg = part_idx[i];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d2[(size_t)s * M + i];
    if (d < best) {
      best = d;
      arg = part_idx[(size_t)s * M + i];
    }
  }
  out_idx[i] = arg;
  out_d2[i] = best;
}

}  // namespace

extern "C" int knn_launch(const float* q, const float* q2, const float* t_t,
                          const float* t2, float* part_d2, int* part_idx,
                          int* out_idx, float* out_d2, int M, int N, int splits,
                          int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (M + kThreads - 1) / kThreads;
  knn_partial<<<dim3(q_blocks, splits), kThreads, 0, st>>>(
      q, q2, t_t, t2, part_d2, part_idx, M, N, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge<<<q_blocks, kThreads, 0, st>>>(part_d2, part_idx, out_idx, out_d2,
                                           M, splits);
  return (int)cudaGetLastError();
}

extern "C" int knn_tile_size() { return kTile; }
extern "C" int knn_block_size() { return kThreads; }
