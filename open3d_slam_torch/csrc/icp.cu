// Fused point-to-plane ICP Gauss-Newton build for Hopper (sm_90a).
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_icp.py::p2l_normal_eq
// (body _p2l_tile).  It computes the same function: for every source point p
// of every batch element, the exact difference-form float32 nearest valid
// target (d2 = (dx*dx + dy*dy) + dz*dz, invalid targets at 3e38, lowest index
// on ties), that target's normal n and plane offset c = n . q_t, the inlier
// weight w = (d2 <= r2) & valid source, and the rows
// G = [p x n, n, n . p - c] * w, summed into the 7x7 Gram [JtJ | Jtr;
// Jtr^T | r^T r] plus the inlier count and the inlier d2 sum, in the
// (B, 8, 128) layout that pallas_icp.unpack reads.  The target arrays are
// shared by the whole batch (2-D: multi-start localization, many hypotheses
// against one map) or given per batch element (3-D).
//
// What bounds it on this card: operations.  The nearest-neighbour sweep is
// B x M x N pairs of ~8 float32 operations (1024 x 2048 x 32768 at the rank
// stage of global localization: ~0.55 TFLOP), while the bytes moved are tens
// of MB.  The per-inlier rows are O(B x M) and cheap next to the sweep.
//
// What the design does about it (simple and right first):
//   * one thread per (batch element, source point) keeps its running
//     (min d2, argmin) in registers; target tiles of 256 points are staged
//     through shared memory as float4 (x, y, z, valid) and read as warp-wide
//     broadcasts (the layout of K1's csrc/gicp.cu);
//   * when B x M is small (B = 1 in tracking and in the final registration of
//     global localization) the target axis is split across blocks (grid.y)
//     so that the grid fills all SMs; each split writes its own (d2, index)
//     and the row kernel merges the splits in index order with a strict <,
//     so the result is the global first minimum, as jnp.argmin gives;
//   * the thread that holds the argmin reads the winner's normal and c
//     directly (the TPU kernel needs a one-hot select for this);
//   * the 28 upper-triangle Gram entries, the count and the d2 sum are
//     reduced per block in a fixed tree order and a third kernel sums the
//     block partials in block order.  No float atomics: results are
//     bit-reproducible run to run;
//   * the squared distance is rounded term by term (__fmul_rn/__fadd_rn, in
//     the JAX operand order) so that an inlier decision never flips against
//     the plain PyTorch version; the file is built with -fmad=false so the
//     per-row algebra rounds like PyTorch's separate elementwise operations.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // source points per block
constexpr int kTile = 256;      // target points per shared-memory tile
constexpr int kNStats = 30;     // 28 Gram entries + n_in + d2 sum
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz) {
  const float d0 = __fsub_rn(qx, tx);
  const float d1 = __fsub_rn(qy, ty);
  const float d2 = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// grid (q_blocks, splits, B); block kThreads.
__global__ void p2l_nn_partial(const float* __restrict__ q_pts,
                               const float* __restrict__ t_t,
                               const float* __restrict__ tv,
                               int target_batched,
                               float* __restrict__ part_d2,
                               int* __restrict__ part_idx,
                               int M, int N, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool active = i < M;
  const float* qp = q_pts + (size_t)b * M * 3;
  const float* ttb = t_t + (target_batched ? (size_t)b * 3 * N : 0);
  const float* tvb = tv + (target_batched ? (size_t)b * N : 0);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qp[(size_t)i * 3 + 0];
    qy = qp[(size_t)i * 3 + 1];
    qz = qp[(size_t)i * 3 + 2];
  }
  float best = kBig;
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
        v.x = ttb[j];
        v.y = ttb[(size_t)N + j];
        v.z = ttb[(size_t)2 * N + j];
        v.w = tvb[j];
      }
      tile[k] = v;
    }
    __syncthreads();
    const int cnt = min(kTile, N - base);
    for (int k = 0; k < cnt; ++k) {
      const float4 v = tile[k];
      const float d = sq_dist(qx, qy, qz, v.x, v.y, v.z);
      if (v.w > 0.f && d < best) {
        best = d;
        arg = base + k;
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t o = ((size_t)b * splits + split) * M + i;
    part_d2[o] = best;
    part_idx[o] = arg;
  }
}

// grid (q_blocks, B); block kThreads.
__global__ void p2l_rows(const float* __restrict__ q_pts,
                         const float* __restrict__ q_mask, int mask_batched,
                         const float* __restrict__ tn_t,
                         const float* __restrict__ tc, int target_batched,
                         const float* __restrict__ r2p,
                         const float* __restrict__ part_d2,
                         const int* __restrict__ part_idx,
                         float* __restrict__ block_part,
                         int M, int N, int splits) {
  __shared__ float red[kNStats][kThreads];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  float v[kNStats];
  for (int k = 0; k < kNStats; ++k) v[k] = 0.f;

  if (i < M) {
    float best = kBig;
    int arg = 0;
    for (int s = 0; s < splits; ++s) {
      const size_t o = ((size_t)b * splits + s) * M + i;
      const float d = part_d2[o];
      if (d < best) {
        best = d;
        arg = part_idx[o];
      }
    }
    const float* qm = q_mask + (mask_batched ? (size_t)b * M : 0);
    if (best <= *r2p && qm[i] > 0.f) {
      const float* tnb = tn_t + (target_batched ? (size_t)b * 3 * N : 0);
      const float* tcb = tc + (target_batched ? (size_t)b * N : 0);
      const float n0 = tnb[arg], n1 = tnb[(size_t)N + arg];
      const float n2 = tnb[(size_t)2 * N + arg], c = tcb[arg];
      const float* qp = q_pts + ((size_t)b * M + i) * 3;
      const float p0 = qp[0], p1 = qp[1], p2 = qp[2];
      const float g[7] = {p1 * n2 - p2 * n1, p2 * n0 - p0 * n2,
                          p0 * n1 - p1 * n0, n0, n1, n2,
                          p0 * n0 + p1 * n1 + p2 * n2 - c};
      int k = 0;
      for (int r = 0; r < 7; ++r)
        for (int col = r; col < 7; ++col) v[k++] = g[r] * g[col];
      v[28] = 1.f;
      v[29] = best;
    }
  }
  for (int k = 0; k < kNStats; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < kNStats; ++k) red[k][tid] += red[k][tid + s];
    __syncthreads();
  }
  if (tid < kNStats)
    block_part[((size_t)b * gridDim.x + blockIdx.x) * kNStats + tid] = red[tid][0];
}

// grid (B); block 32: entry k of 30 summed over blocks in block order.
__global__ void p2l_sum(const float* __restrict__ block_part,
                        float* __restrict__ out, int n_blocks) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= kNStats) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk)
    s += block_part[((size_t)b * n_blocks + blk) * kNStats + k];
  float* o = out + (size_t)b * 8 * 128;
  if (k < 28) {
    int r = 0, rem = k;
    while (rem >= 7 - r) { rem -= 7 - r; ++r; }
    const int c = r + rem;
    o[r * 128 + c] = s;
    o[c * 128 + r] = s;
  } else {
    o[7 * 128 + (k - 28)] = s;
  }
}

}  // namespace

extern "C" int p2l_normal_eq_launch(
    const float* q_pts, const float* q_mask, int mask_batched,
    const float* t_t, const float* tn_t, const float* tc, const float* tv,
    int target_batched, const float* r2,
    float* part_d2, int* part_idx, float* block_part, float* out,
    int B, int M, int N, int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (M + kThreads - 1) / kThreads;
  p2l_nn_partial<<<dim3(q_blocks, splits, B), kThreads, 0, st>>>(
      q_pts, t_t, tv, target_batched, part_d2, part_idx, M, N, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p2l_rows<<<dim3(q_blocks, B), kThreads, 0, st>>>(
      q_pts, q_mask, mask_batched, tn_t, tc, target_batched, r2,
      part_d2, part_idx, block_part, M, N, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p2l_sum<<<B, 32, 0, st>>>(block_part, out, q_blocks);
  return (int)cudaGetLastError();
}

extern "C" int p2l_tile_size() { return kTile; }
extern "C" int p2l_block_size() { return kThreads; }
