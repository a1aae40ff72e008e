// Fused Generalized-ICP Gauss-Newton build for Hopper (sm_90a).
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_gicp.py::gicp_normal_eq
// (body _gicp_tile).  It computes the same function: for every source point,
// the exact difference-form float32 nearest valid target (lowest index on
// ties), and for the inliers (d2 <= r2, valid source) the whitened GICP rows
// B = L^-1 [J | r] with C_t + R C_s R^T + 1e-6 I = L L^T, J = [-hat(p) | I],
// r = p - q_target; summed into the 7x7 Gram [JtJ | Jtr; Jtr^T | rMr] plus
// the inlier count and the inlier d2 sum, in the (B, 8, 128) layout that
// pallas_icp.unpack reads.
//
// What bounds it on this card: operations in the nearest-neighbour sweep,
// M x N pairs of 8 float32 operations that may not fuse (16384 x 16384 in
// odometry, 4096 x 65536 in scan-to-map), and, at B = 1 with a sweep the
// skip leaves small, the fixed cost of each launch.  The per-inlier GICP
// rows are O(M).
//
// What the design does about it, in two launches:
//   1. nn::nn_sweep (csrc/nn_sweep.cuh, shared with K4): targets in Morton
//      order with per-tile boxes, queries in groups of 64 that skip every
//      tile farther than r from their box (the exact AABB skip of the TPU
//      kernel, at a granularity that hash or packed-voxel order could not
//      make tight), tiles staged through a cp.async ring, two queries per
//      lane, the tie rule kept out of grid order;
//   2. gicp_rows: one thread per query, in original query order, takes the
//      winner's key that the splits merged into (and resets it) and reads
//      the winner's 9 target values directly (the TPU kernel needs a
//      one-hot MXU product for this); the Cholesky, the
//      forward substitution and the 28 upper-triangle Gram entries are
//      computed in registers; blocks reduce in a fixed tree and the last
//      block of each batch element (an integer ticket) sums the block
//      partials in block order.  No float atomics: results are
//      bit-reproducible run to run.
// The squared distance is rounded term by term (__fmul_rn/__fadd_rn, in the
// JAX operand order) so that an inlier decision never flips against the
// plain PyTorch version; the file is built with -fmad=false so the per-row
// algebra rounds like PyTorch's separate elementwise operations.
#include "nn_sweep.cuh"

namespace {

using nn::kNStats;
using nn::kRowThreads;
constexpr float kDiagEps = 1e-6f;
constexpr float kSqrtTiny = 1e-12f;

// grid (q_blocks, B); block kRowThreads.
__global__ void gicp_rows(const float* __restrict__ q_pts,
                          const float* __restrict__ q_mask, int mask_batched,
                          const float* __restrict__ q_cov6,
                          const float* __restrict__ td, int target_batched,
                          const float* __restrict__ r2p,
                          unsigned long long* __restrict__ keys,
                          float* __restrict__ block_part,
                          unsigned* __restrict__ tickets,
                          float* __restrict__ out,
                          int M, int N) {
  __shared__ float red[kNStats][kRowThreads];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kRowThreads + tid;
  float v[kNStats];
  for (int k = 0; k < kNStats; ++k) v[k] = 0.f;

  const float* qm = q_mask + (mask_batched ? (size_t)b * M : 0);
  if (i < M && qm[i] > 0.f) {
    float best;
    int arg;
    if (!nn::take_winner(keys, b, M, i, best, arg)) {
      v[28] = best;   // NaN: the query order left this valid query out
    } else if (best <= *r2p) {
      const float* tdb = td + (target_batched ? (size_t)b * 9 * N : 0);
      float S[9];
      for (int c = 0; c < 9; ++c) S[c] = tdb[(size_t)c * N + arg];
      const float* qp = q_pts + ((size_t)b * M + i) * 3;
      const float* qc = q_cov6 + ((size_t)b * M + i) * 6;
      const float p0 = qp[0], p1 = qp[1], p2 = qp[2];
      const float a00 = S[3] + qc[0] + kDiagEps;
      const float a01 = S[4] + qc[1];
      const float a02 = S[5] + qc[2];
      const float a11 = S[6] + qc[3] + kDiagEps;
      const float a12 = S[7] + qc[4];
      const float a22 = S[8] + qc[5] + kDiagEps;
      const float l00 = sqrtf(fmaxf(a00, kSqrtTiny));
      const float inv_l00 = 1.0f / l00;
      const float l10 = a01 * inv_l00;
      const float l20 = a02 * inv_l00;
      const float l11 = sqrtf(fmaxf(a11 - l10 * l10, kSqrtTiny));
      const float inv_l11 = 1.0f / l11;
      const float l21 = (a12 - l20 * l10) * inv_l11;
      const float l22 = sqrtf(fmaxf(a22 - l20 * l20 - l21 * l21, kSqrtTiny));
      const float inv_l22 = 1.0f / l22;
      const float r0 = p0 - S[0], r1 = p1 - S[1], r2v = p2 - S[2];
      const float x0[7] = {0.f, p2, -p1, 1.f, 0.f, 0.f, r0};
      const float x1[7] = {-p2, 0.f, p0, 0.f, 1.f, 0.f, r1};
      const float x2[7] = {p1, -p0, 0.f, 0.f, 0.f, 1.f, r2v};
      float y0[7], y1[7], y2[7];
      for (int c = 0; c < 7; ++c) {
        y0[c] = x0[c] * inv_l00;
        y1[c] = (x1[c] - l10 * y0[c]) * inv_l11;
        y2[c] = (x2[c] - l20 * y0[c] - l21 * y1[c]) * inv_l22;
      }
      int k = 0;
      for (int r = 0; r < 7; ++r)
        for (int c = r; c < 7; ++c)
          v[k++] = y0[r] * y0[c] + y1[r] * y1[c] + y2[r] * y2[c];
      v[28] = 1.f;
      v[29] = best;
    }
  }
  nn::reduce_and_finish(v, red, block_part, tickets, out, b);
}

}  // namespace

extern "C" int gicp_normal_eq_launch(
    const float* q_pts, const float* q_mask, int mask_batched,
    const int* q_order, int order_batched,
    const float* t_pts4, const float* t_boxes, int n_tiles,
    const float* q_cov6, const float* td, int target_batched, const float* r2,
    unsigned long long* keys, float* block_part, unsigned* tickets,
    float* out, int B, int M, int N, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nn::SweepArgs a{q_pts, q_mask, q_order,
                  reinterpret_cast<const float4*>(t_pts4),
                  reinterpret_cast<const float4*>(t_boxes), r2,
                  keys, mask_batched, order_batched,
                  target_batched, M, n_tiles};
  int err = nn::launch_sweep(a, B, splits, st);
  if (err != 0) return err;
  const int q_blocks = (M + kRowThreads - 1) / kRowThreads;
  gicp_rows<<<dim3(q_blocks, B), kRowThreads, 0, st>>>(
      q_pts, q_mask, mask_batched, q_cov6, td, target_batched, r2,
      keys, block_part, tickets, out, M, N);
  return (int)cudaGetLastError();
}

extern "C" int gicp_tile_size() { return nn::kTile; }
extern "C" int gicp_group_size() { return nn::kGroup; }
extern "C" int gicp_block_size() { return kRowThreads; }
