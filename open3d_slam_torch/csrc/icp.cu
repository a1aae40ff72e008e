// Fused point-to-plane ICP Gauss-Newton build for Hopper (sm_90a).
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_icp.py::p2l_normal_eq
// (body _p2l_tile).  It computes the same function: for every source point p
// of every batch element, the exact difference-form float32 nearest valid
// target (d2 = (dx*dx + dy*dy) + dz*dz, lowest index on ties), that target's
// normal n and plane offset c = n . q_t, the inlier weight
// w = (d2 <= r2) & valid source, and the rows G = [p x n, n, n . p - c] * w,
// summed into the 7x7 Gram [JtJ | Jtr; Jtr^T | r^T r] plus the inlier count
// and the inlier d2 sum, in the (B, 8, 128) layout that pallas_icp.unpack
// reads.  The target arrays are shared by the whole batch (2-D: multi-start
// localization, many hypotheses against one map) or given per batch element
// (3-D).
//
// What bounds it on this card: operations in the nearest-neighbour sweep,
// B x M x N pairs of 8 float32 operations that may not fuse (1024 x 2048 x
// 32768 at the rank stage of global localization), and at B = 1 the fixed
// cost of each launch.  The per-inlier rows are O(B x M).
//
// What the design does about it, in two launches:
//   1. nn::nn_sweep (csrc/nn_sweep.cuh, shared with K1): targets in Morton
//      order with per-tile boxes, queries in groups of 64 that skip every
//      tile farther than r from their box (exact: an inlier's target is
//      never skipped), tiles staged through a cp.async ring, two queries per
//      lane, the tie rule kept out of grid order;
//   2. p2l_rows: one thread per query, in original query order, takes the
//      winner's key that the splits merged into (and resets it), and reads
//      the winner's normal and c directly (the TPU kernel needs a one-hot
//      select for this); the 28 upper-triangle Gram entries, the count and
//      the d2 sum are reduced per block in a fixed tree, and the last block
//      of each batch element (an integer ticket) sums the block partials in
//      block order.  No float atomics: results are bit-reproducible run to
//      run.
// The squared distance is rounded term by term (__fmul_rn/__fadd_rn, in the
// JAX operand order) so that an inlier decision never flips against the
// plain PyTorch version; the file is built with -fmad=false so the per-row
// algebra rounds like PyTorch's separate elementwise operations.
#include "nn_sweep.cuh"

namespace {

using nn::kNStats;
using nn::kRowThreads;

// grid (q_blocks, B); block kRowThreads.
__global__ void p2l_rows(const float* __restrict__ q_pts,
                         const float* __restrict__ q_mask, int mask_batched,
                         const float* __restrict__ tn_t,
                         const float* __restrict__ tc, int target_batched,
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
  nn::reduce_and_finish(v, red, block_part, tickets, out, b);
}

}  // namespace

extern "C" int p2l_normal_eq_launch(
    const float* q_pts, const float* q_mask, int mask_batched,
    const int* q_order, int order_batched,
    const float* t_pts4, const float* t_boxes, int n_tiles,
    const float* tn_t, const float* tc, int target_batched, const float* r2,
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
  p2l_rows<<<dim3(q_blocks, B), kRowThreads, 0, st>>>(
      q_pts, q_mask, mask_batched, tn_t, tc, target_batched, r2,
      keys, block_part, tickets, out, M, N);
  return (int)cudaGetLastError();
}

extern "C" int p2l_tile_size() { return nn::kTile; }
extern "C" int p2l_group_size() { return nn::kGroup; }
extern "C" int p2l_block_size() { return kRowThreads; }
