// The exact nearest-neighbour sweep shared by kernels K1 (csrc/gicp.cu) and
// K4 (csrc/icp.cu), and the block reduction that ends both of their row
// kernels.  Built for Hopper (sm_90a) with -fmad=false.
//
// What it computes: for every query q of every batch element, the valid
// target t with the smallest float32 d2 = (dx*dx + dy*dy) + dz*dz (rounded
// term by term, in the TPU kernels' operand order), the lowest target index
// on ties, for every query whose nearest target lies within r.  A query with
// none within r gets some (d2 > r2, index) or (3e38, 0): the callers count
// and sum only queries with d2 <= r2, so their output is exactly that of a
// sweep over every pair.
//
// What bounds it: operations, and the pairs swept.  A pair costs 8 float32
// operations that may not fuse (the inlier test must round like the plain
// version), and a full sweep at the rank stage of global localization is
// 1024 x 2048 x 32768 pairs.  What the design does about it:
//   * layout (ops/nn_layout.py, once per target or registration call): the
//     targets in Morton order, each staged as one float4 (x, y, z, grid index
//     as int bits), invalid and padding targets at a sentinel whose d2
//     overflows to +inf, so the inner loop has no validity test; a box per
//     64-target tile; the queries in the Morton order of the untransformed
//     source, so a group of 64 consecutive queries stays compact under any
//     rigid transform;
//   * exact skip: each warp takes one group of 64 queries (2 per lane, so one
//     broadcast shared-memory read serves two pairs), builds the box of its
//     valid queries, and sweeps only the tiles whose box lies within r of it.
//     The box gap is rounded like the distance, so a skipped tile cannot
//     hold a target within r;
//   * staging: the needed tiles are listed first (a ballot over 32 tiles at a
//     time), then copied into a 3-stage shared-memory ring with cp.async, so
//     the next tiles' loads overlap the current sweep;
//   * order: targets are visited out of grid order, so a running best is
//     replaced on d <= best when d < best or the index is lower: the result
//     is the lexicographic minimum of (d2, index), whatever the order;
//   * splits: when there are too few groups to fill the card, the tiles are
//     dealt round-robin to several splits (so the skip leaves each split its
//     share, and a dense group's work spreads over many warps).  A split
//     publishes a query's (d2, index) as one integer atomicMin of the 64-bit
//     key (d2 bits, index) at the query's original index: for d2 >= 0 that
//     is the lexicographic minimum, in any order, so any number of splits
//     merges exactly, with no float atomics and no per-split buffers.  Split
//     0 publishes every valid query it was given, the others only where
//     d2 <= r2.  The row kernel reads each key and resets it, so the buffer
//     is all ones between calls;
//   * the query order is an input: an entry outside [0, M) is skipped, and
//     a valid query that no entry names keeps an all-ones key, which the
//     row kernel turns into a NaN inlier count rather than a silent
//     outlier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nn {
namespace {

constexpr int kTile = 64;            // targets per tile (ops/nn_layout.TILE)
constexpr int kPerLane = 2;          // queries per lane
constexpr int kGroup = 32 * kPerLane;  // queries per warp (ops/nn_layout.GROUP)
constexpr int kWarps = 4;            // groups per sweep block
constexpr int kStages = 3;           // tiles in flight per warp
constexpr int kList = 128;           // needed tiles listed per pass
constexpr int kRowThreads = 128;     // queries per row block
constexpr int kNStats = 30;          // 28 Gram entries + n_in + d2 sum
constexpr float kBig = 3.0e38f;

struct SweepArgs {
  const float* q_pts;      // (B, M, 3)
  const float* q_mask;     // (M,) or (B, M)
  const int* q_order;      // (M,) or (B, M): queries in Morton order
  const float4* t_pts;     // ([B,] n_tiles * kTile) float4 (x, y, z, index bits)
  const float4* t_boxes;   // ([B,] n_tiles, 2) float4: min xyz, max xyz, 0, 0
  const float* r2;         // (1,)
  unsigned long long* keys;  // (B, M): min (d2 bits, index), all ones = none
  int mask_batched, order_batched, target_batched;
  int M, n_tiles;
};

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz) {
  const float d0 = __fsub_rn(qx, tx);
  const float d1 = __fsub_rn(qy, ty);
  const float d2 = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// Squared gap between two boxes, each axis max(lo_t - hi_q, lo_q - hi_t, 0),
// summed like sq_dist: never more than the d2 of any pair inside them.
__device__ __forceinline__ float box_gap2(float4 b0, float4 b1, const float* lo,
                                          const float* hi) {
  const float tlo[3] = {b0.x, b0.y, b0.z};
  const float thi[3] = {b0.w, b1.x, b1.y};
  float g2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = fmaxf(fmaxf(__fsub_rn(tlo[a], hi[a]), __fsub_rn(lo[a], thi[a])), 0.f);
    g2 = __fadd_rn(g2, __fmul_rn(g, g));
  }
  return g2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_tile(float4* dst, const float4* src, int lane) {
#pragma unroll
  for (int k = lane; k < kTile; k += 32) cp_async16(dst + k, src + k);
}

// grid (ceil(groups / kWarps), splits, B); block 32 * kWarps.  Warps work
// alone: no block-wide barrier.
__global__ void __launch_bounds__(32 * kWarps) nn_sweep(const SweepArgs a) {
  __shared__ __align__(16) float4 ring[kWarps][kStages * kTile];
  __shared__ int needed[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + warp;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  if (group * kGroup >= a.M) return;

  const float* qp = a.q_pts + (size_t)b * a.M * 3;
  const float* qm = a.q_mask + (a.mask_batched ? (size_t)b * a.M : 0);
  const int* qo = a.q_order + (a.order_batched ? (size_t)b * a.M : 0);
  const size_t t_off = a.target_batched ? (size_t)b * a.n_tiles : 0;
  const float4* tp = a.t_pts + t_off * kTile;
  const float4* tb = a.t_boxes + t_off * 2;

  float qx[kPerLane], qy[kPerLane], qz[kPerLane], best[kPerLane];
  int qi[kPerLane], arg[kPerLane];
  bool qv[kPerLane];
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int slot = group * kGroup + r * 32 + lane;
    qi[r] = slot < a.M ? qo[slot] : -1;
    qx[r] = qy[r] = qz[r] = 0.f;
    qv[r] = false;
    if (qi[r] >= 0 && qi[r] < a.M) {
      qx[r] = qp[(size_t)qi[r] * 3 + 0];
      qy[r] = qp[(size_t)qi[r] * 3 + 1];
      qz[r] = qp[(size_t)qi[r] * 3 + 2];
      qv[r] = qm[qi[r]] > 0.f;
      if (qv[r]) {
        lo[0] = fminf(lo[0], qx[r]); hi[0] = fmaxf(hi[0], qx[r]);
        lo[1] = fminf(lo[1], qy[r]); hi[1] = fmaxf(hi[1], qy[r]);
        lo[2] = fminf(lo[2], qz[r]); hi[2] = fmaxf(hi[2], qz[r]);
      }
    }
    best[r] = kBig;
    arg[r] = 0;
  }
  // The box of the group's valid queries; with none it is empty (lo = +BIG,
  // hi = -BIG) and every gap is +inf.
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], s));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], s));
    }
  }
  const float r2 = *a.r2;
  float4* my_ring = ring[warp];
  int* my_list = needed[warp];
  const unsigned below = (1u << lane) - 1u;

  int cand = split;   // this split's tiles: split, split + splits, ...
  while (cand < a.n_tiles) {
    // List the needed tiles, 32 candidates at a time.
    int count = 0;
    while (cand < a.n_tiles && count <= kList - 32) {
      const int t = cand + lane * splits;
      bool need = false;
      if (t < a.n_tiles) need = box_gap2(tb[2 * t], tb[2 * t + 1], lo, hi) <= r2;
      const unsigned m = __ballot_sync(0xffffffffu, need);
      if (need) my_list[count + __popc(m & below)] = t;
      count += __popc(m);
      cand += 32 * splits;
    }
    __syncwarp();
    // Sweep them through the ring: tile k + kStages - 1 loads while k is swept.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < count) load_tile(my_ring + s * kTile, tp + (size_t)my_list[s] * kTile, lane);
      cp_async_commit();
    }
    for (int k = 0; k < count; ++k) {
      const int nxt = k + kStages - 1;
      if (nxt < count)
        load_tile(my_ring + (nxt % kStages) * kTile, tp + (size_t)my_list[nxt] * kTile, lane);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const float4* tile = my_ring + (k % kStages) * kTile;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float4 v = tile[j];
        const int idx = __float_as_int(v.w);
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
          const float d = sq_dist(qx[r], qy[r], qz[r], v.x, v.y, v.z);
          if (d <= best[r]) {
            const bool take = d < best[r] || idx < arg[r];
            best[r] = take ? d : best[r];
            arg[r] = take ? idx : arg[r];
          }
        }
      }
      __syncwarp();
    }
    cp_async_wait<0>();
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (qv[r] && (split == 0 || best[r] <= r2)) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(best[r]) << 32) | (unsigned)arg[r];
      atomicMin(a.keys + (size_t)b * a.M + qi[r], key);
    }
  }
}

// The winner (d2, index) of valid query i of batch element b over all
// splits (d2 > r2 when none lay within r), and its key reset for the next
// call; false, with d2 = NaN, when no split published one: the query order
// left i out.
__device__ __forceinline__ bool take_winner(unsigned long long* keys, int b, int M, int i,
                                            float& best, int& arg) {
  unsigned long long* k = keys + (size_t)b * M + i;
  const unsigned long long key = *k;
  best = __int_as_float(0x7fffffff);
  arg = 0;
  if (key == ~0ull) return false;
  *k = ~0ull;
  best = __uint_as_float((unsigned)(key >> 32));
  arg = (int)(unsigned)(key & 0xffffffffull);
  return true;
}

// Ends a row kernel (grid (q_blocks, B), block kRowThreads): sums v over the
// block in a fixed tree (red[k][t] += red[k][t + s], s = 64 ... 1) into its
// partial; the last block of batch element b to finish (an integer ticket)
// sums the partials in block order from 0 and writes the whole (8, 128)
// output of b: the 7x7 Gram in rows 0..6, (n_in, d2 sum) in row 7, zeros
// elsewhere.  It resets the ticket, so the buffer is zero between calls.
__device__ void reduce_and_finish(float (&v)[kNStats],
                                  float (*red)[kRowThreads],
                                  float* __restrict__ block_part,
                                  unsigned* __restrict__ tickets,
                                  float* __restrict__ out, int b) {
  __shared__ bool last;
  __shared__ float sums[kNStats];
  const int tid = threadIdx.x;
  const int n_blocks = gridDim.x;
  for (int k = 0; k < kNStats; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int s = kRowThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < kNStats; ++k) red[k][tid] += red[k][tid + s];
    __syncthreads();
  }
  float* part = block_part + (size_t)b * n_blocks * kNStats;
  if (tid < kNStats) part[(size_t)blockIdx.x * kNStats + tid] = red[tid][0];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b], 1u) == (unsigned)(n_blocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread j stages block j's partial as row j of red (read as [kRowThreads]
  // [kNStats]): its 30 loads are independent and in flight together, and
  // thread k then walks column k, one bank per thread.
  float* rows = &red[0][0];
  float s = 0.f;
  for (int c0 = 0; c0 < n_blocks; c0 += kRowThreads) {
    const int cnt = min(kRowThreads, n_blocks - c0);
    if (tid < cnt) {
      const float* src = part + (size_t)(c0 + tid) * kNStats;
      float t[kNStats];
#pragma unroll
      for (int k = 0; k < kNStats; ++k) t[k] = __ldcg(src + k);
#pragma unroll
      for (int k = 0; k < kNStats; ++k) rows[tid * kNStats + k] = t[k];
    }
    __syncthreads();
    if (tid < kNStats) {
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) s += rows[j * kNStats + tid];
    }
    __syncthreads();
  }
  if (tid < kNStats) sums[tid] = s;
  __syncthreads();
  float* o = out + (size_t)b * 8 * 128;
  for (int e = tid; e < 8 * 128; e += kRowThreads) {
    const int r = e / 128, c = e % 128;
    float val = 0.f;
    if (r < 7 && c < 7) {
      const int lo_ = min(r, c), hi_ = max(r, c);
      val = sums[lo_ * 7 - lo_ * (lo_ - 1) / 2 + (hi_ - lo_)];
    } else if (r == 7 && c < 2) {
      val = sums[28 + c];
    }
    o[e] = val;
  }
  if (tid == 0) tickets[b] = 0u;
}

// One sweep launch on the stream; returns the CUDA error code.  ``keys``
// must hold all ones for every valid query (take_winner leaves it so).
inline int launch_sweep(const SweepArgs& a, int B, int splits, cudaStream_t st) {
  const int groups = (a.M + kGroup - 1) / kGroup;
  const int blocks = (groups + kWarps - 1) / kWarps;
  nn_sweep<<<dim3(blocks, splits, B), 32 * kWarps, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace nn
