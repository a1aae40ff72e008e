// Nearest valid target in the expansion form, within a gate (kernel K3), for
// Hopper (sm_90a).  Built with -fmad=false.
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_knn.py::nn_argmin (body
// _nn_kernel).  It computes the same function: for every query q, over every
// valid target t, the running (min, argmin) of the expansion-form
//     e(q, t) = (|q|^2 + |t|^2) - 2 (q . t),
// |q|^2, |t|^2 and the dot each summed x, then y, then z, every operation
// rounded on its own (the plain version's elementwise order), ties to the
// lowest target index, and (+inf, 0) for a query with no valid target.
// |t|^2 is recomputed here from the staged coordinates, bit-equal to the
// callers' ops/cuda_knn.squared_norms.
//
// What bounds it: the pairs swept.  Against every pair, the loop-closure
// call is 32768 x 65536 pairs of 9 float32 operations (0.29 ms at 67
// TFLOP/s).  But every caller keeps the winner w only when its exact
// difference-form d2 lies within a gate r (ops/hashgrid.query_nearest), and
// its neighbours lie within a few tiles.  What the design does about it:
//   * layout (ops/nn_layout.py, once per target grid): the targets in Morton
//     order, 64 to a tile with a box each, staged as float4 (x, y, z, index
//     bits), invalid and padding targets at a sentinel whose e is +inf or
//     NaN; the queries in the Morton order of the untransformed source, 64
//     to a warp (2 per lane), so a group stays compact under any rigid
//     transform and one broadcast shared-memory read serves two pairs;
//   * exact skip: a warp skips every tile with  g2 - margin >= r2,  where g2
//     is the squared gap of its group's box and the tile's (nn::box_gap2)
//     and margin = 2^-19 (|q|^2_max + |t|^2_max + g2) over the two boxes
//     (nn::box_max_sq).  e differs from the exact d2 by at most ~7 ulps of
//     |q|^2 + |t|^2, the callers' d2 and the rounded g2 by a few ulps of
//     themselves; the margin is more than twice their sum.  So every target
//     s of a skipped tile has e(s) > e(v) for every valid v whose exact d2
//     is within r.  Why that is exact: take w, the argmin over all targets.
//     If some valid v lies within r, e(w) <= e(v) < e(s) for every skipped
//     s, so w lies in a kept tile and wins over the kept tiles: the same
//     index and e, and the gate's verdict on w.  If no valid target lies
//     within r, the full sweep's w fails the gate, and so does whatever the
//     kept tiles give.  So the callers' "found", and the index wherever it
//     holds, are those of the full sweep.  With r = +inf nothing is skipped;
//   * splits: the tiles of a group are dealt round-robin to several warps
//     (ops/nn_layout.plan_splits).  Targets are visited out of index order,
//     so a running best is replaced when e is lower, or equal with a lower
//     index: the lexicographic minimum of (e, index), whatever the order;
//   * merge: a split publishes a query's best as one 64-bit integer
//     atomicMin of the key (order(e), index) into ops/nn_layout.scratch's
//     keys, where order() maps a float's bits to an unsigned integer in the
//     floats' order.  Two traps that K1/K4's key (d2 >= 0) never met: e goes
//     below zero by rounding when a query lies within millimetres of a
//     target at sensor range, so a negative e gets every bit flipped and a
//     non-negative one its sign bit set; -0.0 is made +0.0 first (e cannot
//     be -0.0, but torch.argmin takes the two as equal, and so must the
//     key).  A running best is never NaN (a sentinel's e is +inf or NaN and
//     never compares below it), so no NaN key falls below that of +inf;
//   * a split publishes only a best e <= r2 + 2^-19 (|q|^2 + r2), a bound
//     that every valid target within r meets, and with r = +inf only a
//     finite one; knn_decode writes (index, e) for every query, (0, +inf)
//     where nothing was published, and resets the keys to all ones: two
//     launches per call, no per-call scratch, no float atomics.
#include "nn_sweep.cuh"

namespace {

using nn::kGroup;
using nn::kList;
using nn::kPerLane;
using nn::kTile;

constexpr int kWarps = 4;            // query groups per sweep block
constexpr int kDecodeThreads = 128;
constexpr float kBig = nn::kBig;
constexpr float kInf = __builtin_huge_valf();
constexpr float kMaxFinite = 3.4028234663852886e38f;
constexpr unsigned long long kNone = ~0ull;

struct KnnArgs {
  const float* q_pts;            // (B, M, 3)
  const unsigned char* q_mask;   // (M,) or (B, M) bool; null: every query valid
  const int* q_order;            // (M,) or (B, M): queries in Morton order
  const float4* t_pts;           // (n_tiles * kTile) float4 (x, y, z, index bits)
  const float4* t_boxes;         // (n_tiles, 2) float4: min xyz, max xyz, 0, 0
  unsigned long long* keys;      // (B, M): min (order(e), index), all ones = none
  float r2;                      // the gate squared; +inf: none, nothing skipped
  int mask_batched, order_batched;
  int M, n_tiles;
};

// The merge key of (e, index): e's bits mapped to an unsigned integer in the
// floats' order, above the index.
__device__ __forceinline__ unsigned long long order_key(float e, int idx) {
  const unsigned u = __float_as_uint(__fadd_rn(e, 0.f));   // -0.0 -> +0.0
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)k << 32) | (unsigned)idx;
}

// grid (ceil(groups / kWarps), splits, B); block 32 * kWarps.  Warps work
// alone: no block-wide barrier.
__global__ void __launch_bounds__(32 * kWarps) knn_sweep(const KnnArgs a) {
  __shared__ __align__(16) float4 ring[kWarps][nn::kStages * kTile];
  __shared__ int needed[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + warp;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  if (group * kGroup >= a.M) return;

  const float* qp = a.q_pts + (size_t)b * a.M * 3;
  const unsigned char* qm =
      a.q_mask ? a.q_mask + (a.mask_batched ? (size_t)b * a.M : 0) : nullptr;
  const int* qo = a.q_order + (a.order_batched ? (size_t)b * a.M : 0);

  float qx[kPerLane], qy[kPerLane], qz[kPerLane], q2[kPerLane], best[kPerLane];
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
      qv[r] = qm == nullptr || qm[qi[r]] != 0;
      if (qv[r]) {
        lo[0] = fminf(lo[0], qx[r]); hi[0] = fmaxf(hi[0], qx[r]);
        lo[1] = fminf(lo[1], qy[r]); hi[1] = fmaxf(hi[1], qy[r]);
        lo[2] = fminf(lo[2], qz[r]); hi[2] = fmaxf(hi[2], qz[r]);
      }
    }
    q2[r] = nn::sq_norm(qx[r], qy[r], qz[r]);
    best[r] = kInf;
    arg[r] = 0;
  }
  // A group with no valid query publishes nothing.
  if (!__any_sync(0xffffffffu, qv[0] || qv[1])) return;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], s));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], s));
    }
  }
  const float r2 = a.r2;
  const bool gated = r2 <= kMaxFinite;
  const float gq2 = nn::box_max_sq(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
  // Kept: g2 - margin < r2 (an empty or all-invalid tile's gap is +inf and
  // its margin +inf, so the difference is NaN and the tile is skipped).
  auto keep = [&](float4 b0, float4 b1) {
    if (!gated) return true;
    const float g2 = nn::box_gap2(b0, b1, lo, hi);
    const float t2 = nn::box_max_sq(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y);
    const float margin = __fmul_rn(0x1p-19f, __fadd_rn(__fadd_rn(gq2, t2), g2));
    return __fsub_rn(g2, margin) < r2;
  };
  auto visit = [&](const float4* tile) {
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 v = tile[j];
      const int idx = __float_as_int(v.w);
      const float t2 = nn::sq_norm(v.x, v.y, v.z);   // +inf at the sentinel
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx[r], v.x), __fmul_rn(qy[r], v.y)),
                                    __fmul_rn(qz[r], v.z));
        const float e = __fsub_rn(__fadd_rn(q2[r], t2), __fmul_rn(2.f, dot));
        if (e <= best[r]) {
          const bool take = e < best[r] || idx < arg[r];
          best[r] = take ? e : best[r];
          arg[r] = take ? idx : arg[r];
        }
      }
    }
  };
  int cand = split;   // this split's tiles: split, split + splits, ...
  while (cand < a.n_tiles) {
    const int count = nn::list_tiles(a.t_boxes, a.n_tiles, cand, splits, lane, needed[warp],
                                     keep);
    nn::sweep_tiles(a.t_pts, needed[warp], count, ring[warp], lane, visit);
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (!qv[r]) continue;
    const float limit =
        gated ? __fadd_rn(r2, __fmul_rn(0x1p-19f, __fadd_rn(q2[r], r2))) : kMaxFinite;
    if (best[r] <= limit)
      atomicMin(a.keys + (size_t)b * a.M + qi[r], order_key(best[r], arg[r]));
  }
}

// grid ceil(B * M / kDecodeThreads): each query's (index, e) from its key,
// (0, +inf) where none was published; the key is reset to all ones.
__global__ void knn_decode(unsigned long long* __restrict__ keys, int* __restrict__ out_idx,
                           float* __restrict__ out_e, int total) {
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  int idx = 0;
  float e = kInf;
  if (key != kNone) {
    keys[i] = kNone;
    const unsigned k = (unsigned)(key >> 32);
    e = __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
    idx = (int)(unsigned)(key & 0xffffffffull);
  }
  out_idx[i] = idx;
  out_e[i] = e;
}

}  // namespace

// The sweep and the decode on the stream; returns the CUDA error code.
// ``keys`` must hold all ones for B * M queries (the decode leaves it so).
extern "C" int knn_launch(const float* q_pts, const unsigned char* q_mask, int mask_batched,
                          const int* q_order, int order_batched, const void* t_pts,
                          const void* t_boxes, int n_tiles, float r2,
                          unsigned long long* keys, int* out_idx, float* out_e, int B,
                          int M, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  KnnArgs a;
  a.q_pts = q_pts;
  a.q_mask = q_mask;
  a.q_order = q_order;
  a.t_pts = static_cast<const float4*>(t_pts);
  a.t_boxes = static_cast<const float4*>(t_boxes);
  a.keys = keys;
  a.r2 = r2;
  a.mask_batched = mask_batched;
  a.order_batched = order_batched;
  a.M = M;
  a.n_tiles = n_tiles;
  const int groups = (M + kGroup - 1) / kGroup;
  const int blocks = (groups + kWarps - 1) / kWarps;
  knn_sweep<<<dim3(blocks, splits, B), 32 * kWarps, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * M;
  knn_decode<<<(total + kDecodeThreads - 1) / kDecodeThreads, kDecodeThreads, 0, st>>>(
      keys, out_idx, out_e, total);
  return (int)cudaGetLastError();
}

extern "C" int knn_tile_size() { return kTile; }
extern "C" int knn_group_size() { return kGroup; }
