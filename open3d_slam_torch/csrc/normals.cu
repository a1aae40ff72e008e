// Hybrid-radius normal estimation (kernel K2) for Hopper (sm_90a): the
// k-th-neighbour prepass and the radius-neighbourhood PCA moments.  Built
// with -fmad=false.
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_normals.py::
// radius_moments_at (body _moments_kernel) and its XLA prepass
// kth_neighbor_d2_at.  Together they compute, for each query q of a support
// cloud, Open3D's KDTreeSearchParamHybrid neighbourhood: d_k, the distance
// to the k-th nearest valid support point, gives q its own radius
// min(r, d_k) (inflated by 1 + 1e-5 in ops/cuda_normals.hybrid_radius), and
// the moments are the sums of F = [1, x, y, z, xx, xy, xz, yy, yz, zz] over
// the valid support points with |q - p|^2 <= r_q^2.
//
//   kth_sweep: per query, the k-th smallest of the JAX package's
//   expansion-form d2 = (|q|^2 + |t|^2) - 2 q.t over the valid support, on
//   the coordinates as given, clamped to [0, r^2].  |q|^2 and |t|^2 are
//   summed x, y, z; the dot is the FMA chain fma(z, fma(y, x*x')) that a
//   float32 matrix product computes, so the plain version (ops/
//   cuda_normals.py, a torch matmul) gives the same value.
//   moments_sweep: per query, the sums of F in the difference form
//   d2 = (dx*dx + dy*dy) + dz*dz (nn::sq_dist) on coordinates centred on the
//   support centroid, which the kernel subtracts with one rounding as the
//   plain version's ``points - centroid`` does.  Output (M, 16), columns
//   10..15 zero.
//
// What bounds them: the pairs swept.  Against every pair, the odometry's
// 16384 x 16384 cloud is 268M distances; the neighbourhoods are ~20 points.
// What the design does about it:
//   * layout (ops/cuda_normals.normals_layout, once per normals call, read by
//     both kernels): the support in Morton order in 64-point tiles with a
//     box each, invalid and padding points at a sentinel whose d2 is +inf or
//     NaN (so the inner loops test no validity), and the queries in Morton
//     order, 64 to a warp (2 per lane);
//   * exact skip: a warp builds the box of its 64 queries and skips every
//     tile whose box gap (nn::box_gap2, never more than the d2 of a pair in
//     the two boxes but for rounding) cannot matter.  The moments need a tile
//     only if its gap is within the group's largest r_q^2 (boxes centred
//     like the points: rounding is monotonic, so a centred box still bounds
//     its centred points).  The prepass's value is capped at r^2 and only
//     falls as points are taken in, so a tile whose gap, less a bound on the
//     expansion form's rounding (2^-19 (|q|^2 + |t|^2 + gap), some four
//     times the worst case), is at least the group's largest running k-th
//     value holds no point that could enter any of the group's k-lists;
//   * the prepass first sweeps the tiles that overlap the group's box (for a
//     cloud against itself every query finds k candidates among the
//     group's own points), then lists the others 128 at a time against the
//     threshold as it stands, so it sweeps the few tiles within ~d_k instead
//     of every tile within r;
//   * splits: a group near the sensor meets many tiles, and a 16384-point
//     cloud is only 256 groups, so each group's tiles are dealt round-robin
//     to several warps (ops/cuda_normals.plan_splits).  The moments' splits
//     write partial sums that moments_reduce adds in split order.  Every
//     prepass split sweeps the overlapping tiles for its threshold t0, but
//     only split 0 keeps their points (the others start their lists anew):
//     split 0's list then holds k values <= t0, so a point at or above t0,
//     skipped by any split, cannot change the k-th value of the union of the
//     splits' lists, which kth_merge takes;
//   * the k-list of each query lives in registers, sorted, in KCAP slots
//     (KCAP - k of them -inf, so slot KCAP - 1 is the k-th value), and a
//     point below min(t0, k-th value) enters with one unrolled min/max
//     pass; KCAP is 8, 16 or 32;
//   * the k-th smallest of a multiset does not depend on the order it is
//     visited in, so the prepass is bit-equal to its plain version.  The
//     moments add in tile-list order, with the features as single rounded
//     products of the centred coordinates (equal to the plain version's F),
//     no float atomics: reproducible run to run;
//   * tiles are staged through a 3-stage cp.async ring per warp (nn_sweep's
//     helpers), so the next tiles' loads overlap the current sweep.
#include "nn_sweep.cuh"

namespace {

using nn::kGroup;
using nn::kList;
using nn::kPerLane;
using nn::kStages;
using nn::kTile;

constexpr int kWarps = 4;    // query groups per block
constexpr int kMaxK = 32;    // the largest k-list
constexpr int kFeat = 10;
constexpr int kOut = 16;
constexpr int kMergeThreads = 128;   // queries per merge or reduce block
constexpr float kBig = nn::kBig;
constexpr float kInf = __builtin_huge_valf();

// A warp's query group: each lane's queries (qi = -1 past M or for an order
// entry outside [0, M)) less the centre c, and the box of the group's queries.
struct Group {
  float x[kPerLane], y[kPerLane], z[kPerLane];
  int qi[kPerLane];
  float lo[3], hi[3];
};

__device__ __forceinline__ void load_group(const float* __restrict__ q,
                                           const int* __restrict__ order, int M,
                                           int group, int lane, const float* c, Group& g) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = kBig;
    g.hi[a] = -kBig;
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int slot = group * kGroup + r * 32 + lane;
    int i = slot < M ? order[slot] : -1;
    if (i < 0 || i >= M) i = -1;
    g.qi[r] = i;
    g.x[r] = g.y[r] = g.z[r] = 0.f;
    if (i >= 0) {
      g.x[r] = __fsub_rn(q[(size_t)i * 3 + 0], c[0]);
      g.y[r] = __fsub_rn(q[(size_t)i * 3 + 1], c[1]);
      g.z[r] = __fsub_rn(q[(size_t)i * 3 + 2], c[2]);
      g.lo[0] = fminf(g.lo[0], g.x[r]); g.hi[0] = fmaxf(g.hi[0], g.x[r]);
      g.lo[1] = fminf(g.lo[1], g.y[r]); g.hi[1] = fmaxf(g.hi[1], g.y[r]);
      g.lo[2] = fminf(g.lo[2], g.z[r]); g.hi[2] = fmaxf(g.hi[2], g.z[r]);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g.lo[a] = fminf(g.lo[a], __shfl_xor_sync(0xffffffffu, g.lo[a], s));
      g.hi[a] = fmaxf(g.hi[a], __shfl_xor_sync(0xffffffffu, g.hi[a], s));
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// x^2 + y^2 + z^2, summed x, then y, then z.
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The largest |p|^2 of a point p in the box [lo, hi] (rounded to nearest:
// the rounding margin that reads it is four times what it needs).
__device__ __forceinline__ float box_max_sq(float lx, float ly, float lz, float hx,
                                            float hy, float hz) {
  return sq_norm(fmaxf(fabsf(lx), fabsf(hx)), fmaxf(fabsf(ly), fabsf(hy)),
                 fmaxf(fabsf(lz), fabsf(hz)));
}

// Lists into ``list``, from tile ``cand`` on in steps of ``stride``, up to
// kList tiles whose boxes (b0, b1: min xyz, max xyz) pass need(b0, b1);
// advances ``cand``.
template <class Need>
__device__ __forceinline__ int list_tiles(const float4* __restrict__ tb, int n_tiles,
                                          int& cand, int stride, int lane, int* list,
                                          Need need) {
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  while (cand < n_tiles && count <= kList - 32) {
    const int t = cand + lane * stride;
    bool take = false;
    if (t < n_tiles) take = need(tb[2 * t], tb[2 * t + 1]);
    const unsigned m = __ballot_sync(0xffffffffu, take);
    if (take) list[count + __popc(m & below)] = t;
    count += __popc(m);
    cand += 32 * stride;
  }
  __syncwarp();
  return count;
}

// Calls visit(tile) on each listed tile, in list order, staged through the
// warp's cp.async ring: tile k + kStages - 1 loads while tile k is visited.
template <class Visit>
__device__ __forceinline__ void sweep_tiles(const float4* __restrict__ tp, const int* list,
                                            int count, float4* ring, int lane,
                                            Visit visit) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) nn::load_tile(ring + s * kTile, tp + (size_t)list[s] * kTile, lane);
    nn::cp_async_commit();
  }
  for (int k = 0; k < count; ++k) {
    const int nxt = k + kStages - 1;
    if (nxt < count)
      nn::load_tile(ring + (nxt % kStages) * kTile, tp + (size_t)list[nxt] * kTile, lane);
    nn::cp_async_commit();
    nn::cp_async_wait<kStages - 1>();
    __syncwarp();
    visit(ring + (k % kStages) * kTile);
    __syncwarp();
  }
  nn::cp_async_wait<0>();
  __syncwarp();
}

// grid (ceil(groups / kWarps), splits); block 32 * kWarps.  Warps work
// alone.  With one split the k-th values go to out (M,); with more, each
// split's k-list goes to part (splits, M, k) for kth_merge.
template <int KCAP>
__global__ void __launch_bounds__(32 * kWarps)
kth_sweep(const float* __restrict__ q, const int* __restrict__ order,
          const float4* __restrict__ tp, const float4* __restrict__ tb, int n_tiles,
          int M, int k, float cap, float* __restrict__ out, float* __restrict__ part) {
  __shared__ __align__(16) float4 ring[kWarps][kStages * kTile];
  __shared__ int needed[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + warp;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  if (group * kGroup >= M) return;
  const float origin[3] = {0.f, 0.f, 0.f};
  Group g;
  load_group(q, order, M, group, lane, origin, g);
  float q2[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) q2[r] = sq_norm(g.x[r], g.y[r], g.z[r]);
  const float gq2 = box_max_sq(g.lo[0], g.lo[1], g.lo[2], g.hi[0], g.hi[1], g.hi[2]);

  // Sorted ascending; the first KCAP - k slots hold -inf and never leave,
  // so slot KCAP - 1 is the k-th smallest of the points taken in and k
  // copies of the cap.  t0: the k-th value over the overlapping tiles.
  float lst[kPerLane][KCAP], t0[kPerLane];
  auto reset = [&]() {
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
#pragma unroll
      for (int j = 0; j < KCAP; ++j) lst[r][j] = j < KCAP - k ? -kInf : cap;
  };
  reset();
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) t0[r] = cap;

  auto visit = [&](const float4* tile) {
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float4 v = tile[j];
      const float t2 = sq_norm(v.x, v.y, v.z);   // +inf at the sentinel
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float dot = __fmaf_rn(g.z[r], v.z, __fmaf_rn(g.y[r], v.y, __fmul_rn(g.x[r], v.x)));
        const float d = __fsub_rn(__fadd_rn(q2[r], t2), __fmul_rn(2.f, dot));
        if (d < fminf(t0[r], lst[r][KCAP - 1])) {
          float c = d;
#pragma unroll
          for (int s = 0; s < KCAP; ++s) {
            const float a = lst[r][s];
            lst[r][s] = fminf(a, c);
            c = fmaxf(a, c);
          }
        }
      }
    }
  };
  // The group's threshold: the largest of its queries' min(t0, k-th value).
  auto threshold = [&]() {
    float t = -kInf;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (g.qi[r] >= 0) t = fmaxf(t, fminf(t0[r], lst[r][KCAP - 1]));
    return warp_max(t);
  };
  // Phase 0, every split: the tiles that overlap the group's box.  Split 0
  // keeps their points; the others keep only t0 (split 0's list then holds
  // k values <= t0, so no point at or above t0 can change the union's k-th
  // value) and start their lists anew.
  int cand = 0;
  while (cand < n_tiles) {
    const int count = list_tiles(tb, n_tiles, cand, 1, lane, needed[warp],
                                 [&](float4 b0, float4 b1) {
      return nn::box_gap2(b0, b1, g.lo, g.hi) <= 0.f;
    });
    sweep_tiles(tp, needed[warp], count, ring[warp], lane, visit);
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) t0[r] = lst[r][KCAP - 1];
  if (split > 0) reset();
  // Phase 1: this split's share of the other tiles (tiles split, split +
  // splits, ...), those whose gap less the rounding margin is below the
  // threshold as it stands when each pass is listed.
  cand = split;
  while (cand < n_tiles) {
    const float t = threshold();
    const int count = list_tiles(tb, n_tiles, cand, splits, lane, needed[warp],
                                 [&](float4 b0, float4 b1) {
      const float g2 = nn::box_gap2(b0, b1, g.lo, g.hi);
      if (!(g2 > 0.f && g2 < kBig)) return false;
      const float t2 = box_max_sq(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y);
      const float margin = 0x1p-19f * (gq2 + t2 + g2);
      return g2 - margin < t;
    });
    sweep_tiles(tp, needed[warp], count, ring[warp], lane, visit);
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (g.qi[r] < 0) continue;
    if (splits == 1) {
      out[g.qi[r]] = fmaxf(lst[r][KCAP - 1], 0.f);
    } else {
      float* o = part + ((size_t)split * M + g.qi[r]) * k;
#pragma unroll
      for (int j = 0; j < KCAP; ++j)
        if (j >= KCAP - k) o[j - (KCAP - k)] = lst[r][j];
    }
  }
}

// grid ceil(M / kMergeThreads): the k-th smallest of the splits' sorted
// k-lists of each query (split 0's list first; each later list is read
// until its values reach the running k-th value), clamped at 0.
template <int KCAP>
__global__ void kth_merge(const float* __restrict__ part, int M, int k, int splits,
                          float* __restrict__ out) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= M) return;
  float lst[KCAP];
  const float* p0 = part + (size_t)i * k;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) lst[j] = j < KCAP - k ? -kInf : p0[j - (KCAP - k)];
  for (int s = 1; s < splits; ++s) {
    const float* ps = part + ((size_t)s * M + i) * k;
    for (int j = 0; j < k; ++j) {
      const float d = ps[j];
      if (!(d < lst[KCAP - 1])) break;
      float c = d;
#pragma unroll
      for (int u = 0; u < KCAP; ++u) {
        const float a = lst[u];
        lst[u] = fminf(a, c);
        c = fmaxf(a, c);
      }
    }
  }
  out[i] = fmaxf(lst[KCAP - 1], 0.f);
}

// grid (ceil(groups / kWarps), splits); block 32 * kWarps.  Warps work
// alone.  With one split the moments go to out (M, 16); with more, each
// split's sums go to part (splits, M, kFeat) for moments_reduce.
__global__ void __launch_bounds__(32 * kWarps)
moments_sweep(const float* __restrict__ q, const int* __restrict__ order,
              const float* __restrict__ r2, const float* __restrict__ centroid,
              const float4* __restrict__ tp, const float4* __restrict__ tb, int n_tiles,
              int M, float* __restrict__ out, float* __restrict__ part) {
  __shared__ __align__(16) float4 ring[kWarps][kStages * kTile];
  __shared__ int needed[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * kWarps + warp;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  if (group * kGroup >= M) return;
  const float c[3] = {centroid[0], centroid[1], centroid[2]};
  Group g;
  load_group(q, order, M, group, lane, c, g);
  float rq[kPerLane], acc[kPerLane][kFeat];
  float t = -kInf;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    rq[r] = g.qi[r] >= 0 ? r2[g.qi[r]] : -kInf;
    t = fmaxf(t, rq[r]);
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[r][f] = 0.f;
  }
  t = warp_max(t);

  auto visit = [&](const float4* tile) {
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float4 v = tile[j];
      const float x = __fsub_rn(v.x, c[0]), y = __fsub_rn(v.y, c[1]),
                  z = __fsub_rn(v.z, c[2]);
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float d = nn::sq_dist(g.x[r], g.y[r], g.z[r], x, y, z);
        if (d <= rq[r]) {
          float* a = acc[r];
          a[0] = __fadd_rn(a[0], 1.f);
          a[1] = __fadd_rn(a[1], x);
          a[2] = __fadd_rn(a[2], y);
          a[3] = __fadd_rn(a[3], z);
          a[4] = __fadd_rn(a[4], __fmul_rn(x, x));
          a[5] = __fadd_rn(a[5], __fmul_rn(x, y));
          a[6] = __fadd_rn(a[6], __fmul_rn(x, z));
          a[7] = __fadd_rn(a[7], __fmul_rn(y, y));
          a[8] = __fadd_rn(a[8], __fmul_rn(y, z));
          a[9] = __fadd_rn(a[9], __fmul_rn(z, z));
        }
      }
    }
  };
  int cand = split;
  while (cand < n_tiles) {
    const int count = list_tiles(tb, n_tiles, cand, splits, lane, needed[warp],
                                 [&](float4 b0, float4 b1) {
      const float4 c0 = make_float4(__fsub_rn(b0.x, c[0]), __fsub_rn(b0.y, c[1]),
                                    __fsub_rn(b0.z, c[2]), __fsub_rn(b0.w, c[0]));
      const float4 c1 = make_float4(__fsub_rn(b1.x, c[1]), __fsub_rn(b1.y, c[2]), 0.f, 0.f);
      return nn::box_gap2(c0, c1, g.lo, g.hi) <= t;
    });
    sweep_tiles(tp, needed[warp], count, ring[warp], lane, visit);
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (g.qi[r] < 0) continue;
    const float* a = acc[r];
    if (splits == 1) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)g.qi[r] * kOut);
      o[0] = make_float4(a[0], a[1], a[2], a[3]);
      o[1] = make_float4(a[4], a[5], a[6], a[7]);
      o[2] = make_float4(a[8], a[9], 0.f, 0.f);
      o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float* o = part + ((size_t)split * M + g.qi[r]) * kFeat;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) o[f] = a[f];
    }
  }
}

// grid ceil(M / kMergeThreads): the splits' sums added in split order.
__global__ void moments_reduce(const float* __restrict__ part, int M, int splits,
                               float* __restrict__ out) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= M) return;
  float s[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) s[f] = part[(size_t)i * kFeat + f];
  for (int sp = 1; sp < splits; ++sp) {
    const float* p = part + ((size_t)sp * M + i) * kFeat;
#pragma unroll
    for (int f = 0; f < kFeat; ++f) s[f] = __fadd_rn(s[f], p[f]);
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)i * kOut);
  o[0] = make_float4(s[0], s[1], s[2], s[3]);
  o[1] = make_float4(s[4], s[5], s[6], s[7]);
  o[2] = make_float4(s[8], s[9], 0.f, 0.f);
  o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
}

inline dim3 grid_for(int M, int splits) {
  const int groups = (M + kGroup - 1) / kGroup;
  return dim3((groups + kWarps - 1) / kWarps, splits);
}

template <int KCAP>
int launch_kth(const float* q, const int* order, const float4* tp, const float4* tb,
               int n_tiles, int M, int k, float cap, int splits, float* part, float* out,
               cudaStream_t st) {
  kth_sweep<KCAP><<<grid_for(M, splits), 32 * kWarps, 0, st>>>(q, order, tp, tb, n_tiles,
                                                               M, k, cap, out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  kth_merge<KCAP><<<(M + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, st>>>(
      part, M, k, splits, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The prepass into out (M,); 1 <= k <= kMaxK, cap = r^2 finite, 1 <= splits
// <= 65535, part (splits, M, k) when splits > 1.  ``order`` must name every
// query once (ops/cuda_normals.normals_layout).
extern "C" int kth_within_launch(const float* q, const int* order, const void* t_pts,
                                 const void* t_boxes, int n_tiles, int M, int k,
                                 float cap, int splits, float* part, float* out,
                                 void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tp = static_cast<const float4*>(t_pts);
  const float4* tb = static_cast<const float4*>(t_boxes);
  if (k <= 8) return launch_kth<8>(q, order, tp, tb, n_tiles, M, k, cap, splits, part, out, st);
  if (k <= 16)
    return launch_kth<16>(q, order, tp, tb, n_tiles, M, k, cap, splits, part, out, st);
  return launch_kth<32>(q, order, tp, tb, n_tiles, M, k, cap, splits, part, out, st);
}

// The moments (M, 16) into out; r2 (M,) finite per-query squared radii,
// centroid (3,) the support centroid the plain version centres on, part
// (splits, M, 10) when splits > 1.
extern "C" int moments_launch(const float* q, const int* order, const float* r2,
                              const float* centroid, const void* t_pts,
                              const void* t_boxes, int n_tiles, int M, int splits,
                              float* part, float* out, void* stream) {
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  moments_sweep<<<grid_for(M, splits), 32 * kWarps, 0, st>>>(
      q, order, r2, centroid, static_cast<const float4*>(t_pts),
      static_cast<const float4*>(t_boxes), n_tiles, M, out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  moments_reduce<<<(M + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, st>>>(
      part, M, splits, out);
  return (int)cudaGetLastError();
}

extern "C" int normals_tile_size() { return kTile; }
extern "C" int normals_group_size() { return kGroup; }
extern "C" int kth_max_k() { return kMaxK; }
