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
// What bounds it on this card: operations.  The nearest-neighbour sweep is
// M x N pairs of ~9 float32 operations each (16384 x 16384 in odometry,
// 4096 x 65536 in scan-to-map), while the bytes moved are a few MB.  The
// per-inlier GICP rows are O(M) and cheap next to the sweep.
//
// What the design does about it:
//   * one thread per source point keeps its running (min d2, argmin) in
//     registers; target tiles of 256 points are staged through shared memory
//     as float4 (x, y, z, valid) and read as warp-wide broadcasts;
//   * the target axis is split across blocks (grid.y) so that a 4096-point
//     scan-to-map source still fills all SMs; each split writes its own
//     (d2, index) and the row kernel merges the splits in index order, so
//     the result is the global first minimum, as jnp.argmin gives;
//   * the exact AABB tile skip of the TPU kernel is honoured per (query
//     block, target tile): a tile whose box is farther than the
//     correspondence distance from the block's box of valid queries cannot
//     hold an inlier, so it is not swept;
//   * the winner's 9 target values are read directly by the thread that
//     holds the argmin (the TPU kernel needs a one-hot MXU product for this);
//   * the Cholesky, the forward substitution and the 28 upper-triangle Gram
//     entries are computed in registers; blocks reduce in a fixed tree order
//     and a third kernel sums the block partials in block order.  There are
//     no float atomics, so results are bit-reproducible run to run.
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
constexpr float kDiagEps = 1e-6f;
constexpr float kSqrtTiny = 1e-12f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz) {
  const float d0 = __fsub_rn(qx, tx);
  const float d1 = __fsub_rn(qy, ty);
  const float d2 = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// grid (q_blocks, splits, B); block kThreads.
__global__ void gicp_nn_partial(const float* __restrict__ q_pts,
                                const float* __restrict__ q_mask,
                                int mask_batched,
                                const float* __restrict__ td,
                                const float* __restrict__ tv,
                                int target_batched,
                                const float* __restrict__ r2p,
                                const float* __restrict__ t_aabb,
                                float* __restrict__ part_d2,
                                int* __restrict__ part_idx,
                                int M, int N, int tiles_per_split) {
  __shared__ float4 tile[kTile];
  __shared__ float box[6][kThreads];
  __shared__ float qbox[6];

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool active = i < M;
  const float* qp = q_pts + (size_t)b * M * 3;
  const float* qm = q_mask + (mask_batched ? (size_t)b * M : 0);
  const float* tdb = td + (target_batched ? (size_t)b * 9 * N : 0);
  const float* tvb = tv + (target_batched ? (size_t)b * N : 0);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  bool qvalid = false;
  if (active) {
    qx = qp[(size_t)i * 3 + 0];
    qy = qp[(size_t)i * 3 + 1];
    qz = qp[(size_t)i * 3 + 2];
    qvalid = qm[i] > 0.f;
  }
  const float r2 = *r2p;

  if (t_aabb != nullptr) {
    // Box of the block's valid queries; a block with none gets an empty
    // box (min = +BIG, max = -BIG) and rejects every tile.
    box[0][tid] = qvalid ? qx : kBig;
    box[1][tid] = qvalid ? qy : kBig;
    box[2][tid] = qvalid ? qz : kBig;
    box[3][tid] = qvalid ? qx : -kBig;
    box[4][tid] = qvalid ? qy : -kBig;
    box[5][tid] = qvalid ? qz : -kBig;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) {
        for (int a = 0; a < 3; ++a) {
          box[a][tid] = fminf(box[a][tid], box[a][tid + s]);
          box[a + 3][tid] = fmaxf(box[a + 3][tid], box[a + 3][tid + s]);
        }
      }
      __syncthreads();
    }
    if (tid < 6) qbox[tid] = box[tid][0];
    __syncthreads();
  }

  float best = kBig;
  int arg = 0;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    if (t_aabb != nullptr) {
      const float* ta = t_aabb + (size_t)t * 8;
      float g2 = 0.f;
      for (int a = 0; a < 3; ++a) {
        const float g = fmaxf(fmaxf(ta[a] - qbox[a + 3], qbox[a] - ta[a + 3]), 0.f);
        g2 += g * g;
      }
      if (!(g2 <= r2)) continue;   // uniform across the block
    }
    const int base = t * kTile;
    for (int k = tid; k < kTile; k += kThreads) {
      const int j = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < N) {
        v.x = tdb[j];
        v.y = tdb[(size_t)N + j];
        v.z = tdb[(size_t)2 * N + j];
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
__global__ void gicp_rows(const float* __restrict__ q_pts,
                          const float* __restrict__ q_mask, int mask_batched,
                          const float* __restrict__ q_cov6,
                          const float* __restrict__ td, int target_batched,
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
__global__ void gicp_sum(const float* __restrict__ block_part,
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

extern "C" int gicp_normal_eq_launch(
    const float* q_pts, const float* q_mask, int mask_batched,
    const float* q_cov6, const float* td, const float* tv, int target_batched,
    const float* r2, const float* t_aabb,
    float* part_d2, int* part_idx, float* block_part, float* out,
    int B, int M, int N, int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (M + kThreads - 1) / kThreads;
  gicp_nn_partial<<<dim3(q_blocks, splits, B), kThreads, 0, st>>>(
      q_pts, q_mask, mask_batched, td, tv, target_batched, r2, t_aabb,
      part_d2, part_idx, M, N, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gicp_rows<<<dim3(q_blocks, B), kThreads, 0, st>>>(
      q_pts, q_mask, mask_batched, q_cov6, td, target_batched, r2,
      part_d2, part_idx, block_part, M, N, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gicp_sum<<<B, 32, 0, st>>>(block_part, out, q_blocks);
  return (int)cudaGetLastError();
}

extern "C" int gicp_tile_size() { return kTile; }
extern "C" int gicp_block_size() { return kThreads; }
