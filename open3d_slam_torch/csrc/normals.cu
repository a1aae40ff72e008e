// Radius-neighbourhood PCA moments for normal estimation, for Hopper (sm_90a).
//
// Replaces the TPU kernel open3d_slam_tpu/ops/pallas_normals.py::
// radius_moments_at (body _moments_kernel).  It computes the same function:
// for each query q, the sums of the support features
// F = [1, x, y, z, xx, xy, xz, yy, yz, zz] over the valid support points p
// with difference-form float32 |q - p|^2 <= r_q^2, where r_q is the query's
// own hybrid radius min(r, d_k).  Coordinates arrive centred on the support
// centroid and the features arrive precomputed: both stay in the PyTorch
// wrapper, as they stay in XLA around the Pallas kernel.  Output (M, 16),
// columns 10..15 zero.
//
// What bounds it on this card: operations.  M x N pairs (16384 x 16384 in
// odometry, 4096 x 16384 in the mapper) of ~9 float32 operations for the
// distance test, plus 10 adds per in-radius pair; the bytes moved are a few
// MB.
//
// What the design does about it:
//   * one thread per query with its 10 running sums in registers (the TPU
//     kernel forms a 0/1 matrix and multiplies it by F on the MXU; here the
//     indicator is a branch and the product is a predicated add);
//   * support tiles of 128 points (xyz, validity and the 10 features) are
//     staged through shared memory and read as warp-wide broadcasts;
//   * the support axis is split across blocks (grid.y) so a 4096-query call
//     still fills the SMs; a second kernel adds the splits in split order, so
//     the sums are reproducible run to run (no float atomics);
//   * the squared distance is rounded term by term (__fmul_rn/__fadd_rn, in
//     the JAX operand order) so a neighbour on the radius boundary is decided
//     as in the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;
constexpr int kFeat = 10;
constexpr int kOut = 16;

// grid (q_blocks, splits); block kThreads.
__global__ void moments_partial(const float* __restrict__ q,
                                const float* __restrict__ p,
                                const float* __restrict__ valid,
                                const float* __restrict__ feats,
                                const float* __restrict__ r2,
                                float* __restrict__ part,
                                int M, int N, int tiles_per_split) {
  __shared__ float4 sp[kTile];
  __shared__ float sf[kTile][kFeat];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int split = blockIdx.y;
  const bool active = i < M;
  float qx = 0.f, qy = 0.f, qz = 0.f, rr = -1.f;
  if (active) {
    qx = q[(size_t)i * 3 + 0];
    qy = q[(size_t)i * 3 + 1];
    qz = q[(size_t)i * 3 + 2];
    rr = r2[i];
  }
  float acc[kFeat];
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.f;

  const int n_tiles = (N + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int base = t * kTile;
    const int j = base + tid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < N) {
      v = make_float4(p[(size_t)j * 3 + 0], p[(size_t)j * 3 + 1],
                      p[(size_t)j * 3 + 2], valid[j]);
      for (int f = 0; f < kFeat; ++f) sf[tid][f] = feats[(size_t)j * kOut + f];
    }
    sp[tid] = v;
    __syncthreads();
    const int cnt = min(kTile, N - base);
    for (int k = 0; k < cnt; ++k) {
      const float4 s = sp[k];
      const float d0 = __fsub_rn(qx, s.x);
      const float d1 = __fsub_rn(qy, s.y);
      const float d2 = __fsub_rn(qz, s.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      if (d <= rr && s.w > 0.f) {
        for (int f = 0; f < kFeat; ++f) acc[f] = __fadd_rn(acc[f], sf[k][f]);
      }
    }
    __syncthreads();
  }
  if (active) {
    float* o = part + ((size_t)split * M + i) * kFeat;
    for (int f = 0; f < kFeat; ++f) o[f] = acc[f];
  }
}

// grid ceil(M / kThreads); adds the splits in split order.
__global__ void moments_reduce(const float* __restrict__ part,
                               float* __restrict__ out, int M, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  float* o = out + (size_t)i * kOut;
  for (int f = 0; f < kFeat; ++f) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[((size_t)sp * M + i) * kFeat + f];
    o[f] = s;
  }
  for (int f = kFeat; f < kOut; ++f) o[f] = 0.f;
}

}  // namespace

extern "C" int radius_moments_launch(const float* q, const float* p,
                                     const float* valid, const float* feats,
                                     const float* r2, float* part, float* out,
                                     int M, int N, int splits,
                                     int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (M + kThreads - 1) / kThreads;
  moments_partial<<<dim3(q_blocks, splits), kThreads, 0, st>>>(
      q, p, valid, feats, r2, part, M, N, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce<<<q_blocks, kThreads, 0, st>>>(part, out, M, splits);
  return (int)cudaGetLastError();
}

extern "C" int moments_tile_size() { return kTile; }
extern "C" int moments_block_size() { return kThreads; }
