// Weighted Kabsch step of point-to-point ICP, for Hopper (sm_90a).
//
// Computes the JAX package's open3d_slam_tpu/ops/registration.py::_p2p_step
// (an XLA function inside the lax.while_loop of icp_point_to_point, not a
// Pallas kernel) for a batch of hypotheses: from the points at the current
// pose p (B, M, 3), their correspondences q (B, M, 3) and the inlier flags w
// (B, M),
//   n = max(sum w, 1);  p_bar = sum w p / n;  q_bar = sum w q / n;
//   H = sum w (p - p_bar)(q - q_bar)^T          (3 x 3, the two-pass form)
//   H = U S V^T;  d = sign(det(V U^T));  R = V diag(1, 1, d) U^T;
//   t = q_bar - R p_bar;  dT = [R t; 0 0 0 1].
// It replaces the loop's library route (the moments, torch.linalg.svd and
// torch.linalg.det), whose batched SVD synchronises with the host and cannot
// be captured into the loop's CUDA graph (ops/gn_graph.py).  The points lie
// 10-36 m out, so H is summed about the centroids (a second pass): the
// one-pass sum w p q^T - n p_bar q_bar^T cancels in float32.
//
// Layout: a thread-block cluster of C CTAs per hypothesis, grid B x C,
// launched with cudaLaunchKernelEx and the cluster-dimension attribute.  C
// depends on M alone (ops/cuda_p2p.cluster_size: min(8, ceil(M / 2048)), 8
// being the portable cluster size), so a hypothesis gives the same bits
// alone as in any batch.  A cluster of one (M <= 2048) is launched without
// the attribute, and its barriers are __syncthreads: on the H100 the
// cluster launch cost ~2 us more (PERF.md, the split of the Kabsch step).  CTA r takes
// the contiguous chunk [r L, (r + 1) L) of the points, L = ceil(M / C), and
// stages its chunk's p, q and w in shared memory once, with 16-byte
// cp.async copies all in flight together (a head and a tail that are not
// 16-byte aligned byte by byte); both passes then read shared memory.  A
// chunk over kMaxStaged points is not staged: both passes read device
// memory, the second from L2.
//
// Sums, float32 as the plain version's (ops/cuda_p2p.p2p_step_plain), in a
// fixed order with no atomics and no scratch in device memory: each thread
// adds its points (stride kThreads) in index order, a warp adds its lanes by
// shuffles in a fixed tree, a CTA adds its warps in index order, and a
// cluster adds its CTAs' partials in rank order, read from distributed
// shared memory after a cluster barrier.  Every CTA sums the pass-1
// partials itself, in that order, so all hold the same centroids after the
// first barrier; CTA 0 sums H after the second and keeps the cluster alive
// (a third barrier) until it has read the others' partials.
//
// The SVD, on CTA 0's thread 0 in float64, in registers: every array is
// indexed by compile-time constants (the three rotations of a sweep
// unrolled, a template each), so ptxas gives the kernel no stack frame.
// The tail is a chain of dependent float64 operations, so each rotation
// takes its angle through two rsqrts (jacobi_rotate), and U's columns are
// normalised by rsqrt too.
// Cyclic Jacobi on H^T H gives V and the squared singular values, sorted in
// descending order; u1 = H v1 / |H v1|, u2 = the part of H v2 orthogonal to
// u1, normalised, and u3 = u1 x u2.  R depends on u3 only through d u3,
// which is the same for either sign of u3, so the third pair of the SVD is
// never needed and the rank-2 case (planar inliers, sigma3 = 0) takes the
// same path.  H^T H squares the condition number, which float64 keeps above
// float32's rounding of H down to sigma2 / sigma1 ~ 1e-7.  Degenerate cases:
//   * H = 0 (no inliers, or one): U = V = I, as LAPACK returns, so R = I;
//     with no inliers p_bar = q_bar = 0 and dT = I.
//   * rank 1 (collinear inliers; sigma2 <= 1e-6 sigma1): R is not determined
//     by H.  The kernel returns the smallest rotation that takes u1 (the
//     source line's direction) to v1 (the target line's): u2 is v2 moved by
//     the smallest rotation taking v1 to u1 (half a turn about an axis
//     normal to v1 when u1 = -v1).  LAPACK returns some other rotation.
//   * sign(0) = 0 as jnp.sign, although det(V U^T) is +-1 for finite H.
//
// What bounds it on this card: latency.  B x M x 25 bytes read, B x 64
// written, ~30 float operations a point; at 64 x 1024 that is 1.6 MB, ~0.5
// us at the memory's rate.  The cluster spreads a large M over up to 8 SMs;
// what is left is the launch, the cluster's barriers and the float64
// Jacobi's chain of dependent operations on one thread.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// Points a CTA stages: two 12-byte and one 1-byte array, each with 16 bytes
// of slack for its alignment, within the 227 KB a block may use.
constexpr int kMaxStaged = 9216;
constexpr double kRankTol = 1e-6;
constexpr int kMaxSweeps = 32;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__host__ __device__ constexpr int staged_bytes(int L) {
  return 2 * round16(12 * L + 16) + round16(L + 16);
}

// Starts copying nbytes from g to s, which lie at the same offset modulo 16:
// the aligned middle as 16-byte cp.async copies, all in flight at once,
// then the head and tail byte by byte.  Complete after
// __pipeline_wait_prior(0) and a barrier.
__device__ __forceinline__ void stage(const unsigned char* __restrict__ g, int nbytes,
                                      unsigned char* __restrict__ s) {
  const int head = min(nbytes, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int body = (nbytes - head) & ~15;
  for (int i = threadIdx.x; i < body / 16; i += kThreads)
    __pipeline_memcpy_async(s + head + 16 * i, g + head + 16 * i, 16);
  for (int i = threadIdx.x; i < head; i += kThreads) s[i] = __ldg(g + i);
  for (int i = head + body + threadIdx.x; i < nbytes; i += kThreads) s[i] = __ldg(g + i);
}

// The lanes' values added into lane 0, in a fixed tree.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The threads' values acc[0..NV) added into out[0..NV): lanes by warp_sum,
// then the warps in index order.  out is complete after the next barrier.
template <int NV>
__device__ __forceinline__ void block_sum(const float (&acc)[9], float (*part)[kWarps],
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float s = warp_sum(acc[v]);
    if (lane == 0) part[v][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = part[threadIdx.x][0];
    for (int k = 1; k < kWarps; ++k) s = s + part[threadIdx.x][k];
    out[threadIdx.x] = s;
  }
}

// Value v of every CTA's partials (`mine`, at the same place in each CTA's
// shared memory) added in rank order.  A cluster of one is a lone block.
__device__ __forceinline__ float cluster_sum(float* mine, int v, int C) {
  if (C == 1) return mine[v];
  cg::cluster_group cluster = cg::this_cluster();
  float s = cluster.map_shared_rank(mine, 0)[v];
  for (int r = 1; r < C; ++r) s = s + cluster.map_shared_rank(mine, r)[v];
  return s;
}

__device__ __forceinline__ void cluster_barrier(int C) {
  if (C == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

typedef double Vec3[3];
typedef double Mat3[3][3];

__device__ __forceinline__ void cross(const Vec3& a, const Vec3& b, Vec3& out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double dot(const Vec3& a, const Vec3& b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One Jacobi rotation of the symmetric A in the (P, Q) plane, accumulated
// into V; past the fourth sweep (`late`) an off-diagonal entry negligible
// against both diagonal entries is set to zero instead.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(Mat3& A, Mat3& V, bool late) {
  const double apq = A[P][Q];
  if (apq == 0.0) return;
  const double g = 100.0 * fabs(apq);
  if (late && fabs(A[P][P]) + g == fabs(A[P][P]) && fabs(A[Q][Q]) + g == fabs(A[Q][Q])) {
    A[P][Q] = A[Q][P] = 0.0;
    return;
  }
  // The rotation by phi, |phi| <= pi/4, with tan 2 phi = 2 apq / d: cos 2 phi
  // = |d| / h and sin 2 phi = +-2 |apq| / h, h = sqrt(d^2 + 4 apq^2), then
  // c = cos phi = (1 + cos 2 phi) k and s = sin phi = sin 2 phi k with k =
  // 1 / sqrt(2 (1 + cos 2 phi)).  The dependent chain is two rsqrts, where
  // the textbook's t = tan phi takes three divisions and two square roots.
  const double d = A[Q][Q] - A[P][P], a2 = 2.0 * fabs(apq);
  const bool up = d == 0.0 || (d > 0.0) == (apq > 0.0);   // phi >= 0
  const double r = rsqrt(d * d + a2 * a2);
  const double cos2 = fabs(d) * r, sin2 = (up ? a2 : -a2) * r;
  const double k = rsqrt(2.0 + 2.0 * cos2);
  const double c = (1.0 + cos2) * k, s = sin2 * k;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double akp = A[k][P], akq = A[k][Q];
    A[k][P] = c * akp - s * akq;
    A[k][Q] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double apk = A[P][k], aqk = A[Q][k];
    A[P][k] = c * apk - s * aqk;
    A[Q][k] = s * apk + c * aqk;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double vkp = V[k][P], vkq = V[k][Q];
    V[k][P] = c * vkp - s * vkq;
    V[k][Q] = s * vkp + c * vkq;
  }
}

// Swaps eigenpairs J and J + 1 when lam[J] < lam[J + 1].
template <int J>
__device__ __forceinline__ void order_pair(Vec3& lam, Mat3& V) {
  if (lam[J] < lam[J + 1]) {
    const double l = lam[J];
    lam[J] = lam[J + 1];
    lam[J + 1] = l;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double v = V[k][J];
      V[k][J] = V[k][J + 1];
      V[k][J + 1] = v;
    }
  }
}

// Eigenvectors (columns of V) and eigenvalues of the symmetric A, by cyclic
// Jacobi rotations, sorted by descending eigenvalue.
__device__ __forceinline__ void jacobi3(Mat3& A, Mat3& V, Vec3& lam) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (A[0][1] == 0.0 && A[0][2] == 0.0 && A[1][2] == 0.0) break;
    const bool late = sweep > 3;
    jacobi_rotate<0, 1>(A, V, late);
    jacobi_rotate<0, 2>(A, V, late);
    jacobi_rotate<1, 2>(A, V, late);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) lam[i] = A[i][i];
  order_pair<0>(lam, V);
  order_pair<1>(lam, V);
  order_pair<0>(lam, V);
}

// x moved by the smallest rotation that takes the unit vector a to the unit
// vector b.
__device__ __forceinline__ void rotate_min(const Vec3& a, const Vec3& b, const Vec3& x,
                                           Vec3& out) {
  const double c = dot(a, b);
  if (c > -1.0 + 1e-12) {
    Vec3 k, kx;
    cross(a, b, k);
    cross(k, x, kx);
    const double f = dot(k, x) / (1.0 + c);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = c * x[i] + kx[i] + f * k[i];
    return;
  }
  // The axis e_j with the smallest |a_j| (the first on ties), as a one-hot.
  const bool j1 = fabs(a[1]) < fabs(a[0]);
  const bool j2 = fabs(a[2]) < (j1 ? fabs(a[1]) : fabs(a[0]));
  const Vec3 e = {!j1 && !j2 ? 1.0 : 0.0, j1 && !j2 ? 1.0 : 0.0, j2 ? 1.0 : 0.0};
  Vec3 axis;
  cross(a, e, axis);
  const double n = sqrt(dot(axis, axis));
#pragma unroll
  for (int i = 0; i < 3; ++i) axis[i] /= n;
  const double f = 2.0 * dot(axis, x);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = f * axis[i] - x[i];
}

// R = V diag(1, 1, sign(det(V U^T))) U^T of the SVD H = U S V^T.
__device__ __forceinline__ void kabsch_rotation(const float (&H32)[3][3], float (&R)[3][3]) {
  Mat3 H, A, V, U;
  Vec3 lam;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = (double)H32[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = H[0][i] * H[0][j] + H[1][i] * H[1][j] + H[2][i] * H[2][j];
  jacobi3(A, V, lam);
  Vec3 v1, v2, hv1, hv2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v1[i] = V[i][0];
    v2[i] = V[i][1];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    hv1[i] = dot(H[i], v1);
    hv2[i] = dot(H[i], v2);
  }
  const double h1 = dot(hv1, hv1);   // |H v1|^2
  if (h1 == 0.0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) U[i][j] = V[i][j] = i == j ? 1.0 : 0.0;
  } else {
    Vec3 u1, u2, u3, w;
    const double inv1 = rsqrt(h1);
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = hv1[i] * inv1;
    const double along = dot(u1, hv2);
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = hv2[i] - along * u1[i];
    const double h2 = dot(w, w);
    if (h2 > kRankTol * kRankTol * h1) {    // sigma2 > kRankTol sigma1
      const double inv2 = rsqrt(h2);
#pragma unroll
      for (int i = 0; i < 3; ++i) u2[i] = w[i] * inv2;
    } else {
      rotate_min(v1, u1, v2, u2);
    }
    cross(u1, u2, u3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      U[i][0] = u1[i];
      U[i][1] = u2[i];
      U[i][2] = u3[i];
    }
  }
  Mat3 M;   // V U^T
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = V[i][0] * U[j][0] + V[i][1] * U[j][1] + V[i][2] * U[j][2];
  const double det = M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
                     M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
                     M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
  const double d = det > 0.0 ? 1.0 : (det < 0.0 ? -1.0 : 0.0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = (float)(V[i][0] * U[j][0] + V[i][1] * U[j][1] + d * V[i][2] * U[j][2]);
}

// Adds the inliers among points [0, n) of one chunk: into acc[0..7) the
// count, sum p and sum q (pass 1), or into acc[0..9) H about the centroid
// pb, qb (pass 2).
template <bool kSecond>
__device__ __forceinline__ void chunk_pass(const float* P, const float* Q,
                                           const unsigned char* W, int n, const float* bar,
                                           float (&acc)[9]) {
#pragma unroll
  for (int v = 0; v < 9; ++v) acc[v] = 0.0f;
  float pb[3], qb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pb[k] = kSecond ? bar[k] : 0.0f;
    qb[k] = kSecond ? bar[3 + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!W[i]) continue;
    if (!kSecond) {
      acc[0] = acc[0] + 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        acc[1 + k] = acc[1 + k] + P[i * 3 + k];
        acc[4 + k] = acc[4 + k] + Q[i * 3 + k];
      }
    } else {
      float a[3], c[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a[k] = P[i * 3 + k] - pb[k];
        c[k] = Q[i * 3 + k] - qb[k];
      }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[r * 3 + k] = acc[r * 3 + k] + a[r] * c[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
p2p_step_kernel(const float* __restrict__ pts, const float* __restrict__ q,
                const unsigned char* __restrict__ w, float* __restrict__ out, int M, int L,
                int C, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[9][kWarps];
  __shared__ float part1[7], part2[9];   // this CTA's partials, read across the cluster
  __shared__ float tot[7], bar[6];
  __shared__ float Hs[9];
  const int rank = blockIdx.x % C;          // the CTA's rank in its cluster
  const long long b = blockIdx.x / C;
  const long long start = (long long)rank * L;
  const int n = (int)max(0LL, min((long long)L, (long long)M - start));
  const float* P = pts + (b * M + start) * 3;
  const float* Q = q + (b * M + start) * 3;
  const unsigned char* W = w + b * M + start;
  if (staged) {
    const int span = round16(12 * L + 16);
    unsigned char* sp = smem + ((uintptr_t)P & 15);
    unsigned char* sq = smem + span + ((uintptr_t)Q & 15);
    unsigned char* sw = smem + 2 * span + ((uintptr_t)W & 15);
    stage(reinterpret_cast<const unsigned char*>(P), 12 * n, sp);
    stage(reinterpret_cast<const unsigned char*>(Q), 12 * n, sq);
    stage(W, n, sw);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    P = reinterpret_cast<const float*>(sp);
    Q = reinterpret_cast<const float*>(sq);
    W = sw;
  }

  float acc[9];
  chunk_pass<false>(P, Q, W, n, bar, acc);
  block_sum<7>(acc, part, part1);
  cluster_barrier(C);
  if (threadIdx.x < 7) tot[threadIdx.x] = cluster_sum(part1, threadIdx.x, C);
  __syncthreads();
  if (threadIdx.x < 6) {
    const float cnt = tot[0] < 1.0f ? 1.0f : tot[0];
    bar[threadIdx.x] = tot[1 + threadIdx.x] / cnt;
  }
  __syncthreads();

  chunk_pass<true>(P, Q, W, n, bar, acc);
  block_sum<9>(acc, part, part2);
  cluster_barrier(C);
  if (rank == 0 && threadIdx.x < 9) Hs[threadIdx.x] = cluster_sum(part2, threadIdx.x, C);
  cluster_barrier(C);   // the other CTAs' partials are read: they may exit
  if (rank != 0 || threadIdx.x != 0) return;

  float H[3][3], R[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) H[r][k] = Hs[r * 3 + k];
  kabsch_rotation(H, R);
  float* o = out + b * 16;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float rp = (R[r][0] * bar[0] + R[r][1] * bar[1]) + R[r][2] * bar[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) o[r * 4 + k] = R[r][k];
    o[r * 4 + 3] = bar[3 + r] - rp;
  }
  o[12] = 0.0f;
  o[13] = 0.0f;
  o[14] = 0.0f;
  o[15] = 1.0f;
}

}  // namespace

// C: the cluster size, 1..8, which the caller derives from M alone.
extern "C" int p2p_step_launch(const float* pts, const float* q, const unsigned char* w,
                               float* out, int B, int M, int C, void* stream) {
  if (M < 0 || C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int L = (M + C - 1) / C;
  const int staged = L <= kMaxStaged;
  const int smem = staged ? staged_bytes(L) : 0;
  if (smem > 32 * 1024) {   // over 48 KB with the static shared memory needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        p2p_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();                          // not left for the next launch's check
      return (int)err;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;               // a cluster of one: a plain launch
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, p2p_step_kernel, pts, q, w, out, M, L, C, staged);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
