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
// be captured into the loop's CUDA graph (ops/gn_graph.py).
//
// Layout: one block per hypothesis, no atomics, so a hypothesis's step
// depends on nothing else in the batch.  Pass 1 sums n, sum w p and sum w q,
// pass 2 the nine entries of H about the centroids; each thread sums its
// strided share of the points in index order, then a fixed shared-memory
// tree adds the threads' partials.  The sums are float32, like the plain
// version's (ops/cuda_p2p.p2p_step_plain), taken in another order.
//
// The SVD, on thread 0 in float64: cyclic Jacobi on H^T H gives V and the
// squared singular values, sorted in descending order; u1 = H v1 / |H v1|,
// u2 = the part of H v2 orthogonal to u1, normalised, and u3 = u1 x u2.  R
// depends on u3 only through d u3, which is the same for either sign of u3,
// so the third pair of the SVD is never needed and the rank-2 case (planar
// inliers, sigma3 = 0) takes the same path.  H^T H squares the condition
// number, which float64 keeps above float32's rounding of H down to sigma2 /
// sigma1 ~ 1e-7.  Degenerate cases:
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
// us at the memory's rate.  The two passes and the 3 x 3 SVD on one thread
// are a few microseconds of dependent steps; a block per hypothesis keeps
// them in parallel across hypotheses.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kRankTol = 1e-6;
constexpr int kMaxSweeps = 32;

// Adds the threads' partials of `nv` values ([value][thread] in `s`) into
// s[value][0], in a fixed tree order.
__device__ void tree_sum(float (*s)[kThreads], int nv) {
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      for (int v = 0; v < nv; ++v) s[v][threadIdx.x] = s[v][threadIdx.x] + s[v][threadIdx.x + half];
    __syncthreads();
  }
}

__device__ void cross(const double* a, const double* b, double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ double dot(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Eigenvectors (columns of V) and eigenvalues of the symmetric A, by cyclic
// Jacobi rotations, sorted by descending eigenvalue.
__device__ void jacobi3(double A[3][3], double V[3][3], double lam[3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (A[0][1] == 0.0 && A[0][2] == 0.0 && A[1][2] == 0.0) break;
    for (int r = 0; r < 3; ++r) {
      const int p = P[r], q = Q[r];
      const double apq = A[p][q];
      if (apq == 0.0) continue;
      const double g = 100.0 * fabs(apq);
      if (sweep > 3 && fabs(A[p][p]) + g == fabs(A[p][p]) &&
          fabs(A[q][q]) + g == fabs(A[q][q])) {
        A[p][q] = A[q][p] = 0.0;
        continue;
      }
      const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
      const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
      for (int k = 0; k < 3; ++k) {
        const double akp = A[k][p], akq = A[k][q];
        A[k][p] = c * akp - s * akq;
        A[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        const double apk = A[p][k], aqk = A[q][k];
        A[p][k] = c * apk - s * aqk;
        A[q][k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {
        const double vkp = V[k][p], vkq = V[k][q];
        V[k][p] = c * vkp - s * vkq;
        V[k][q] = s * vkp + c * vkq;
      }
    }
  }
  for (int i = 0; i < 3; ++i) lam[i] = A[i][i];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2 - i; ++j)
      if (lam[j] < lam[j + 1]) {
        const double l = lam[j];
        lam[j] = lam[j + 1];
        lam[j + 1] = l;
        for (int k = 0; k < 3; ++k) {
          const double v = V[k][j];
          V[k][j] = V[k][j + 1];
          V[k][j + 1] = v;
        }
      }
}

// x moved by the smallest rotation that takes the unit vector a to the unit
// vector b.
__device__ void rotate_min(const double* a, const double* b, const double* x, double* out) {
  const double c = dot(a, b);
  if (c > -1.0 + 1e-12) {
    double k[3], kx[3];
    cross(a, b, k);
    cross(k, x, kx);
    const double f = dot(k, x) / (1.0 + c);
    for (int i = 0; i < 3; ++i) out[i] = c * x[i] + kx[i] + f * k[i];
    return;
  }
  int j = 0;
  for (int i = 1; i < 3; ++i)
    if (fabs(a[i]) < fabs(a[j])) j = i;
  double e[3] = {0.0, 0.0, 0.0}, axis[3];
  e[j] = 1.0;
  cross(a, e, axis);
  const double n = sqrt(dot(axis, axis));
  for (int i = 0; i < 3; ++i) axis[i] /= n;
  const double f = 2.0 * dot(axis, x);
  for (int i = 0; i < 3; ++i) out[i] = f * axis[i] - x[i];
}

// R = V diag(1, 1, sign(det(V U^T))) U^T of the SVD H = U S V^T.
__device__ void kabsch_rotation(const float H32[3][3], float R[3][3]) {
  double H[3][3], A[3][3], V[3][3], lam[3], U[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) H[i][j] = (double)H32[i][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) A[i][j] = H[0][i] * H[0][j] + H[1][i] * H[1][j] + H[2][i] * H[2][j];
  jacobi3(A, V, lam);
  double v1[3], v2[3], hv1[3], hv2[3];
  for (int i = 0; i < 3; ++i) {
    v1[i] = V[i][0];
    v2[i] = V[i][1];
  }
  for (int i = 0; i < 3; ++i) {
    hv1[i] = dot(H[i], v1);
    hv2[i] = dot(H[i], v2);
  }
  const double n1 = sqrt(dot(hv1, hv1));
  if (n1 == 0.0) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) U[i][j] = V[i][j] = i == j ? 1.0 : 0.0;
  } else {
    double u1[3], u2[3], u3[3];
    for (int i = 0; i < 3; ++i) u1[i] = hv1[i] / n1;
    const double along = dot(u1, hv2);
    double w[3];
    for (int i = 0; i < 3; ++i) w[i] = hv2[i] - along * u1[i];
    const double n2 = sqrt(dot(w, w));
    if (n2 > kRankTol * n1) {
      for (int i = 0; i < 3; ++i) u2[i] = w[i] / n2;
    } else {
      rotate_min(v1, u1, v2, u2);
    }
    cross(u1, u2, u3);
    for (int i = 0; i < 3; ++i) {
      U[i][0] = u1[i];
      U[i][1] = u2[i];
      U[i][2] = u3[i];
    }
  }
  double M[3][3];   // V U^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M[i][j] = V[i][0] * U[j][0] + V[i][1] * U[j][1] + V[i][2] * U[j][2];
  const double det = M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
                     M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
                     M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
  const double d = det > 0.0 ? 1.0 : (det < 0.0 ? -1.0 : 0.0);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[i][j] = (float)(V[i][0] * U[j][0] + V[i][1] * U[j][1] + d * V[i][2] * U[j][2]);
}

__global__ void __launch_bounds__(kThreads)
p2p_step_kernel(const float* __restrict__ pts, const float* __restrict__ q,
                const unsigned char* __restrict__ w, float* __restrict__ out, int M) {
  __shared__ float s[9][kThreads];
  __shared__ float bar[6];
  const int b = blockIdx.x;
  const float* p = pts + (long long)b * M * 3;
  const float* t = q + (long long)b * M * 3;
  const unsigned char* wb = w + (long long)b * M;

  float acc[9];
  for (int v = 0; v < 7; ++v) acc[v] = 0.0f;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    if (!wb[i]) continue;
    acc[0] = acc[0] + 1.0f;
    for (int k = 0; k < 3; ++k) {
      acc[1 + k] = acc[1 + k] + p[i * 3 + k];
      acc[4 + k] = acc[4 + k] + t[i * 3 + k];
    }
  }
  for (int v = 0; v < 7; ++v) s[v][threadIdx.x] = acc[v];
  __syncthreads();
  tree_sum(s, 7);
  if (threadIdx.x == 0) {
    const float n = s[0][0] < 1.0f ? 1.0f : s[0][0];
    for (int k = 0; k < 6; ++k) bar[k] = s[1 + k][0] / n;
  }
  __syncthreads();
  const float pb[3] = {bar[0], bar[1], bar[2]}, qb[3] = {bar[3], bar[4], bar[5]};

  for (int v = 0; v < 9; ++v) acc[v] = 0.0f;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    if (!wb[i]) continue;
    float a[3], c[3];
    for (int k = 0; k < 3; ++k) {
      a[k] = p[i * 3 + k] - pb[k];
      c[k] = t[i * 3 + k] - qb[k];
    }
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k) acc[r * 3 + k] = acc[r * 3 + k] + a[r] * c[k];
  }
  for (int v = 0; v < 9; ++v) s[v][threadIdx.x] = acc[v];
  __syncthreads();
  tree_sum(s, 9);
  if (threadIdx.x != 0) return;

  float H[3][3], R[3][3];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) H[r][k] = s[r * 3 + k][0];
  kabsch_rotation(H, R);
  float* o = out + (long long)b * 16;
  for (int r = 0; r < 3; ++r) {
    const float rp = (R[r][0] * pb[0] + R[r][1] * pb[1]) + R[r][2] * pb[2];
    for (int k = 0; k < 3; ++k) o[r * 4 + k] = R[r][k];
    o[r * 4 + 3] = qb[r] - rp;
  }
  o[12] = 0.0f;
  o[13] = 0.0f;
  o[14] = 0.0f;
  o[15] = 1.0f;
}

}  // namespace

extern "C" int p2p_step_launch(const float* pts, const float* q, const unsigned char* w,
                               float* out, int B, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p2p_step_kernel<<<B, kThreads, 0, st>>>(pts, q, w, out, M);
  return (int)cudaGetLastError();
}
