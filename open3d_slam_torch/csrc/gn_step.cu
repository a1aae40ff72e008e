// One Gauss-Newton step of the fused ICP loops after their sweep, and the
// pose applied to the source before it, for Hopper (sm_90a).
//
// Replaces the chain of ~70 small PyTorch operations that ran around K1
// (gicp.cu) and K4 (icp.cu) in every iteration of
// open3d_slam_torch/ops/registration.py's fused loops: the JAX package's loop
// bodies, open3d_slam_tpu/ops/registration.py:144-199 (point-to-plane) and
// :201-255 (GICP), XLA functions around the Pallas kernels, with _solve6
// (:85) and _euler_xyz_transform (:51).
//
// gn_step, one thread a batch element (the redesign of solve6.cu, which it
// contains through solve6.cuh):
//   * reads the fused kernel's (B, 8, 128) output at the poses P through its
//     strides: JtJ, Jtr, the inlier count and the inlier d2 sum;
//   * fitness = n_in / max(n_src, 1) and rmse = sqrt(d2 / max(n_in, 1)), as
//     registration._stats;
//   * outside the start, Open3D's stop test against the fitness and rmse at
//     the previous poses (|fit - fit'| < rf and |rmse - rmse'| < rr), the
//     iteration count advanced where the element was not done, done |= conv;
//   * the jittered 6x6 solve (gn::solve6), the retraction (se3::se3_exp, or
//     the Euler-XYZ Rz Ry Rx with t), and the next poses dT P, kept at P
//     where the element is done.
// The loop's state after it is (T = P, P' = the next poses, fit', rmse',
// it', done'): the stop test stays in the iteration whose sweep it reads,
// and the step that the JAX loop takes at the top of its next iteration is
// taken here, at the end of this one, from the same numbers.
//
// gn_apply, 4 points a thread: the source points moved by P (R p + t) and,
// for GICP, the source covariances R C R^T in the six-entry layout, written
// for the next sweep; 16-byte loads and stores where the layout allows
// (every base 16-byte aligned, M a multiple of 4), else one point at a time.
// Each entry of a matrix product is the chain a matrix product's inner loop
// runs, fma(a2, b2, fma(a1, b1, a0 b0)) with explicit fused multiply-adds
// (PyTorch's matmul and einsum give those bits), then the translation added:
// the plain version is se3.transform_points and cuda_gicp.rotate_cov6.
//
// Built with -fmad=false, so no other product and sum is fused: gn_step's
// solve is bit-equal to solve6_plain, and its statistics and stop test are
// the chain's IEEE operations.  The retraction's sines and cosines are
// CUDA's, and se3.cuh's products round each term, where the chain's (W W,
// Rz Ry Rx, dT P) are cuBLAS's: the poses differ from the chain's in the
// last bits.
//
// What bounds them on this card: the launch.  gn_step moves ~260 bytes and
// does ~600 operations an element; gn_apply moves 12 (or 36) bytes in and
// out a point, ~1 MB at 16384 points, 0.3 us at 3.35 TB/s.  The step is
// one dependent chain on one thread (~10 IEEE divisions and square roots,
// the sines): its latency, not its work, is what a loop iteration pays.
#include <cuda_runtime.h>

#include "se3.cuh"
#include "solve6.cuh"

namespace {

constexpr int kStepThreads = 128;
constexpr int kApplyThreads = 128;
constexpr int kPer = 4;          // points a gn_apply thread

// The Euler-XYZ retraction: make_transform(Rz(x2) Ry(x1) Rx(x0), x[3:6]),
// the product taken left to right as (Rz Ry) Rx.
__device__ __forceinline__ void euler_xyz(const float x[6], float T[16]) {
  const float cr = cosf(x[0]), sr = sinf(x[0]);
  const float cp = cosf(x[1]), sp = sinf(x[1]);
  const float cy = cosf(x[2]), sy = sinf(x[2]);
  const float Rz[9] = {cy, -sy, 0.0f, sy, cy, 0.0f, 0.0f, 0.0f, 1.0f};
  const float Ry[9] = {cp, 0.0f, sp, 0.0f, 1.0f, 0.0f, -sp, 0.0f, cp};
  const float Rx[9] = {1.0f, 0.0f, 0.0f, 0.0f, cr, -sr, 0.0f, sr, cr};
  float A[9], R[9];
  se3::matmul3(Rz, Ry, A);
  se3::matmul3(A, Rx, R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = x[3 + i];
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

// gn_step's arguments: the sweep's output through its strides, the valid
// source points (nb = 0: one count for every element), the poses swept,
// the previous state (null at the start), the next state's buffers and the
// solve's 6-vectors (null: not asked for).
struct StepArgs {
  const float* out;
  long long ob, orow, ocol;
  const float* n_src;
  long long nb;
  const float* P;
  const float* fit;
  const float* rmse;
  const int* it;
  const unsigned char* done;
  float* T_out;
  float* P_out;
  float* fit_out;
  float* rmse_out;
  int* it_out;
  unsigned char* done_out;
  float* delta_out;
  int B, exp_retraction;
  float rel_fit, rel_rmse;
};

// The step of element b: its next poses (dT P, or P where done) into
// Pnext, and with write_state its state after the step into a's buffers.
__device__ __forceinline__ void step_element(const StepArgs& a, int b, bool write_state,
                                             float Pnext[16]) {
  const float* o = a.out + b * a.ob;
  float A[6][6], r[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = o[i * a.orow + j * a.ocol];
    r[i] = o[i * a.orow + 6 * a.ocol];
  }
  const float n_in = o[7 * a.orow], d2s = o[7 * a.orow + a.ocol];
  const float fitn = n_in / se3::clamp_min(a.n_src[b * a.nb], 1.0f);
  const float rmsen = sqrtf(d2s / se3::clamp_min(n_in, 1.0f));
  int itn = 0;
  bool donen = false;
  if (a.fit != nullptr) {               // an iteration, not the start
    const bool was = a.done[b] != 0;
    const bool conv =
        fabsf(a.fit[b] - fitn) < a.rel_fit && fabsf(a.rmse[b] - rmsen) < a.rel_rmse;
    itn = a.it[b] + (was ? 0 : 1);
    donen = was || conv;
  }
  float x[6], dT[16], Pb[16], Pn[16];
  gn::solve6(A, r, x);
  if (a.exp_retraction)
    se3::se3_exp(x, dT);
  else
    euler_xyz(x, dT);
#pragma unroll
  for (int k = 0; k < 16; ++k) Pb[k] = a.P[b * 16 + k];
  se3::matmul4(dT, Pb, Pn);
#pragma unroll
  for (int k = 0; k < 16; ++k) Pnext[k] = donen ? Pb[k] : Pn[k];
  if (!write_state) return;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a.T_out[b * 16 + k] = Pb[k];
    a.P_out[b * 16 + k] = Pnext[k];
  }
  a.fit_out[b] = fitn;
  a.rmse_out[b] = rmsen;
  a.it_out[b] = itn;
  a.done_out[b] = donen ? 1 : 0;
  if (a.delta_out != nullptr) {
#pragma unroll
    for (int i = 0; i < 6; ++i) a.delta_out[b * 6 + i] = x[i];
  }
}

__global__ void __launch_bounds__(kStepThreads) gn_step_kernel(const StepArgs a) {
  const int b = blockIdx.x * kStepThreads + threadIdx.x;
  if (b >= a.B) return;
  float Pnext[16];
  step_element(a, b, true, Pnext);
}

struct Pose {
  float R[9], t[3];
};

// a0 b0 + a1 b1 + a2 b2 as a matrix product's inner loop accumulates it:
// fma(a2, b2, fma(a1, b1, a0 b0)), one rounding a term.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
}

// R p + t: (p R^T) + t, as se3.transform_points.
__device__ __forceinline__ void move_point(const Pose& p, const float* in, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = dot3(in[0], p.R[i * 3], in[1], p.R[i * 3 + 1], in[2], p.R[i * 3 + 2]) + p.t[i];
}

// Entries [c00, c01, c02, c11, c12, c22] of R C R^T: RC = R C, then RC R^T,
// as cuda_gicp.rotate_cov6's two products.
__device__ __forceinline__ void rotate_cov(const Pose& p, const float* c, float* o) {
  const float C[9] = {c[0], c[1], c[2], c[1], c[3], c[4], c[2], c[4], c[5]};
  const float* R = p.R;
  float RC[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      RC[i * 3 + k] = dot3(R[i * 3], C[k], R[i * 3 + 1], C[3 + k], R[i * 3 + 2], C[6 + k]);
  constexpr int kI[6] = {0, 0, 0, 1, 1, 2}, kJ[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int i = kI[e], j = kJ[e];
    o[e] = dot3(RC[i * 3], R[j * 3], RC[i * 3 + 1], R[j * 3 + 1], RC[i * 3 + 2],
                R[j * 3 + 2]);
  }
}

template <int kWidth>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
#pragma unroll
  for (int k = 0; k < kWidth / 4; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + k);
    dst[4 * k] = v.x; dst[4 * k + 1] = v.y; dst[4 * k + 2] = v.z; dst[4 * k + 3] = v.w;
  }
}

template <int kWidth>
__device__ __forceinline__ void store_vec(const float* src, float* dst) {
#pragma unroll
  for (int k = 0; k < kWidth / 4; ++k)
    reinterpret_cast<float4*>(dst)[k] =
        make_float4(src[4 * k], src[4 * k + 1], src[4 * k + 2], src[4 * k + 3]);
}

// gn_apply's arguments: the source points and covariances (cov null: none;
// pb, cb the batch strides, 0 for one cloud that every pose shares), the
// outputs (B, M, 3) and (B, M, 6), and whether 16-byte accesses are allowed.
struct ApplyArgs {
  const float* pts;
  long long pb;
  const float* cov;
  long long cb;
  float* pts_out;
  float* cov_out;
  int M, vec;
};

// This thread's kPer points of element b, moved by the pose.
__device__ __forceinline__ void apply_points(const Pose& pose, const ApplyArgs& a, int b,
                                             int p0) {
  const int M = a.M;
  const float* pin = a.pts + b * a.pb + (long long)p0 * 3;
  float* pout = a.pts_out + ((long long)b * M + p0) * 3;
  const float* cin = a.cov == nullptr ? nullptr : a.cov + b * a.cb + (long long)p0 * 6;
  float* cout = a.cov_out == nullptr ? nullptr : a.cov_out + ((long long)b * M + p0) * 6;
  if (a.vec && p0 + kPer <= M) {
    float in[3 * kPer], o[3 * kPer];
    load_vec<3 * kPer>(pin, in);
#pragma unroll
    for (int k = 0; k < kPer; ++k) move_point(pose, in + 3 * k, o + 3 * k);
    store_vec<3 * kPer>(o, pout);
    if (cin != nullptr) {
      float c[6 * kPer], co[6 * kPer];
      load_vec<6 * kPer>(cin, c);
#pragma unroll
      for (int k = 0; k < kPer; ++k) rotate_cov(pose, c + 6 * k, co + 6 * k);
      store_vec<6 * kPer>(co, cout);
    }
    return;
  }
  const int n = M - p0 < kPer ? M - p0 : kPer;
  for (int k = 0; k < n; ++k) {
    float in[3], o[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) in[i] = pin[3 * k + i];
    move_point(pose, in, o);
#pragma unroll
    for (int i = 0; i < 3; ++i) pout[3 * k + i] = o[i];
    if (cin != nullptr) {
      float c[6], co[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i] = cin[6 * k + i];
      rotate_cov(pose, c, co);
#pragma unroll
      for (int i = 0; i < 6; ++i) cout[6 * k + i] = co[i];
    }
  }
}

__device__ __forceinline__ Pose pose_of(const float T[16]) {
  Pose pose;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) pose.R[i * 3 + j] = T[i * 4 + j];
    pose.t[i] = T[i * 4 + 3];
  }
  return pose;
}

__global__ void __launch_bounds__(kApplyThreads) gn_apply_kernel(const float* __restrict__ T,
                                                                 const ApplyArgs a) {
  const int b = blockIdx.y;
  const int p0 = (blockIdx.x * kApplyThreads + threadIdx.x) * kPer;
  if (p0 >= a.M) return;
  float Tb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tb[k] = __ldg(T + b * 16 + k);
  apply_points(pose_of(Tb), a, b, p0);
}

}  // namespace

extern "C" int gn_step_launch(const float* out, long long ob, long long orow, long long ocol,
                              const float* n_src, long long nb, const float* P,
                              const float* fit, const float* rmse, const int* it,
                              const unsigned char* done, float* T_out, float* P_out,
                              float* fit_out, float* rmse_out, int* it_out,
                              unsigned char* done_out, float* delta_out, int B,
                              int exp_retraction, float rel_fit, float rel_rmse,
                              void* stream) {
  const StepArgs a{out,   ob,      orow,     ocol,    n_src,    nb,        P,
                   fit,   rmse,    it,       done,    T_out,    P_out,     fit_out,
                   rmse_out, it_out, done_out, delta_out, B, exp_retraction, rel_fit,
                   rel_rmse};
  gn_step_kernel<<<(B + kStepThreads - 1) / kStepThreads, kStepThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int gn_apply_launch(const float* T, const float* pts, long long pb,
                               const float* cov, long long cb, float* pts_out, float* cov_out,
                               int B, int M, int vec, void* stream) {
  const int per_block = kApplyThreads * kPer;
  const dim3 grid((M + per_block - 1) / per_block, B);
  gn_apply_kernel<<<grid, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, ApplyArgs{pts, pb, cov, cb, pts_out, cov_out, M, vec});
  return (int)cudaGetLastError();
}
