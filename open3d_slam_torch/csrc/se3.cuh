// SE(3) and SO(3) maps on one thread, in float32, for the pose-graph
// kernels (pose_graph.cu).
//
// The formulas, branches and epsilons of open3d_slam_torch/utils/se3.py
// (so3_exp, so3_log, se3_exp, se3_log, inverse, hat), which are the JAX
// package's: the theta < 1e-5 and near-pi branches of so3_log, the small-theta
// series of se3_exp and se3_log, torch.clamp's handling of NaN (kept), and
// PyTorch's order of operations where it has one (left to right; a product
// of two matrices sums over k in ascending order).  Built with -fmad=false,
// so every product and sum rounds on its own as PyTorch's elementwise
// operations do; the transcendental functions are CUDA's, within a few ulp
// of the host's.  A pose is a row-major float[16], a rotation float[9].
#pragma once

#include <math.h>

namespace se3 {

constexpr float kEps = 1e-8f;

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.sign: -1, 0 or 1 (NaN stays NaN).
__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ void hat(const float w[3], float W[9]) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

__device__ __forceinline__ void matmul3(const float A[9], const float B[9], float C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = (A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j]) + A[i * 3 + 2] * B[6 + j];
}

__device__ __forceinline__ void matvec3(const float A[9], const float v[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = (A[i * 3] * v[0] + A[i * 3 + 1] * v[1]) + A[i * 3 + 2] * v[2];
}

__device__ __forceinline__ void matmul4(const float A[16], const float B[16], float C[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[i * 4 + j] = ((A[i * 4] * B[j] + A[i * 4 + 1] * B[4 + j]) + A[i * 4 + 2] * B[8 + j]) +
                     A[i * 4 + 3] * B[12 + j];
}

// make_transform(R^T, -(R^T t)): the inverse of a rigid transform.
__device__ __forceinline__ void inverse(const float T[16], float out[16]) {
  float Rt[9], t[3] = {T[3], T[7], T[11]}, u[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = T[j * 4 + i];
  matvec3(Rt, t, u);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = Rt[i * 3 + j];
    out[i * 4 + 3] = -u[i];
  }
  out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
}

__device__ __forceinline__ float sum_sq3(const float w[3]) {
  return (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
}

// Axis-angle of a rotation (row-major 3x3, read from a 4x4 pose T).
__device__ __forceinline__ void so3_log(const float T[16], float w[3]) {
  const float r00 = T[0], r01 = T[1], r02 = T[2], r10 = T[4], r11 = T[5], r12 = T[6],
              r20 = T[8], r21 = T[9], r22 = T[10];
  const float trace = (r00 + r11) + r22;
  const float ct = clamp((trace - 1.0f) * 0.5f, -1.0f, 1.0f);
  const float theta = acosf(ct);
  const float w_hat[3] = {0.5f * (r21 - r12), 0.5f * (r02 - r20), 0.5f * (r10 - r01)};
  const float s = sinf(theta);
  const float safe_sin = fabsf(s) < kEps ? kEps : s;
  const float scale = theta < 1e-5f ? 1.0f + (theta * theta) / 6.0f : theta / safe_sin;
  const float near_pi = static_cast<float>(3.141592653589793 - 1e-3);
  if (theta > near_pi) {
    const float diag[3] = {r00, r11, r22};
    const float sg[3] = {sign((r21 - r12) + kEps), sign((r02 - r20) + kEps),
                         sign((r10 - r01) + kEps)};
    const float den = (1.0f - ct) + kEps;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float axis = sqrtf(clamp_min((diag[i] - ct) / den, 0.0f));
      w[i] = (axis * sg[i]) * theta;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = w_hat[i] * scale;
  }
}

// (omega, v) of a rigid transform.
__device__ __forceinline__ void se3_log(const float T[16], float xi[6]) {
  float w[3];
  so3_log(T, w);
  const float theta2 = sum_sq3(w);
  const float theta = sqrtf(theta2 + kEps);
  float W[9], W2[9];
  hat(w, W);
  matmul3(W, W, W2);
  float cot = 1.0f / clamp_min(theta2, kEps) *
              (1.0f - (theta * sinf(theta)) / clamp_min(2.0f * (1.0f - cosf(theta)), kEps));
  if (theta2 < 1e-8f) cot = static_cast<float>(1.0 / 12.0) + theta2 / 720.0f;
  float Vinv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    Vinv[k] = (eye - 0.5f * W[k]) + cot * W2[k];
  }
  const float t[3] = {T[3], T[7], T[11]};
  float v[3];
  matvec3(Vinv, t, v);
  xi[0] = w[0]; xi[1] = w[1]; xi[2] = w[2];
  xi[3] = v[0]; xi[4] = v[1]; xi[5] = v[2];
}

// The rigid transform of xi = (omega, v).
__device__ __forceinline__ void se3_exp(const float xi[6], float T[16]) {
  const float w[3] = {xi[0], xi[1], xi[2]}, v[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = sum_sq3(w);
  const float theta = sqrtf(theta2 + kEps);
  const bool small = theta2 < 1e-8f;
  float W[9], W2[9];
  hat(w, W);
  matmul3(W, W, W2);
  const float st = sinf(theta), cth = cosf(theta);
  const float t2c = clamp_min(theta2, kEps);
  // so3_exp's a and b, then se3_exp's b and c.
  const float ra = small ? 1.0f - theta2 / 6.0f : st / theta;
  const float rb = small ? 0.5f - theta2 / 24.0f : (1.0f - cth) / t2c;
  const float vb = small ? 0.5f - theta2 / 24.0f : (1.0f - cth) / t2c;
  const float vc = small ? static_cast<float>(1.0 / 6.0) - theta2 / 120.0f
                         : (theta - st) / (t2c * theta);
  float R[9], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = (eye + ra * W[k]) + rb * W2[k];
    V[k] = (eye + vb * W[k]) + vc * W2[k];
  }
  float t[3];
  matvec3(V, v, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = t[i];
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

}  // namespace se3
