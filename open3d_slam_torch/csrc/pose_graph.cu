// The pose-graph LM step for Hopper (sm_90a): edge linearization, dense
// normal-equation assembly, retraction and accept.
//
// Replaces the XLA program of one LM step of the JAX package's pose-graph
// solve, open3d_slam_tpu/ops/pose_graph.py:110-162 (weights,
// build_normal_eqs, lm_step; no Pallas kernel there), which the port ran as
// dozens of eager torch operations an iteration (ops/cuda_pose_graph.py keeps
// them as the plain versions).  The dense Cholesky factor and solve between
// pg_assemble and pg_step stay with cuSOLVER (torch.linalg.cholesky_ex and
// torch.cholesky_solve at B = 1), as the JAX package leaves cho_factor and
// cho_solve to XLA.  Edge ends are read as ops/pose_graph.py hands them: a =
// edge_target, b = edge_source (Open3D's convention).
//
//   pg_linearize  one thread an edge: rel = X_a^-1 X_b, r = log(T^-1 rel),
//                 quad = r^T I r, w = mask ? (uncertain ? (mu/(mu+quad))^2 : 1)
//                 : 0, J = -Ad(rel^-1), lam = w I, H_ss = J^T lam J,
//                 H_st = J^T lam, H_tt = lam, b_s = J^T lam r, b_t = lam r,
//                 and the cost term w quad.
//   pg_assemble   one block a row block a of H (6 x 6N, in shared memory:
//                 18 KB at N = 128): the block walks the edge list in
//                 ascending order, keeps the edges incident to node a whose
//                 weight is not zero (an ordered compaction, a chunk of edges
//                 at a time; a zero weight makes every block of the edge +-0,
//                 which changes no sum that starts at +0, and the padding of
//                 a graph's capacity, all on node 0, would otherwise queue
//                 hundreds of edges on one block), and 36
//                 threads add their blocks, thread (i, j) owning every entry
//                 (i, c) with c % 6 == j, so each entry is summed by one
//                 thread in ascending edge order; then H + prior on the
//                 diagonal, + damping diag(H), and b.  One more block sums
//                 the cost terms: each thread its strided share in order,
//                 then a fixed tree.
//   pg_step       one block: X_new[n] = X[n] exp(delta_n), the cost at X_new
//                 with the same weights (the same strided shares and tree as
//                 pg_assemble's, so X_new == X gives the same cost), accept =
//                 cost_new < cost, X = accept ? X_new : X, damping =
//                 clamp(accept ? damping / 2 : 4 damping, 1e-9, 1e6).
//
// No float atomics anywhere: every sum has a fixed order, so two runs give the
// same bits (the pipelined and sequential replays must agree bit for bit).
// Built with -fmad=false: each product and sum rounds on its own.
//
// What bounds them on this card: nothing but latency.  pg_assemble writes
// (6N)^2 floats (2.36 MB at N = 128: ~0.7 us at 3.35 TB/s) and reads E x 122
// floats; pg_linearize reads and writes ~1 KB an edge and does ~2,000 float
// operations; pg_step one pass over the nodes and one over the edges.  At N =
// 128, E = 512 each is a few microseconds of dependent loads and one or a
// few blocks; a CUDA graph of the whole solve (ops/gn_graph.py) removes the
// host's launch cost around them.
#include <cuda_runtime.h>

#include "se3.cuh"

namespace {

constexpr int kLinThreads = 128;
constexpr int kSumThreads = 512;   // the cost sums of pg_assemble and pg_step

__device__ __forceinline__ void load16(const float* __restrict__ p, float out[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = p[k];
}

// r = log(T^-1 X_a^-1 X_b) and quad = r^T I r (I row-major 6x6).
__device__ __forceinline__ float edge_residual(const float* __restrict__ X, long long a,
                                               long long b, const float* __restrict__ T,
                                               const float* __restrict__ info, float r[6],
                                               float rel[16]) {
  float Xa[16], Xb[16], Xa_inv[16], Tm[16], T_inv[16], err[16];
  load16(X + a * 16, Xa);
  load16(X + b * 16, Xb);
  load16(T, Tm);
  se3::inverse(Xa, Xa_inv);
  se3::matmul4(Xa_inv, Xb, rel);
  se3::inverse(Tm, T_inv);
  se3::matmul4(T_inv, rel, err);
  se3::se3_log(err, r);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = s + info[i * 6 + j] * r[j];
    q = q + r[i] * s;
  }
  return q;
}

__global__ void __launch_bounds__(kLinThreads) pg_linearize_kernel(
    const float* __restrict__ X, const long long* __restrict__ e_a,
    const long long* __restrict__ e_b, const float* __restrict__ e_T,
    const float* __restrict__ e_info, const bool* __restrict__ e_unc,
    const bool* __restrict__ e_mask, const float* __restrict__ mu_p, float* __restrict__ r_out,
    float* __restrict__ w_out, float* __restrict__ hss, float* __restrict__ hst,
    float* __restrict__ htt, float* __restrict__ bs, float* __restrict__ bt,
    float* __restrict__ cost_out, int E) {
  const int e = blockIdx.x * kLinThreads + threadIdx.x;
  if (e >= E) return;
  const float* info = e_info + (long long)e * 36;
  float r[6], rel[16];
  const float quad = edge_residual(X, e_a[e], e_b[e], e_T + (long long)e * 16, info, r, rel);
  const float mu = *mu_p;
  const float x = mu / (mu + quad);
  float w = e_unc[e] ? x * x : 1.0f;
  w = e_mask[e] ? w : 0.0f;
  // J = -Ad(rel^-1) = -[[R, 0], [[t]x R, R]] of rel^-1.
  float ri[16];
  se3::inverse(rel, ri);
  float R[9], tx[9], txR[9];
  const float t[3] = {ri[3], ri[7], ri[11]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = ri[i * 4 + j];
  se3::hat(t, tx);
  se3::matmul3(tx, R, txR);
  float J[36];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J[i * 6 + j] = -R[i * 3 + j];
      J[i * 6 + 3 + j] = -0.0f;
      J[(i + 3) * 6 + j] = -txR[i * 3 + j];
      J[(i + 3) * 6 + 3 + j] = -R[i * 3 + j];
    }
  float lam[36];
#pragma unroll
  for (int k = 0; k < 36; ++k) lam[k] = info[k] * w;
  float* Hss = hss + (long long)e * 36;
  float* Hst = hst + (long long)e * 36;
  float* Htt = htt + (long long)e * 36;
  // M = lam J, then H_ss = J^T M; H_st = J^T lam; b_t = lam r; b_s = J^T b_t.
  float M[36], lr[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < 6; ++l) s = s + lam[k * 6 + l] * J[l * 6 + j];
      M[k * 6 + j] = s;
    }
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < 6; ++l) s = s + lam[k * 6 + l] * r[l];
    lr[k] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float s = 0.0f, u = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        s = s + J[k * 6 + i] * M[k * 6 + j];
        u = u + J[k * 6 + i] * lam[k * 6 + j];
      }
      Hss[i * 6 + j] = s;
      Hst[i * 6 + j] = u;
      Htt[i * 6 + j] = lam[i * 6 + j];
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s = s + J[k * 6 + i] * lr[k];
    bs[(long long)e * 6 + i] = s;
    bt[(long long)e * 6 + i] = lr[i];
    r_out[(long long)e * 6 + i] = r[i];
  }
  w_out[e] = w;
  cost_out[e] = w * quad;
}

// The fixed-order sum of a block: each thread's strided share in ascending
// order, then a tree over kSumThreads (a power of two).  Every thread gets
// the total.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kSumThreads) pg_assemble_kernel(
    const float* __restrict__ hss, const float* __restrict__ hst,
    const float* __restrict__ htt, const float* __restrict__ bs,
    const float* __restrict__ bt, const float* __restrict__ cost_terms,
    const float* __restrict__ w, const long long* __restrict__ e_a,
    const long long* __restrict__ e_b, const float* __restrict__ prior,
    const float* __restrict__ damping_p, float* __restrict__ H, float* __restrict__ b_out,
    float* __restrict__ cost_out, int N, int E) {
  extern __shared__ float strip[];                 // [6][6N], then the edge list
  __shared__ int incident[kSumThreads];
  __shared__ int warp_count[kSumThreads / 32];
  __shared__ float sums[kSumThreads];
  const int tid = threadIdx.x;
  const int a = blockIdx.x;
  if (a == N) {                                    // the cost block
    float acc = 0.0f;
    for (int e = tid; e < E; e += kSumThreads) acc = acc + cost_terms[e];
    const float total = block_sum(acc, sums);
    if (tid == 0) *cost_out = total;
    return;
  }
  const int cols = 6 * N;
  for (int k = tid; k < 6 * cols; k += kSumThreads) strip[k] = 0.0f;
  const int i = tid / 6, j = tid % 6;              // the worker threads: tid < 36
  float bacc = 0.0f;
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = 0; base < E; base += kSumThreads) {
    const int e = base + tid;
    bool hit = false;
    if (e < E) hit = (e_a[e] == a || e_b[e] == a) && w[e] != 0.0f;
    // Ordered compaction of this chunk's incident edges.
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < kSumThreads / 32; ++w) {
      if (w < warp) offset += warp_count[w];
      total += warp_count[w];
    }
    if (hit) incident[offset + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();
    if (tid < 36) {
      for (int k = 0; k < total; ++k) {
        const int f = incident[k];
        const int s = (int)e_a[f], t = (int)e_b[f];
        const long long o = (long long)f * 36;
        if (s == a) {
          strip[i * cols + s * 6 + j] = strip[i * cols + s * 6 + j] + hss[o + i * 6 + j];
          strip[i * cols + t * 6 + j] = strip[i * cols + t * 6 + j] + hst[o + i * 6 + j];
          if (j == 0) bacc = bacc + bs[(long long)f * 6 + i];
        }
        if (t == a) {
          strip[i * cols + s * 6 + j] = strip[i * cols + s * 6 + j] + hst[o + j * 6 + i];
          strip[i * cols + t * 6 + j] = strip[i * cols + t * 6 + j] + htt[o + i * 6 + j];
          if (j == 0) bacc = bacc + bt[(long long)f * 6 + i];
        }
      }
    }
    __syncthreads();
  }
  if (tid < 36 && j == 0) b_out[a * 6 + i] = bacc;
  const float damping = *damping_p, p = prior[a];
  for (int k = tid; k < 6 * cols; k += kSumThreads) {
    const int row = k / cols, c = k % cols;
    float h;
    if (c == a * 6 + row) {
      h = strip[k] + p;
      h = h + damping * h;
    } else {
      h = strip[k] + 0.0f;                         // as adding the zero diagonal
    }
    H[(long long)(a * 6 + row) * cols + c] = h;
  }
}

__global__ void __launch_bounds__(kSumThreads) pg_step_kernel(
    const float* __restrict__ X, const float* __restrict__ delta,
    const long long* __restrict__ e_a, const long long* __restrict__ e_b,
    const float* __restrict__ e_T, const float* __restrict__ e_info,
    const float* __restrict__ w, const float* __restrict__ cost_p,
    const float* __restrict__ damping_p, float* __restrict__ X_out,
    float* __restrict__ damping_out, int N, int E) {
  __shared__ float sums[kSumThreads];
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += kSumThreads) {
    float xi[6], D[16], Xn[16], Xo[16];
#pragma unroll
    for (int k = 0; k < 6; ++k) xi[k] = delta[n * 6 + k];
    se3::se3_exp(xi, D);
    load16(X + (long long)n * 16, Xo);
    se3::matmul4(Xo, D, Xn);
#pragma unroll
    for (int k = 0; k < 16; ++k) X_out[(long long)n * 16 + k] = Xn[k];
  }
  __syncthreads();
  float acc = 0.0f;
  for (int e = tid; e < E; e += kSumThreads) {
    float r[6], rel[16];
    const float quad = edge_residual(X_out, e_a[e], e_b[e], e_T + (long long)e * 16,
                                     e_info + (long long)e * 36, r, rel);
    acc = acc + w[e] * quad;
  }
  const float cost_new = block_sum(acc, sums);
  const bool accept = cost_new < *cost_p;
  if (!accept)
    for (int k = tid; k < N * 16; k += kSumThreads) X_out[k] = X[k];
  if (tid == 0) {
    const float d = *damping_p;
    *damping_out = se3::clamp(accept ? d * 0.5f : d * 4.0f, 1e-9f, 1e6f);
  }
}

}  // namespace

extern "C" int pg_linearize_launch(const float* X, const long long* e_a,
                                   const long long* e_b, const float* e_T,
                                   const float* e_info, const bool* e_unc,
                                   const bool* e_mask, const float* mu, float* r,
                                   float* w, float* hss, float* hst, float* htt, float* bs,
                                   float* bt, float* cost, int N, int E, void* stream) {
  (void)N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pg_linearize_kernel<<<(E + kLinThreads - 1) / kLinThreads, kLinThreads, 0, st>>>(
      X, e_a, e_b, e_T, e_info, e_unc, e_mask, mu, r, w, hss, hst, htt, bs, bt, cost, E);
  return (int)cudaGetLastError();
}

extern "C" int pg_assemble_launch(const float* hss, const float* hst, const float* htt,
                                  const float* bs, const float* bt, const float* cost_terms,
                                  const float* w, const long long* e_a, const long long* e_b,
                                  const float* prior, const float* damping, float* H,
                                  float* b, float* cost, int N, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 36 * (size_t)N;
  if (smem + 8 * 1024 > 48 * 1024) {               // beside ~4.2 KB of static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        pg_assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();                          // not left for the next launch's check
      return (int)err;
    }
  }
  pg_assemble_kernel<<<N + 1, kSumThreads, smem, st>>>(hss, hst, htt, bs, bt, cost_terms,
                                                       w, e_a, e_b, prior, damping, H, b,
                                                       cost, N, E);
  return (int)cudaGetLastError();
}

extern "C" int pg_step_launch(const float* X, const float* delta, const long long* e_a,
                              const long long* e_b, const float* e_T, const float* e_info,
                              const float* w, const float* cost, const float* damping,
                              float* X_out, float* damping_out, int N, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pg_step_kernel<<<1, kSumThreads, 0, st>>>(X, delta, e_a, e_b, e_T, e_info, w, cost,
                                            damping, X_out, damping_out, N, E);
  return (int)cudaGetLastError();
}
