// The Gauss-Newton step folded into the point apply, for Hopper (sm_90a): a
// design measured against the two launches of csrc/gn_step.cu by
// cli/gn_split.py --fold, not a kernel of the port.
//
// One launch does what gn_step and then gn_apply (at the poses gn_step
// returns) do: a grid of (ceil(M / 512), B) blocks of 128 threads, as
// gn_apply's.  Thread 0 of each block takes its element's step on its own
// (step_element, the same code as gn_step; every block of an element
// repeats it, block 0 alone writes the state), hands the next poses to the
// block through shared memory, and the block moves its 512 points (and
// covariances) to them (apply_points, the same code as gn_apply).  So one
// iteration of a loop is the sweep and this kernel, and the results are
// gn_step's and gn_apply's bits.
//
// Built by cli/gn_split.py into _build/split/ with -I csrc and the flags of
// ops/cuda_build.py.
#include "gn_step.cu"

namespace {

__global__ void __launch_bounds__(kApplyThreads) gn_fold_kernel(const StepArgs s,
                                                                const ApplyArgs a) {
  __shared__ float next[16];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) {
    float Pnext[16];
    step_element(s, b, blockIdx.x == 0, Pnext);
#pragma unroll
    for (int k = 0; k < 16; ++k) next[k] = Pnext[k];
  }
  __syncthreads();
  const int p0 = (blockIdx.x * kApplyThreads + threadIdx.x) * kPer;
  if (p0 >= a.M) return;
  float Tb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tb[k] = next[k];
  apply_points(pose_of(Tb), a, b, p0);
}

}  // namespace

extern "C" int gn_fold_launch(const float* out, long long ob, long long orow, long long ocol,
                              const float* n_src, long long nb, const float* P,
                              const float* fit, const float* rmse, const int* it,
                              const unsigned char* done, float* T_out, float* P_out,
                              float* fit_out, float* rmse_out, int* it_out,
                              unsigned char* done_out, int B, int exp_retraction,
                              float rel_fit, float rel_rmse, const float* pts, long long pb,
                              const float* cov, long long cb, float* pts_out,
                              float* cov_out, int M, int vec, void* stream) {
  const StepArgs s{out,   ob,      orow,     ocol,    n_src,   nb,      P,
                   fit,   rmse,    it,       done,    T_out,   P_out,   fit_out,
                   rmse_out, it_out, done_out, nullptr, B, exp_retraction, rel_fit,
                   rel_rmse};
  const int per_block = kApplyThreads * kPer;
  const dim3 grid((M + per_block - 1) / per_block, B);
  gn_fold_kernel<<<grid, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, ApplyArgs{pts, pb, cov, cb, pts_out, cov_out, M, vec});
  return (int)cudaGetLastError();
}
