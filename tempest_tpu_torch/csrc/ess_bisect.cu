// ESS-mode temperature bisection for Hopper (sm_90a), one launch per reweight.
//
// Replaces: tempest_tpu/ops/pallas_reweight.py `_kernel` (entry
// `ess_bisect_beta`), which holds logl and the masked MIS denominator Bm in
// TPU VMEM and runs the whole bisection there.
//
// What it computes, for x = beta * logl - Bm:
//   ESS(beta) = s1^2 / s2,  s1 = sum exp(x - m),  s2 = sum exp(2 (x - m)).
// Stay at beta_prev if ESS(beta_prev) <= target; jump to 1 if
// ESS(1) >= target; otherwise bisect on [beta_prev, 1] until
// |ESS - target| < max(0.01 |target|, 0.5), or the bracket is below
// max(1e-8, 1e-4) * max(|lo|, |hi|, 1e-38), or beta == 1, or 200 probes.
// A non-finite ESS counts as 1e10. One deliberate difference from the
// Pallas kernel: x = -inf wherever logl is not finite or Bm = +inf (as in
// tempest_tpu/state.py:392-394), so unfilled history slots weigh nothing at
// beta = 0 instead of turning ESS(beta_prev) into NaN.
//
// What bounds it: every probe reads logl and Bm once (8 bytes per sample:
// 512 KB at the canonical S = 65,536), and the probes form a serial chain
// of 30-60 dependent passes. The data fits in the 50 MB L2, so a probe is
// bound by the L2 bandwidth into ONE SM plus a block-wide reduction, and
// the chain by its length; device-memory bandwidth is not the limit.
//
// What the design does about it: one block of 1024 threads runs the whole
// chain in one launch, so the host never syncs between probes (the plain
// PyTorch version syncs once per probe). Each thread strides over S with
// coalesced loads and keeps a running (max, s1, s2) that it rescales when
// the max grows, so a probe is one pass. Warps combine by shuffles, the 32
// warp results by one more warp, and thread 0 decides lo, hi, done and the
// next beta and broadcasts them through shared memory; every __syncthreads
// sits in block-uniform control flow. Later work can spread a probe over a
// thread-block cluster (64 KB slices in distributed shared memory) or keep
// each thread's slice in registers across probes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// tempest_tpu/config.py:20-28
constexpr float kBetaTolerance = 1e-4f;
constexpr float kBetaRtol = 1e-8f;
constexpr float kEssTolerance = 0.01f;
constexpr float kMetricAtol = 0.5f;
constexpr int kMaxBisectionIterations = 200;
constexpr float kNonFiniteMetric = 1e10f;

__device__ __forceinline__ bool is_finite(float v) { return fabsf(v) < INFINITY; }  // false for NaN

struct Acc {
  float m;   // running max of x
  float s1;  // sum exp(x - m)
  float s2;  // sum exp(2 (x - m))
};

__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;  // both empty
  const float ca = (a.m == -INFINITY) ? 0.f : expf(a.m - m);
  const float cb = (b.m == -INFINITY) ? 0.f : expf(b.m - m);
  Acc out;
  out.m = m;
  out.s1 = a.s1 * ca + b.s1 * cb;
  out.s2 = a.s2 * (ca * ca) + b.s2 * (cb * cb);
  return out;
}

__device__ __forceinline__ Acc warp_reduce(Acc a) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    Acc b;
    b.m = __shfl_xor_sync(kFullMask, a.m, offset);
    b.s1 = __shfl_xor_sync(kFullMask, a.s1, offset);
    b.s2 = __shfl_xor_sync(kFullMask, a.s2, offset);
    a = combine(a, b);
  }
  return a;
}

// ESS at `beta` over all S samples. Must be called by every thread of the
// block; returns the same value to all of them.
__device__ float block_ess(const float* __restrict__ logl, const float* __restrict__ bm,
                           int64_t n, float beta, Acc* part, float* result) {
  Acc a;
  a.m = -INFINITY;
  a.s1 = 0.f;
  a.s2 = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float l = logl[i];
    const float b = bm[i];
    if (!is_finite(l) || b == INFINITY) continue;  // zero weight
    const float x = beta * l - b;
    if (x > a.m) {
      const float c = (a.m == -INFINITY) ? 0.f : expf(a.m - x);
      a.s1 = a.s1 * c + 1.f;
      a.s2 = a.s2 * (c * c) + 1.f;
      a.m = x;
    } else {
      const float e = expf(x - a.m);
      a.s1 += e;
      a.s2 += e * e;
    }
  }
  a = warp_reduce(a);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    Acc w = part[lane];  // kWarps == 32: one partial per lane
    w = warp_reduce(w);
    if (lane == 0) *result = (w.s1 * w.s1) / w.s2;  // all empty: 0/0 = NaN
  }
  __syncthreads();
  return *result;
}

__device__ __forceinline__ float interval_tol(float lo, float hi) {
  const float scale = fmaxf(fmaxf(fabsf(lo), fabsf(hi)), 1e-38f);
  return fmaxf(kBetaRtol * scale, kBetaTolerance * scale);
}

__global__ void __launch_bounds__(kThreads)
ess_bisect_kernel(const float* __restrict__ logl, const float* __restrict__ bm,
                  const float* __restrict__ scal, float* __restrict__ beta_out,
                  int32_t* __restrict__ probes_out, int64_t n) {
  static_assert(kWarps == 32, "the second reduction stage needs one lane per warp");
  __shared__ Acc part[kWarps];
  __shared__ float result;
  __shared__ float sh_lo, sh_hi, sh_beta;
  __shared__ int sh_done, sh_iter;

  const float beta_prev = scal[0];
  const float target = scal[1];
  const float ess_cur = block_ess(logl, bm, n, beta_prev, part, &result);
  const float ess_one = block_ess(logl, bm, n, 1.f, part, &result);

  if (threadIdx.x == 0) {
    sh_lo = beta_prev;
    sh_hi = 1.f;
    sh_beta = 0.5f * (beta_prev + 1.f);
    sh_done = (ess_cur <= target) || (ess_one >= target);
    sh_iter = 0;
  }
  __syncthreads();

  while (!sh_done) {  // block-uniform: read after a barrier
    float metric = block_ess(logl, bm, n, sh_beta, part, &result);
    if (threadIdx.x == 0) {
      const float beta = sh_beta;
      float lo = sh_lo;
      float hi = sh_hi;
      if (!is_finite(metric)) metric = kNonFiniteMetric;
      const bool metric_conv =
          fabsf(metric - target) < fmaxf(kEssTolerance * fabsf(target), kMetricAtol);
      const bool beta_conv = (hi - lo) < interval_tol(lo, hi);
      const bool done = metric_conv || beta_conv || (beta == 1.f);
      const bool go_up = metric >= target;  // ESS decreases with beta
      if (!done && go_up) lo = beta;
      if (!done && !go_up) hi = beta;
      const int iter = sh_iter + 1;
      sh_iter = iter;
      sh_lo = lo;
      sh_hi = hi;
      sh_done = done || iter >= kMaxBisectionIterations;
      if (!sh_done) sh_beta = 0.5f * (lo + hi);  // else keep the last probe
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    float beta = sh_beta;
    if (ess_cur <= target) {
      beta = beta_prev;
    } else if (ess_one >= target) {
      beta = 1.f;
    }
    beta_out[0] = beta;
    probes_out[0] = 2 + sh_iter;
  }
}

}  // namespace

// C entry point, loaded with ctypes. logl and bm: (n,) float32; scal: (2,)
// float32 = (beta_prev, target); beta: (1,) float32 out; probes: (1,) int32
// out (ESS evaluations). Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int tempest_ess_bisect(const void* logl, const void* bm, const void* scal,
                                  void* beta, void* probes, int64_t n, void* stream) {
  ess_bisect_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logl), static_cast<const float*>(bm),
      static_cast<const float*>(scal), static_cast<float*>(beta),
      static_cast<int32_t*>(probes), n);
  return static_cast<int>(cudaGetLastError());
}
