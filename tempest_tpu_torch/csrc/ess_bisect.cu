// ESS-mode temperature bisection for Hopper (sm_90a): the whole bisection in
// one launch of one thread-block cluster.
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
// What bounds it on this card: not the bytes (8 per sample, 512 KB at the
// canonical S = 65,536, read once) and not the arithmetic (one exp per sample
// and probe), but the chain: 10-60 probes, each a reduction over all S
// samples whose result decides the next probe's beta. A probe costs the
// latency of one pass, one reduction and one decision. One block on one SM
// (the first design) spent ~18.5 us a probe at S = 65,536, re-reading the
// history from L2 through a serial running-max chain per thread.
//
// What this design does about it:
//  - One launch of one cluster of kCluster = 16 CTAs (a non-portable size;
//    cudaOccupancyMaxActiveClusters confirms it fits, once per device, else
//    the launcher returns an error and the wrapper raises). CTA r owns the
//    contiguous slice [r L, (r + 1) L) of the samples, L a multiple of 4.
//  - Resident route (8 L bytes fit the CTA's shared memory): the slice is
//    loaded once, masked once (a dropped sample becomes logl 0, Bm +inf, so
//    x = -inf with no test), and every probe reads shared memory only.
//    Streamed route (larger S): every probe reads the slice from L2 with
//    16-byte loads and masks it with a select. The wrapper picks the route
//    by S. Forced onto the same S, streaming costs 21 % more a pass at
//    S = 65,536 and 42 % more at 393,216 (PERF.md), so the resident route
//    stays. Its load is plain 16-byte loads, not TMA or cp.async: the whole
//    one-time load costs at most 0.8 us of a 26 us launch at 65,536 and
//    3.7 us of 89 us at 393,216, which bounds what a bulk copy could save.
//  - A probe is branch-light: a thread takes each group of 4 samples into
//    registers, takes their max, rescales its sums at most once per group,
//    then adds exp(x - m) and its square. Warps, the CTA and the cluster
//    combine their (m, s1, s2) the same way: the max by shuffles, one
//    rescale exp(m - M) per lane, then plain sums by shuffles, so no exp
//    sits inside the reduction tree.
//  - One decision per probe through distributed shared memory: each CTA
//    writes its partials into its own shared memory, the cluster syncs once,
//    and warp 0 of EVERY CTA reads the 16 partials of the cluster in rank
//    order, combines them in the same fixed order and takes the same
//    decision. That replaces "rank 0 decides, sync again, all read rank 0"
//    by one cluster barrier a probe. No atomics, so beta is deterministic.
//    Partials are double-buffered by probe parity, so a CTA never overwrites
//    a buffer another CTA may still read; a last cluster barrier keeps every
//    CTA alive until no one reads its shared memory.
//  - The first pass evaluates beta_prev, 1 and the first midpoint together.
//    Evaluating the next two or three levels of the bisection tree a pass
//    (3 or 7 betas, walked as the serial bisection would) was measured and
//    not kept: no gain at S = 65,536, 6-12 % at streamed sizes (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCluster = 16;  // CTAs in the cluster, one slice each
constexpr int kMaxDevices = 64;
// Samples a CTA holds in shared memory on the resident route (192 KB);
// tempest_tpu_torch/ops/cuda_reweight.py plans the routes with this number.
constexpr int64_t kSliceMax = 24576;

// tempest_tpu/config.py:20-28
constexpr float kBetaTolerance = 1e-4f;
constexpr float kBetaRtol = 1e-8f;
constexpr float kEssTolerance = 0.01f;
constexpr float kMetricAtol = 0.5f;
constexpr int kMaxBisectionIterations = 200;
constexpr float kNonFiniteMetric = 1e10f;

__device__ __forceinline__ bool is_finite(float v) { return fabsf(v) < INFINITY; }  // false for NaN

struct Acc {
  float m;   // max of x
  float s1;  // sum exp(x - m)
  float s2;  // sum exp(2 (x - m))
};

__device__ __forceinline__ Acc empty_acc() { return Acc{-INFINITY, 0.f, 0.f}; }

// Combines the NB partials of every lane of the warp, for each beta at
// once; every lane gets the totals. Max first (shuffles of fmaxf), then one
// rescale per lane, exp(m - M), then plain sums: no exp inside the tree.
template <int NB>
__device__ __forceinline__ void warp_combine(Acc (&a)[NB]) {
  float M[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) M[k] = a[k].m;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int k = 0; k < NB; ++k) M[k] = fmaxf(M[k], __shfl_xor_sync(kFullMask, M[k], offset));
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float c = (a[k].m == -INFINITY) ? 0.f : expf(a[k].m - M[k]);  // M = -inf: all empty
    a[k].m = M[k];
    a[k].s1 *= c;
    a[k].s2 *= c * c;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      a[k].s1 += __shfl_xor_sync(kFullMask, a[k].s1, offset);
      a[k].s2 += __shfl_xor_sync(kFullMask, a[k].s2, offset);
    }
  }
}

// Adds 4 values of x to `a`: one max, at most one rescale, then the sums.
__device__ __forceinline__ void add4(Acc& a, const float x[4]) {
  const float cm = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  if (cm > a.m) {
    const float c = (a.m == -INFINITY) ? 0.f : expf(a.m - cm);
    a.s1 *= c;
    a.s2 *= c * c;
    a.m = cm;
  }
  if (a.m != -INFINITY) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = expf(x[j] - a.m);
      a.s1 += e;
      a.s2 += e * e;
    }
  }
}

// The CTA's slice: samples [begin, end) of the input, `quads` groups of 4.
struct Slice {
  const float* __restrict__ logl;
  const float* __restrict__ bm;
  int64_t begin, end;
  int quads;
  bool aligned;  // both pointers 16-byte aligned
};

// Group q of the slice, from device memory; samples past the slice end read
// as dropped (logl 0, Bm +inf), so x = -inf for them.
__device__ __forceinline__ void load4(const Slice& s, int q, float l[4], float b[4]) {
  const int64_t i = s.begin + 4 * static_cast<int64_t>(q);
  if (s.aligned && i + 4 <= s.end) {
    const float4 l4 = __ldg(reinterpret_cast<const float4*>(s.logl + i));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(s.bm + i));
    l[0] = l4.x; l[1] = l4.y; l[2] = l4.z; l[3] = l4.w;
    b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < s.end;
      l[j] = in ? s.logl[i + j] : 0.f;
      b[j] = in ? s.bm[i + j] : INFINITY;
    }
  }
}

// The mask, applied to raw values: a sample whose logl is not finite or
// whose Bm is +inf becomes (0, +inf).
__device__ __forceinline__ void mask4(float l[4], float b[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool keep = is_finite(l[j]) && b[j] != INFINITY;
    l[j] = keep ? l[j] : 0.f;
    b[j] = keep ? b[j] : INFINITY;
  }
}

// Adds one group of 4 masked samples to the partials at each of the NB betas.
template <int NB>
__device__ __forceinline__ void add_group(Acc (&acc)[NB], const float (&beta)[NB],
                                          const float l[4], const float b[4]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = beta[k] * l[j] - b[j];  // dropped: 0 - inf
    add4(acc[k], x);
  }
}

// One pass: the CTA's partial (m, s1, s2) at each of the NB betas into
// `mine[0..NB)`. Every thread of the CTA calls it.
template <int NB, bool kResident>
__device__ void pass(const Slice& s, const float4* __restrict__ sl, const float4* __restrict__ sb,
                     const float* betas, Acc (*part)[kWarps], Acc* mine) {
  Acc acc[NB];
  float beta[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    acc[k] = empty_acc();
    beta[k] = betas[k];
  }
  for (int q = threadIdx.x; q < s.quads; q += kThreads) {
    float l[4], b[4];
    if (kResident) {
      const float4 l4 = sl[q], b4 = sb[q];
      l[0] = l4.x; l[1] = l4.y; l[2] = l4.z; l[3] = l4.w;
      b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
    } else {
      load4(s, q, l, b);
      mask4(l, b);
    }
    add_group<NB>(acc, beta, l, b);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_combine<NB>(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) part[k][warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) acc[k] = part[k][lane];  // kWarps == 32: one partial per lane
    warp_combine<NB>(acc);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NB; ++k) mine[k] = acc[k];
    }
  }
}

__device__ __forceinline__ float interval_tol(float lo, float hi) {
  const float scale = fmaxf(fmaxf(fabsf(lo), fabsf(hi)), 1e-38f);
  return fmaxf(kBetaRtol * scale, kBetaTolerance * scale);
}

// The bisection's state, held by every CTA (written by its thread 0).
struct Control {
  float lo, hi, beta;  // beta: the next probe, or the result once stopped
  int iter;            // bisection probes so far
  int stop;
  float first[3];      // the first pass's betas: beta_prev, 1, the first midpoint
};

// One step of the serial bisection on the ESS at c.beta: the stop rules,
// the bracket update and the next probe, as tempest_tpu's bisection.
__device__ __forceinline__ void step(Control& c, float metric, float target) {
  if (!is_finite(metric)) metric = kNonFiniteMetric;
  const bool metric_conv =
      fabsf(metric - target) < fmaxf(kEssTolerance * fabsf(target), kMetricAtol);
  const bool beta_conv = (c.hi - c.lo) < interval_tol(c.lo, c.hi);
  const bool done = metric_conv || beta_conv || (c.beta == 1.f);
  const bool go_up = metric >= target;  // ESS decreases with beta
  if (!done && go_up) c.lo = c.beta;
  if (!done && !go_up) c.hi = c.beta;
  c.iter += 1;
  c.stop = done || c.iter >= kMaxBisectionIterations;
  if (!c.stop) c.beta = 0.5f * (c.lo + c.hi);  // else keep the last probe
}

// Warp 0 of this CTA: the cluster's combined partials at NB betas, as ESS,
// read from every CTA's `mine` in rank order.
template <int NB>
__device__ void gather(const cg::cluster_group& cluster, Acc* mine, float* ess) {
  const int lane = threadIdx.x & 31;
  const int ranks = static_cast<int>(cluster.num_blocks());
  Acc a[NB];
  const Acc* remote = lane < ranks ? cluster.map_shared_rank(mine, lane) : nullptr;
#pragma unroll
  for (int k = 0; k < NB; ++k) a[k] = remote ? remote[k] : empty_acc();
  warp_combine<NB>(a);
#pragma unroll
  for (int k = 0; k < NB; ++k) ess[k] = (a[k].s1 * a[k].s1) / a[k].s2;  // all dropped: 0/0 = NaN
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
ess_bisect_kernel(const float* __restrict__ logl, const float* __restrict__ bm,
                  const float* __restrict__ scal, float* __restrict__ beta_out,
                  int32_t* __restrict__ probes_out, int64_t n, int64_t slice) {
  static_assert(kWarps == 32, "the second reduction stage needs one lane per warp");
  extern __shared__ float4 dyn[];  // resident route: the masked slice
  __shared__ Acc part[3][kWarps];
  __shared__ Acc mine[2][3];  // this CTA's partials, by probe parity
  __shared__ Control ctl;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  Slice s;
  s.logl = logl;
  s.bm = bm;
  s.begin = min(static_cast<int64_t>(rank) * slice, n);
  s.end = min(s.begin + slice, n);
  s.quads = static_cast<int>(slice / 4);
  s.aligned = ((reinterpret_cast<uintptr_t>(logl) | reinterpret_cast<uintptr_t>(bm)) & 15) == 0;
  float4* sl = dyn;
  float4* sb = dyn + s.quads;
  if (kResident) {
    for (int q = threadIdx.x; q < s.quads; q += kThreads) {
      float l[4], b[4];
      load4(s, q, l, b);
      mask4(l, b);
      sl[q] = make_float4(l[0], l[1], l[2], l[3]);
      sb[q] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
  const float beta_prev = scal[0];
  const float target = scal[1];
  if (threadIdx.x == 0) {
    ctl.lo = beta_prev;
    ctl.hi = 1.f;
    ctl.beta = 0.5f * (beta_prev + 1.f);
    ctl.iter = 0;
    ctl.stop = 0;
    ctl.first[0] = beta_prev;
    ctl.first[1] = 1.f;
    ctl.first[2] = ctl.beta;
  }
  __syncthreads();

  // Pass 0: beta_prev, 1 and the first midpoint together.
  float ess_cur = 0.f, ess_one = 0.f;  // read by thread 0 only
  pass<3, kResident>(s, sl, sb, ctl.first, part, mine[0]);
  cluster.sync();
  if (threadIdx.x < 32) {
    float ess[3];
    gather<3>(cluster, mine[0], ess);
    if (threadIdx.x == 0) {
      ess_cur = ess[0];
      ess_one = ess[1];
      if (ess_cur <= target || ess_one >= target) {
        ctl.stop = 1;
      } else {
        step(ctl, ess[2], target);
      }
    }
  }
  __syncthreads();

  int parity = 1;
  while (!ctl.stop) {  // CTA-uniform: read after a barrier; cluster-uniform: same decisions
    pass<1, kResident>(s, sl, sb, &ctl.beta, part, mine[parity]);
    cluster.sync();
    if (threadIdx.x < 32) {
      float ess[1];
      gather<1>(cluster, mine[parity], ess);
      if (threadIdx.x == 0) step(ctl, ess[0], target);
    }
    __syncthreads();
    parity ^= 1;
  }
  cluster.sync();  // no CTA exits while another may still read its partials

  if (rank == 0 && threadIdx.x == 0) {
    float beta = ctl.beta;
    if (ess_cur <= target) {
      beta = beta_prev;
    } else if (ess_one >= target) {
      beta = 1.f;
    }
    beta_out[0] = beta;
    probes_out[0] = 2 + ctl.iter;
  }
}

// One cluster of kCluster CTAs with `smem` bytes of dynamic shared memory each.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(size_t smem, cudaStream_t stream) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Sets the kernel's attributes on the current device and checks that one
// cluster with the largest shared memory the route takes fits it, once per
// device; returns the cudaError_t of the first step that fails.
template <bool kResident>
cudaError_t prepare() {
  static bool checked[kMaxDevices] = {};
  static cudaError_t status[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (checked[device]) return status[device];
  auto kernel = ess_bisect_kernel<kResident>;
  const int smem = kResident ? static_cast<int>(8 * kSliceMax) : 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    ClusterLaunch one(smem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &one.cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  }
  checked[device] = true;
  status[device] = err;
  return err;
}

template <bool kResident>
cudaError_t launch(const float* logl, const float* bm, const float* scal, float* beta,
                   int32_t* probes, int64_t n, int64_t slice, cudaStream_t stream) {
  cudaError_t err = prepare<kResident>();
  if (err != cudaSuccess) return err;
  ClusterLaunch one(kResident ? static_cast<size_t>(8 * slice) : 0, stream);
  err = cudaLaunchKernelEx(&one.cfg, ess_bisect_kernel<kResident>, logl, bm, scal, beta, probes, n,
                           slice);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. logl and bm: (n,) float32; scal: (2,)
// float32 = (beta_prev, target); beta: (1,) float32 out; probes: (1,) int32
// out (ESS evaluations). The launch plan comes from the wrapper: `slice`
// samples per CTA (a multiple of 4, 16 * slice >= n), held in shared memory
// if `resident` (slice <= 24,576). Launches on `stream` of the current
// device without synchronising and returns a cudaError_t.
extern "C" int tempest_ess_bisect(const void* logl, const void* bm, const void* scal, void* beta,
                                  void* probes, int64_t n, int64_t slice, int resident,
                                  void* stream) {
  if (slice <= 0 || slice % 4 != 0 || slice * kCluster < n || (resident && slice > kSliceMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* l = static_cast<const float*>(logl);
  const auto* b = static_cast<const float*>(bm);
  const auto* sc = static_cast<const float*>(scal);
  auto* be = static_cast<float*>(beta);
  auto* pr = static_cast<int32_t*>(probes);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = resident ? launch<true>(l, b, sc, be, pr, n, slice, st)
                                   : launch<false>(l, b, sc, be, pr, n, slice, st);
  return static_cast<int>(err);
}
