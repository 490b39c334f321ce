// ESS-mode temperature bisection for Hopper (sm_90a): the whole bisection in
// one launch of one thread-block cluster, in float32 or float64 (the kernel
// is a template on its scalar type; one C entry each).
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
// max(1e-8, 1e-4) * max(|lo|, |hi|, tiny), or beta == 1, or 200 probes;
// tiny is 1e-38 in float32 (as the Pallas kernel has it) and DBL_MIN,
// finfo(float64).tiny, in float64 (tempest_tpu/steps/reweight.py:41-44).
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

//
// The float64 instantiation (the port's dtype=torch.float64 path, where the
// JAX package runs XLA's float64 bisection; its Pallas kernel is float32
// only) is the same design at twice the bytes a sample: 16, so a resident
// slice holds half as many samples (kSliceBytes / 16 = 12,288, resident up
// to S = 196,608) and the streamed route reads two 16-byte loads per group
// of 4. Its arithmetic is heavier than the bytes: exp in double is a
// software sequence of FP64 fused multiply-adds (no SFU), and FP64 issues at
// half the FP32 rate, so a pass costs more instructions than in float32;
// chip_smoke.py bounds it with an FP64 term. The partials (m, s1, s2) are
// doubles through the shuffles and the distributed shared memory, combined
// in the same fixed order, so beta stays deterministic.
//
// The bracket mode (ess_bracket_kernel, the shared body with kBracket; C
// entries tempest_ess_bracket and tempest_ess_bracket_f64) runs dynamic mode's ESS bracket search, XLA's
// `_find_ess_bracket` (tempest_tpu/steps/reweight.py:73-119; the port's
// plain version is the "ess_bracket" device loop of steps/reweight.py), in
// the same launch shape: the same passes, partials and decisions through
// distributed shared memory. Only the stop rule and the output differ. Stay
// (lo = hi = beta_prev) when ESS(beta_prev) <= target; jump (lo = hi = 1)
// when ESS(beta_prev) > target and ESS(1) >= target; else bisect [beta_prev,
// 1], an ESS at or above the target moving lo up to the midpoint and
// anything else bringing hi down, while hi - lo is above the interval
// tolerance (with finfo's tiny, as steps/reweight.py has it) and fewer than
// 200 probes ran; no ESS-tolerance stop. It writes (lo, hi) and the probe
// count (2 + the bisection's probes) to device words, and reads beta_prev
// and the target from device words, so a CUDA graph can hold the launch. It
// computes ESS as s1^2 / s2, where the plain version normalises first (exp(2
// lse(w) - lse(2 w)) of w = logw - lse(logw)): a midpoint whose ESS lies
// within rounding of the target may be decided the other way.
//
// CTA shape by type (Cta<T>). 1024 threads leave a thread 64 of the SM's
// 65,536 registers. The float32 state fits (48); the double one does not:
// at 1024 threads ptxas spilled 172-236 bytes a thread to local memory
// (chip_smoke.py phase 2 reads ptxas's report and fails on any spill). So
// the float64 CTA has kThreadsF64 = 512 threads, 128 registers each; its 16
// warps' partials fill half of warp 0's lanes in the second reduction
// stage, the other half empty partials that add nothing, in a fixed order
// as before. The slices are the same, each thread walking twice the groups
// of 4.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreadsF32 = 1024;  // threads a CTA in float32
constexpr int kThreadsF64 = 512;   // and in float64: 128 registers a thread, no spill
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCluster = 16;  // CTAs in the cluster, one slice each
constexpr int kMaxDevices = 64;
// float32 samples a CTA holds in shared memory on the resident route (192 KB
// for logl and Bm); tempest_tpu_torch/ops/cuda_reweight.py plans the routes
// with this number. A float64 slice holds half as many.
constexpr int64_t kSliceMax = 24576;
constexpr int64_t kSliceBytes = 8 * kSliceMax;

template <typename T>
constexpr int64_t slice_max() { return kSliceBytes / (2 * static_cast<int64_t>(sizeof(T))); }

// The CTA of the instantiation for T.
template <typename T>
struct Cta {
  static constexpr int kThreads = sizeof(T) == sizeof(float) ? kThreadsF32 : kThreadsF64;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kWarps <= 32, "the second reduction stage takes one warp's partial per lane");
};

// tempest_tpu/config.py:20-28, in the scalar type of the instantiation.
template <typename T>
struct Consts;
template <>
struct Consts<float> {
  static constexpr float kBetaTolerance = 1e-4f;
  static constexpr float kBetaRtol = 1e-8f;
  static constexpr float kEssTolerance = 0.01f;
  static constexpr float kMetricAtol = 0.5f;
  static constexpr float kNonFiniteMetric = 1e10f;
  static constexpr float kTiny = 1e-38f;
  static constexpr float kFinfoTiny = FLT_MIN;  // the bracket's, as steps/reweight.py has it
};
template <>
struct Consts<double> {
  static constexpr double kBetaTolerance = 1e-4;
  static constexpr double kBetaRtol = 1e-8;
  static constexpr double kEssTolerance = 0.01;
  static constexpr double kMetricAtol = 0.5;
  static constexpr double kNonFiniteMetric = 1e10;
  static constexpr double kTiny = DBL_MIN;
  static constexpr double kFinfoTiny = DBL_MIN;
};
constexpr int kMaxBisectionIterations = 200;

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ double vabs(double a) { return fabs(a); }
__device__ __forceinline__ float vexp(float a) { return expf(a); }
__device__ __forceinline__ double vexp(double a) { return exp(a); }

template <typename T>
__device__ __forceinline__ bool is_finite(T v) { return vabs(v) < T(INFINITY); }  // false for NaN

template <typename T>
struct Acc {
  T m;   // max of x
  T s1;  // sum exp(x - m)
  T s2;  // sum exp(2 (x - m))
};

template <typename T>
__device__ __forceinline__ Acc<T> empty_acc() { return Acc<T>{-T(INFINITY), T(0), T(0)}; }

// 4 samples of one array, as held in shared memory (16 bytes in float32,
// 32 in float64).
template <typename T>
struct __align__(16) Quad {
  T v[4];
};

// Combines the NB partials of every lane of the warp, for each beta at
// once; every lane gets the totals. Max first (shuffles of the max), then
// one rescale per lane, exp(m - M), then plain sums: no exp inside the tree.
template <typename T, int NB>
__device__ __forceinline__ void warp_combine(Acc<T> (&a)[NB]) {
  T M[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) M[k] = a[k].m;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int k = 0; k < NB; ++k) M[k] = vmax(M[k], __shfl_xor_sync(kFullMask, M[k], offset));
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const T c = (a[k].m == -T(INFINITY)) ? T(0) : vexp(a[k].m - M[k]);  // M = -inf: all empty
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
template <typename T>
__device__ __forceinline__ void add4(Acc<T>& a, const T x[4]) {
  const T cm = vmax(vmax(x[0], x[1]), vmax(x[2], x[3]));
  if (cm > a.m) {
    const T c = (a.m == -T(INFINITY)) ? T(0) : vexp(a.m - cm);
    a.s1 *= c;
    a.s2 *= c * c;
    a.m = cm;
  }
  if (a.m != -T(INFINITY)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T e = vexp(x[j] - a.m);
      a.s1 += e;
      a.s2 += e * e;
    }
  }
}

// The CTA's slice: samples [begin, end) of the input, `quads` groups of 4.
template <typename T>
struct Slice {
  const T* __restrict__ logl;
  const T* __restrict__ bm;
  int64_t begin, end;
  int quads;
  bool aligned;  // both pointers 16-byte aligned
};

// 4 values from 16-byte aligned device memory: one 16-byte load in
// float32, two in float64.
__device__ __forceinline__ void load_quad(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_quad(const double* p, double v[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Group q of the slice, from device memory; samples past the slice end read
// as dropped (logl 0, Bm +inf), so x = -inf for them.
template <typename T>
__device__ __forceinline__ void load4(const Slice<T>& s, int q, T l[4], T b[4]) {
  const int64_t i = s.begin + 4 * static_cast<int64_t>(q);
  if (s.aligned && i + 4 <= s.end) {
    load_quad(s.logl + i, l);
    load_quad(s.bm + i, b);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < s.end;
      l[j] = in ? s.logl[i + j] : T(0);
      b[j] = in ? s.bm[i + j] : T(INFINITY);
    }
  }
}

// The mask, applied to raw values: a sample whose logl is not finite or
// whose Bm is +inf becomes (0, +inf).
template <typename T>
__device__ __forceinline__ void mask4(T l[4], T b[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool keep = is_finite(l[j]) && b[j] != T(INFINITY);
    l[j] = keep ? l[j] : T(0);
    b[j] = keep ? b[j] : T(INFINITY);
  }
}

// Adds one group of 4 masked samples to the partials at each of the NB betas.
template <typename T, int NB>
__device__ __forceinline__ void add_group(Acc<T> (&acc)[NB], const T (&beta)[NB], const T l[4],
                                          const T b[4]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    T x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = beta[k] * l[j] - b[j];  // dropped: 0 - inf
    add4(acc[k], x);
  }
}

// One pass: the CTA's partial (m, s1, s2) at each of the NB betas into
// `mine[0..NB)`. Every thread of the CTA calls it.
template <typename T, int NB, bool kResident>
__device__ void pass(const Slice<T>& s, const Quad<T>* __restrict__ sl,
                     const Quad<T>* __restrict__ sb, const T* betas,
                     Acc<T> (*part)[Cta<T>::kWarps], Acc<T>* mine) {
  constexpr int kThreads = Cta<T>::kThreads;
  Acc<T> acc[NB];
  T beta[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    acc[k] = empty_acc<T>();
    beta[k] = betas[k];
  }
  for (int q = threadIdx.x; q < s.quads; q += kThreads) {
    T l[4], b[4];
    if (kResident) {
      const Quad<T> l4 = sl[q], b4 = sb[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[j] = l4.v[j];
        b[j] = b4.v[j];
      }
    } else {
      load4(s, q, l, b);
      mask4(l, b);
    }
    add_group<T, NB>(acc, beta, l, b);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_combine<T, NB>(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) part[k][warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if constexpr (Cta<T>::kWarps == 32) {
        acc[k] = part[k][lane];  // one partial per lane
      } else {
        acc[k] = lane < Cta<T>::kWarps ? part[k][lane] : empty_acc<T>();
      }
    }
    warp_combine<T, NB>(acc);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NB; ++k) mine[k] = acc[k];
    }
  }
}

template <typename T>
__device__ __forceinline__ T interval_tol(T lo, T hi, T tiny = Consts<T>::kTiny) {
  using C = Consts<T>;
  const T scale = vmax(vmax(vabs(lo), vabs(hi)), tiny);
  return vmax(C::kBetaRtol * scale, C::kBetaTolerance * scale);
}

// The bisection's state, held by every CTA (written by its thread 0).
template <typename T>
struct Control {
  T lo, hi, beta;  // beta: the next probe, or the result once stopped
  int iter;        // bisection probes so far
  int stop;
  T first[3];      // the first pass's betas: beta_prev, 1, the first midpoint
};

// One step of the serial bisection on the ESS at c.beta: the stop rules,
// the bracket update and the next probe, as tempest_tpu's bisection.
template <typename T>
__device__ __forceinline__ void step(Control<T>& c, T metric, T target) {
  using C = Consts<T>;
  if (!is_finite(metric)) metric = C::kNonFiniteMetric;
  const bool metric_conv =
      vabs(metric - target) < vmax(C::kEssTolerance * vabs(target), C::kMetricAtol);
  const bool beta_conv = (c.hi - c.lo) < interval_tol(c.lo, c.hi);
  const bool done = metric_conv || beta_conv || (c.beta == T(1));
  const bool go_up = metric >= target;  // ESS decreases with beta
  if (!done && go_up) c.lo = c.beta;
  if (!done && !go_up) c.hi = c.beta;
  c.iter += 1;
  c.stop = done || c.iter >= kMaxBisectionIterations;
  if (!c.stop) c.beta = T(0.5) * (c.lo + c.hi);  // else keep the last probe
}

// The bracket's loop condition (steps/reweight.py `_bracket_open`): the
// interval above its tolerance (finfo's tiny as the floor of its scale) and
// fewer than 200 probes.
template <typename T>
__device__ __forceinline__ bool bracket_open(const Control<T>& c) {
  return (c.hi - c.lo) > interval_tol(c.lo, c.hi, Consts<T>::kFinfoTiny) &&
         c.iter < kMaxBisectionIterations;
}

// One probe of the ESS bracket on the ESS at c.beta, the midpoint: an ESS
// at or above the target moves lo up, anything else (NaN included) brings
// hi down; it stops on the interval tolerance and the probe cap alone.
template <typename T>
__device__ __forceinline__ void bracket_step(Control<T>& c, T ess, T target) {
  if (ess >= target) {
    c.lo = c.beta;
  } else {
    c.hi = c.beta;
  }
  c.iter += 1;
  c.stop = !bracket_open(c);
  if (!c.stop) c.beta = T(0.5) * (c.lo + c.hi);
}

// Warp 0 of this CTA: the cluster's combined partials at NB betas, as ESS,
// read from every CTA's `mine` in rank order.
template <typename T, int NB>
__device__ void gather(const cg::cluster_group& cluster, Acc<T>* mine, T* ess) {
  const int lane = threadIdx.x & 31;
  const int ranks = static_cast<int>(cluster.num_blocks());
  Acc<T> a[NB];
  const Acc<T>* remote = lane < ranks ? cluster.map_shared_rank(mine, lane) : nullptr;
#pragma unroll
  for (int k = 0; k < NB; ++k) a[k] = remote ? remote[k] : empty_acc<T>();
  warp_combine<T, NB>(a);
#pragma unroll
  for (int k = 0; k < NB; ++k) ess[k] = (a[k].s1 * a[k].s1) / a[k].s2;  // all dropped: 0/0 = NaN
}

// The body of both kernels. kBracket: the bracket mode (out holds lo and
// hi), else the ESS-mode bisection (out holds beta).
template <typename T, bool kResident, bool kBracket>
__device__ __forceinline__ void ess_search(const T* __restrict__ logl, const T* __restrict__ bm,
                                           const T* __restrict__ scal, T* __restrict__ out,
                                           int32_t* __restrict__ probes_out, int64_t n,
                                           int64_t slice) {
  constexpr int kThreads = Cta<T>::kThreads;
  extern __shared__ __align__(16) unsigned char dyn[];  // resident route: the masked slice
  __shared__ Acc<T> part[3][Cta<T>::kWarps];
  __shared__ Acc<T> mine[2][3];  // this CTA's partials, by probe parity
  __shared__ Control<T> ctl;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  Slice<T> s;
  s.logl = logl;
  s.bm = bm;
  s.begin = min(static_cast<int64_t>(rank) * slice, n);
  s.end = min(s.begin + slice, n);
  s.quads = static_cast<int>(slice / 4);
  s.aligned = ((reinterpret_cast<uintptr_t>(logl) | reinterpret_cast<uintptr_t>(bm)) & 15) == 0;
  Quad<T>* sl = reinterpret_cast<Quad<T>*>(dyn);
  Quad<T>* sb = sl + s.quads;
  if (kResident) {
    for (int q = threadIdx.x; q < s.quads; q += kThreads) {
      T l[4], b[4];
      load4(s, q, l, b);
      mask4(l, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sl[q].v[j] = l[j];
        sb[q].v[j] = b[j];
      }
    }
  }
  const T beta_prev = scal[0];
  const T target = scal[1];
  if (threadIdx.x == 0) {
    ctl.lo = beta_prev;
    ctl.hi = T(1);
    ctl.beta = T(0.5) * (beta_prev + T(1));
    ctl.iter = 0;
    ctl.stop = 0;
    ctl.first[0] = beta_prev;
    ctl.first[1] = T(1);
    ctl.first[2] = ctl.beta;
  }
  __syncthreads();

  // Pass 0: beta_prev, 1 and the first midpoint together.
  T ess_cur = T(0), ess_one = T(0);  // read by thread 0 only
  pass<T, 3, kResident>(s, sl, sb, ctl.first, part, mine[0]);
  cluster.sync();
  if (threadIdx.x < 32) {
    T ess[3];
    gather<T, 3>(cluster, mine[0], ess);
    if (threadIdx.x == 0) {
      ess_cur = ess[0];
      ess_one = ess[1];
      if (ess_cur <= target || ess_one >= target) {
        ctl.stop = 1;
      } else if (kBracket) {
        ctl.stop = !bracket_open(ctl);  // an interval already below tolerance: no probe
        if (!ctl.stop) bracket_step(ctl, ess[2], target);
      } else {
        step(ctl, ess[2], target);
      }
    }
  }
  __syncthreads();

  int parity = 1;
  while (!ctl.stop) {  // CTA-uniform: read after a barrier; cluster-uniform: same decisions
    pass<T, 1, kResident>(s, sl, sb, &ctl.beta, part, mine[parity]);
    cluster.sync();
    if (threadIdx.x < 32) {
      T ess[1];
      gather<T, 1>(cluster, mine[parity], ess);
      if (threadIdx.x == 0) {
        if (kBracket) {
          bracket_step(ctl, ess[0], target);
        } else {
          step(ctl, ess[0], target);
        }
      }
    }
    __syncthreads();
    parity ^= 1;
  }
  cluster.sync();  // no CTA exits while another may still read its partials

  if (rank == 0 && threadIdx.x == 0) {
    if (kBracket) {
      // Stay, or the jump when ESS(beta_prev) > target too (a NaN ESS at
      // beta_prev stays): both ends at the edge, as _find_ess_bracket has it.
      T lo = ctl.lo, hi = ctl.hi;
      if (ess_cur <= target || ess_one >= target) {
        lo = hi = (ess_cur > target && ess_one >= target) ? T(1) : beta_prev;
      }
      out[0] = lo;
      out[1] = hi;
    } else {
      T beta = ctl.beta;
      if (ess_cur <= target) {
        beta = beta_prev;
      } else if (ess_one >= target) {
        beta = T(1);
      }
      out[0] = beta;
    }
    probes_out[0] = 2 + ctl.iter;
  }
}

// The two modes under their own names, so a profile tells them apart.
template <typename T, bool kResident>
__global__ void __launch_bounds__(Cta<T>::kThreads, 1)
ess_bisect_kernel(const T* __restrict__ logl, const T* __restrict__ bm,
                  const T* __restrict__ scal, T* __restrict__ beta,
                  int32_t* __restrict__ probes, int64_t n, int64_t slice) {
  ess_search<T, kResident, false>(logl, bm, scal, beta, probes, n, slice);
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(Cta<T>::kThreads, 1)
ess_bracket_kernel(const T* __restrict__ logl, const T* __restrict__ bm,
                   const T* __restrict__ scal, T* __restrict__ bracket,
                   int32_t* __restrict__ probes, int64_t n, int64_t slice) {
  ess_search<T, kResident, true>(logl, bm, scal, bracket, probes, n, slice);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int32_t*, int64_t, int64_t);

template <typename T, bool kResident, bool kBracket>
KernelFn<T> kernel_of() {
  return kBracket ? ess_bracket_kernel<T, kResident> : ess_bisect_kernel<T, kResident>;
}

// One cluster of kCluster CTAs of `threads` threads with `smem` bytes of
// dynamic shared memory each.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int threads, size_t smem, cudaStream_t stream) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Sets the kernel's attributes on the current device and checks that one
// cluster with the largest shared memory the route takes fits it, once per
// device; returns the cudaError_t of the first step that fails.
template <typename T, bool kResident, bool kBracket>
cudaError_t prepare() {
  static bool checked[kMaxDevices] = {};
  static cudaError_t status[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (checked[device]) return status[device];
  const KernelFn<T> kernel = kernel_of<T, kResident, kBracket>();
  const int smem = kResident ? static_cast<int>(kSliceBytes) : 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    ClusterLaunch one(Cta<T>::kThreads, smem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &one.cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  }
  checked[device] = true;
  status[device] = err;
  return err;
}

template <typename T, bool kResident, bool kBracket>
cudaError_t launch(const T* logl, const T* bm, const T* scal, T* out, int32_t* probes, int64_t n,
                   int64_t slice, cudaStream_t stream) {
  cudaError_t err = prepare<T, kResident, kBracket>();
  if (err != cudaSuccess) return err;
  ClusterLaunch one(Cta<T>::kThreads, kResident ? static_cast<size_t>(2 * sizeof(T) * slice) : 0,
                    stream);
  err = cudaLaunchKernelEx(&one.cfg, kernel_of<T, kResident, kBracket>(), logl, bm, scal, out,
                           probes, n, slice);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool kBracket>
int entry(const void* logl, const void* bm, const void* scal, void* beta, void* probes, int64_t n,
          int64_t slice, int resident, void* stream) {
  if (slice <= 0 || slice % 4 != 0 || slice * kCluster < n ||
      (resident && slice > slice_max<T>())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* l = static_cast<const T*>(logl);
  const auto* b = static_cast<const T*>(bm);
  const auto* sc = static_cast<const T*>(scal);
  auto* be = static_cast<T*>(beta);
  auto* pr = static_cast<int32_t*>(probes);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = resident ? launch<T, true, kBracket>(l, b, sc, be, pr, n, slice, st)
                                   : launch<T, false, kBracket>(l, b, sc, be, pr, n, slice, st);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, loaded with ctypes: tempest_ess_bisect in float32,
// tempest_ess_bisect_f64 in float64. logl and bm: (n,) of the type; scal:
// (2,) = (beta_prev, target); beta: (1,) out; probes: (1,) int32 out (ESS
// evaluations). The launch plan comes from the wrapper: `slice` samples per
// CTA (a multiple of 4, 16 * slice >= n), held in shared memory if
// `resident` (slice <= 24,576 in float32, 12,288 in float64). Each launches
// on `stream` of the current device without synchronising and returns a
// cudaError_t.
extern "C" int tempest_ess_bisect(const void* logl, const void* bm, const void* scal, void* beta,
                                  void* probes, int64_t n, int64_t slice, int resident,
                                  void* stream) {
  return entry<float, false>(logl, bm, scal, beta, probes, n, slice, resident, stream);
}

extern "C" int tempest_ess_bisect_f64(const void* logl, const void* bm, const void* scal,
                                      void* beta, void* probes, int64_t n, int64_t slice,
                                      int resident, void* stream) {
  return entry<double, false>(logl, bm, scal, beta, probes, n, slice, resident, stream);
}

// The bracket mode, tempest_ess_bracket in float32 and tempest_ess_bracket_f64
// in float64: the same arguments, but `bracket` is (2,) out, (lo, hi), and
// `probes` counts the ESS evaluations of the bracket search (2 + its
// bisection probes).
extern "C" int tempest_ess_bracket(const void* logl, const void* bm, const void* scal,
                                   void* bracket, void* probes, int64_t n, int64_t slice,
                                   int resident, void* stream) {
  return entry<float, true>(logl, bm, scal, bracket, probes, n, slice, resident, stream);
}

extern "C" int tempest_ess_bracket_f64(const void* logl, const void* bm, const void* scal,
                                       void* bracket, void* probes, int64_t n, int64_t slice,
                                       int resident, void* stream) {
  return entry<double, true>(logl, bm, scal, bracket, probes, n, slice, resident, stream);
}
