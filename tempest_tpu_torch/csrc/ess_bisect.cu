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
// The bracket mode (ess_bracket_kernel, a body of its own, bracket_search;
// C entries tempest_ess_bracket and tempest_ess_bracket_f64) runs dynamic
// mode's ESS bracket search, XLA's `_find_ess_bracket`
// (tempest_tpu/steps/reweight.py:73-119; the port's plain version is the
// "ess_bracket" device loop of steps/reweight.py), in one launch of one
// cluster of kCluster CTAs. Stay (lo = hi = beta_prev) when ESS(beta_prev)
// <= target; jump (lo = hi = 1) when ESS(beta_prev) > target and ESS(1) >=
// target; else bisect [beta_prev, 1], an ESS at or above the target moving
// lo up to the midpoint and anything else bringing hi down, while hi - lo is
// above the interval tolerance (with finfo's tiny, as steps/reweight.py has
// it) and fewer than 200 probes ran; no ESS-tolerance stop. It writes (lo,
// hi) and the probe count (2 + the bisection's probes) to device words, and
// reads beta_prev and the target from device words, so a CUDA graph can
// hold the launch. It computes ESS as s1^2 / s2, where the plain version
// normalises first (exp(2 lse(w) - lse(2 w)) of w = logw - lse(logw)): a
// midpoint whose ESS lies within rounding of the target may be decided the
// other way.
//
// What bounds the bracket on dynamic mode's history: the latency of a probe.
// The history is (T_max, N) row-major with its filled rows a prefix, so at
// 48 of 192 rows a quarter of the S = 196,608 samples live and the rest are
// masked; the search takes about 16 probes, each one exp a live sample and
// a combine across the cluster whose result decides the next probe. The
// design of 63fe4b1 (the bisection's body) gave CTA r the contiguous slice
// [r L, (r + 1) L): CTAs 0-3 held every live sample, the others spent an exp
// a probe on masked ones, and each probe passed two CTA barriers and a
// cluster barrier and read 16 remote partials: about 3 us a probe against a
// bound of 1.5 us for the whole search. Its own design, kept apart so that
// the bisection keeps its bits:
//  - Samples are dealt out by chunks of kChunk = 128 (a warp's load, a quad
//    a lane): chunk c to CTA c % kCluster, so a live prefix spreads evenly.
//    On the resident route (S <= kCluster x the slice's maximum) each CTA
//    loads its chunks once, masked, into shared memory, every load in
//    flight at once; a pass skips a quad whose four samples are all dropped
//    (on a history whose live rows are a prefix, whole warps skip
//    together), so it costs about the live samples' exps: at dynamic's
//    history under two live quads a thread. Keeping only the live samples
//    instead (a scan a round of loads) took 7.0 us to load where this takes
//    3.3 us (the stamps; PERF.md). The streamed route reads the CTA's chunks
//    from device memory at every pass and masks them there.
//  - 512 threads a CTA on the resident route (kBracketThreads, 128
//    registers a thread); the bisection's CTA on the streamed one, for its
//    loads in flight (`BracketCta`).
//  - One probe round trip: each warp combines its partials; warp 0 waits at
//    a named barrier that the other warps only arrive at, combines the
//    warps', and its lanes r < kCluster push the CTA's partials into CTA
//    r's inbox with st.async, whose bytes count against that CTA's
//    mbarrier; thread 0 of each CTA announces the bytes its inbox awaits a
//    round (arrive.expect_tx). Every warp of every CTA then waits on its
//    own CTA's mbarrier, combines the kCluster partials of the inbox in rank
//    order and takes the same decision, held in registers: no cluster
//    barrier, no remote read and no CTA barrier a probe, and the pushing
//    lanes do not wait for their writes to land. Inboxes and mbarriers
//    alternate by probe parity: a CTA pushes round p + 2 only after every
//    CTA has pushed round p + 1, which each does after all its warps have
//    read round p.
//  - The first pass takes beta_prev, 1 and the first midpoint; each later
//    pass the next midpoint. A pass can take kBracketLevels levels of the
//    bisection tree below the bracket (2^levels - 1 betas, walked as the
//    serial search walks them, each node's beta 0.5 (lo + hi) of the bracket
//    the serial search would hold there, each level a probe); one level was
//    measured fastest (the constant's note).
//  - Built with -DBRACKET_STAMPS (chip_smoke.py phase 3b), bracket_stamps.cuh
//    records each CTA's cycles by phase of a probe round.
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

#ifdef BRACKET_STAMPS
#include "bracket_stamps.cuh"
#endif

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

// The ESS-mode bisection (out holds beta).
template <typename T, bool kResident>
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
      if (threadIdx.x == 0) step(ctl, ess[0], target);
    }
    __syncthreads();
    parity ^= 1;
  }
  cluster.sync();  // no CTA exits while another may still read its partials

  if (rank == 0 && threadIdx.x == 0) {
    T beta = ctl.beta;
    if (ess_cur <= target) {
      beta = beta_prev;
    } else if (ess_one >= target) {
      beta = T(1);
    }
    out[0] = beta;
    probes_out[0] = 2 + ctl.iter;
  }
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(Cta<T>::kThreads, 1)
ess_bisect_kernel(const T* __restrict__ logl, const T* __restrict__ bm,
                  const T* __restrict__ scal, T* __restrict__ beta,
                  int32_t* __restrict__ probes, int64_t n, int64_t slice) {
  ess_search<T, kResident>(logl, bm, scal, beta, probes, n, slice);
}

// ---------------------------------------------------------------------------
// The bracket mode (design note at the top of the file, "The bracket mode").
// ---------------------------------------------------------------------------
constexpr int kChunk = 128;  // samples a warp takes at once: a quad a lane
constexpr int kFirst = 3;    // the first pass's betas: beta_prev, 1 and the first midpoint
constexpr int kBracketThreads = 512;  // threads a CTA on the resident route

// The CTA by route: kBracketThreads where the samples are held on chip, the
// bisection's CTA (1024 threads in float32, 512 in float64) where every
// pass streams them, for as many loads in flight as it has.
template <typename T, bool kResident>
struct BracketCta {
  static constexpr int kThreads = kResident ? kBracketThreads : Cta<T>::kThreads;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kWarps <= 32, "warp 0 combines one warp's partial a lane");
};

// Levels of the bisection tree a later pass evaluates (its betas: kTree).
// One: at dynamic's history a pass costs about its betas' exps on the live
// samples, so two levels (3 betas a pass) took 0.0327 ms and three 0.0437
// against one level's 0.0309, and all filled 0.0832 and 0.1143 against
// 0.0728 (scripts/kernel_designs.py; PERF.md).
constexpr int kBracketLevels = 1;
constexpr int kTree = (1 << kBracketLevels) - 1;
constexpr int kInbox = kFirst > kTree ? kFirst : kTree;

// The bracket's loop condition (steps/reweight.py `_bracket_open`): the
// interval above its tolerance (finfo's tiny as the floor of its scale) and
// fewer than 200 probes.
template <typename T>
__device__ __forceinline__ bool bracket_open(T lo, T hi, int iter) {
  return (hi - lo) > interval_tol(lo, hi, Consts<T>::kFinfoTiny) &&
         iter < kMaxBisectionIterations;
}

// Samples [i, i + 4) into l and b, past n dropped (logl 0, Bm +inf), masked.
template <typename T>
__device__ __forceinline__ void load_masked(const T* __restrict__ logl, const T* __restrict__ bm,
                                            int64_t n, bool aligned, int64_t i, T l[4], T b[4]) {
  if (aligned && i + 4 <= n) {
    load_quad(logl + i, l);
    load_quad(bm + i, b);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < n;
      l[j] = in ? logl[i + j] : T(0);
      b[j] = in ? bm[i + j] : T(INFINITY);
    }
  }
  mask4(l, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of `p` (this CTA's shared memory) in the shared memory of CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t remote_u32(const void* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// Writes v into CTA `rank`'s shared memory at `dst` (an address of this
// CTA's layout) without waiting: the write counts its bytes against the
// transaction count of that CTA's mbarrier at `bar`, which completes its
// phase once every expected byte has landed (st.async, one way).
__device__ __forceinline__ void push(float* dst, float v, uint64_t* bar, unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
          remote_u32(dst, rank)),
      "r"(__float_as_uint(v)), "r"(remote_u32(bar, rank))
      : "memory");
}
__device__ __forceinline__ void push(double* dst, double v, uint64_t* bar, unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
          remote_u32(dst, rank)),
      "l"(__double_as_longlong(v)), "r"(remote_u32(bar, rank))
      : "memory");
}

// This thread's arrival on its CTA's mbarrier, announcing `bytes` more
// to land in the phase.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Whether this CTA's mbarrier finished its phase of this parity, acquiring
// what landed in it.
__device__ __forceinline__ bool arrived(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

#ifdef BRACKET_STAMPS
static_assert(kBracketStampCtas == kCluster, "a stamp row a CTA of the cluster");
#define BRACKET_MARK(field)                        \
  do {                                             \
    const long long now_ = clock64();              \
    stamps[field] += now_ - mark;                  \
    mark = now_;                                   \
  } while (0)
#else
#define BRACKET_MARK(field) \
  do {                      \
  } while (0)
#endif

// The samples of CTA `rank`, masked, into sl and sb: the chunks rank, rank +
// kCluster, ... of kChunk samples, quad q of the CTA being lane q % 32 of
// its chunk q / 32; past n, dropped samples. A thread loads kLoadBatch
// quads before it stores any, so that many loads are in flight at once (at
// dynamic's history, 6 quads a thread: one round in float32).
template <typename T, int kThreads>
__device__ __forceinline__ void load_chunks(const T* __restrict__ logl, const T* __restrict__ bm,
                                            int64_t n, bool aligned, int rank, int quads,
                                            Quad<T>* __restrict__ sl, Quad<T>* __restrict__ sb) {
  constexpr int kLoadBatch = sizeof(T) == 4 ? 8 : 4;
  for (int q0 = threadIdx.x; q0 < quads; q0 += kThreads * kLoadBatch) {
    T l[kLoadBatch][4], b[kLoadBatch][4];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int q = q0 + u * kThreads;
      const int64_t c = rank + static_cast<int64_t>(kCluster) * (q >> 5);
      load_masked(logl, bm, q < quads ? n : 0, aligned, c * kChunk + 4 * (q & 31), l[u], b[u]);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q < quads) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sl[q].v[j] = l[u][j];
          sb[q].v[j] = b[u][j];
        }
      }
    }
  }
}

// One pass at NB betas: this thread's partials, over its quads held on chip
// (resident; a quad whose four samples are all dropped adds nothing and is
// skipped: on a history whose live rows are a prefix whole warps skip
// together) or over the CTA's chunks read from device memory (streamed).
template <typename T, int NB, int kThreads, bool kResident>
__device__ __forceinline__ void bracket_pass(const T* __restrict__ logl, const T* __restrict__ bm,
                                             int64_t n, bool aligned, int rank,
                                             const Quad<T>* __restrict__ sl,
                                             const Quad<T>* __restrict__ sb, int quads,
                                             const T (&beta)[NB], Acc<T> (&acc)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) acc[k] = empty_acc<T>();
  if (kResident) {
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const Quad<T> b4 = sb[q];
      if (b4.v[0] == T(INFINITY) && b4.v[1] == T(INFINITY) && b4.v[2] == T(INFINITY) &&
          b4.v[3] == T(INFINITY)) {
        continue;
      }
      const Quad<T> l4 = sl[q];
      add_group<T, NB>(acc, beta, l4.v, b4.v);
    }
  } else {
    constexpr int kWarps = kThreads / 32;
    const int64_t chunks = (n + kChunk - 1) / kChunk;
    const int64_t mine = rank + static_cast<int64_t>(kCluster) * (threadIdx.x >> 5);
    for (int64_t c = mine; c < chunks; c += static_cast<int64_t>(kCluster) * kWarps) {
      T l[4], b[4];
      load_masked(logl, bm, n, aligned, c * kChunk + 4 * (threadIdx.x & 31), l, b);
      add_group<T, NB>(acc, beta, l, b);
    }
  }
}

// The betas of a pass's tree on [lo, hi]: node 0 the midpoint, node i's
// children 2i + 1 on [lo_i, beta_i] and 2i + 2 on [beta_i, hi_i], each
// 0.5 * (lo + hi) of its interval, as the serial bisection computes it.
template <typename T, int kTree>
__device__ __forceinline__ void tree_betas(T lo, T hi, T (&beta)[kTree]) {
  T tlo[kTree], thi[kTree];
  tlo[0] = lo;
  thi[0] = hi;
#pragma unroll
  for (int i = 0; i < kTree; ++i) {
    beta[i] = T(0.5) * (tlo[i] + thi[i]);
    if (2 * i + 2 < kTree) {
      tlo[2 * i + 1] = tlo[i];
      thi[2 * i + 1] = beta[i];
      tlo[2 * i + 2] = beta[i];
      thi[2 * i + 2] = thi[i];
    }
  }
}

// The serial bracket search's probes over the first `kLevels` levels of a
// tree: from node 0, an ESS at or above the target moves lo up to the
// node's beta and goes on to its right child, anything else (NaN included)
// brings hi down and goes left, each a probe; it stops where the bracket
// closes. Returns whether it did.
template <int kLevels, typename T>
__device__ __forceinline__ bool walk(const T* ess, const T* beta, T target, T& lo, T& hi,
                                     int& iter) {
  int node = 0;
#pragma unroll
  for (int level = 0; level < kLevels; ++level) {
    // The node's ESS and beta by selects over the level's nodes, so the
    // arrays stay in registers (no indexing by a value known only at run
    // time).
    const int begin = (1 << level) - 1;
    T e = ess[begin], b = beta[begin];
#pragma unroll
    for (int j = begin + 1; j < 2 * begin + 1; ++j) {
      e = node == j ? ess[j] : e;
      b = node == j ? beta[j] : b;
    }
    if (e >= target) {
      lo = b;
      node = 2 * node + 2;
    } else {
      hi = b;
      node = 2 * node + 1;
    }
    iter += 1;
    if (!bracket_open(lo, hi, iter)) return true;
  }
  return false;
}

// The cluster's ESS at NB betas: every CTA's partials, pushed into this
// CTA's inbox, combined in rank order by every warp alike.
template <typename T, int NB>
__device__ __forceinline__ void inbox_ess(const Acc<T> (*box)[kInbox], T (&ess)[NB]) {
  const int lane = threadIdx.x & 31;
  Acc<T> a[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) a[k] = lane < kCluster ? box[lane][k] : empty_acc<T>();
  warp_combine<T, NB>(a);
#pragma unroll
  for (int k = 0; k < NB; ++k) ess[k] = (a[k].s1 * a[k].s1) / a[k].s2;  // all dropped: 0/0 = NaN
}

template <typename T, bool kResident>
struct BracketShared {
  Acc<T> part[kInbox][BracketCta<T, kResident>::kWarps];  // the warps' partials
  Acc<T> inbox[2][kCluster][kInbox];  // every CTA's partials, by probe parity
  uint64_t arrivals[2];               // the inbox's mbarriers, by probe parity
};

// One probe round at NB betas for every thread of every CTA: thread 0
// announces the bytes its CTA's inbox awaits; the pass; the warp's combine;
// the CTA's (warp 0, after a named barrier the other warps only arrive at);
// lanes r < kCluster of warp 0 push the CTA's partials into CTA r's inbox
// (st.async, counted by that CTA's mbarrier); then every warp waits for its
// CTA's inbox to fill and combines it in rank order. Gives the ESS at the
// NB betas, the same in every thread of the cluster.
template <typename T, int NB, bool kResident>
__device__ __forceinline__ void probe(BracketShared<T, kResident>& sh, const T* __restrict__ logl,
                                      const T* __restrict__ bm, int64_t n, bool aligned,
                                      int rank, const Quad<T>* __restrict__ sl,
                                      const Quad<T>* __restrict__ sb, int quads, int round,
                                      const T (&beta)[NB], T (&ess)[NB]
#ifdef BRACKET_STAMPS
                                      , long long* stamps, long long& mark
#endif
) {
  constexpr int kThreads = BracketCta<T, kResident>::kThreads;
  constexpr int kWarps = BracketCta<T, kResident>::kWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int par = round & 1;
  if (threadIdx.x == 0) {
    // Round `round - 2`, the last on this barrier, has completed here: this
    // thread waited for it. Bytes landing before this count against it.
    expect_bytes(&sh.arrivals[par], kCluster * NB * 3 * static_cast<uint32_t>(sizeof(T)));
  }
  Acc<T> acc[NB];
  bracket_pass<T, NB, kThreads, kResident>(logl, bm, n, aligned, rank, sl, sb, quads, beta, acc);
  BRACKET_MARK(1);
  warp_combine<T, NB>(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) sh.part[k][warp] = acc[k];
  }
  BRACKET_MARK(2);
  if (warp == 0) {
    asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
#pragma unroll
    for (int k = 0; k < NB; ++k) acc[k] = lane < kWarps ? sh.part[k][lane] : empty_acc<T>();
    warp_combine<T, NB>(acc);
    BRACKET_MARK(3);
    if (lane < kCluster) {
      Acc<T>* dst = &sh.inbox[par][rank][0];
      uint64_t* bar = &sh.arrivals[par];
      const unsigned to = static_cast<unsigned>(lane);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        push(&dst[k].m, acc[k].m, bar, to);
        push(&dst[k].s1, acc[k].s1, bar, to);
        push(&dst[k].s2, acc[k].s2, bar, to);
      }
    }
    BRACKET_MARK(4);
  } else {
    asm volatile("bar.arrive 1, %0;" ::"r"(kThreads) : "memory");
  }
  const uint32_t parity = static_cast<uint32_t>((round >> 1) & 1);
  while (!arrived(&sh.arrivals[par], parity)) {
  }
  BRACKET_MARK(5);
  inbox_ess<T, NB>(sh.inbox[par], ess);
}

// The bracket search, dynamic mode's (the bracket mode of the design note):
// writes (lo, hi) and the probe count (2 + its bisection probes).
template <typename T, bool kResident>
__device__ __forceinline__ void bracket_search(const T* __restrict__ logl,
                                               const T* __restrict__ bm,
                                               const T* __restrict__ scal, T* __restrict__ out,
                                               int32_t* __restrict__ probes_out, int64_t n) {
  constexpr int kThreads = BracketCta<T, kResident>::kThreads;
  extern __shared__ __align__(16) unsigned char dyn[];  // resident route: the CTA's samples
  __shared__ BracketShared<T, kResident> sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(logl) | reinterpret_cast<uintptr_t>(bm)) & 15) == 0;
#ifdef BRACKET_STAMPS
  long long stamps[kBracketStampFields] = {};
  long long mark = clock64();
#define BRACKET_STAMP_ARGS , stamps, mark
#else
#define BRACKET_STAMP_ARGS
#endif
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&sh.arrivals[0]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&sh.arrivals[1]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The CTA's chunks: rank, rank + kCluster, ... (their quads on chip).
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int quads = static_cast<int>((chunks + kCluster - 1) / kCluster * (kChunk / 4));
  Quad<T>* sl = reinterpret_cast<Quad<T>*>(dyn);
  Quad<T>* sb = sl + quads;
  if (kResident) load_chunks<T, kThreads>(logl, bm, n, aligned, rank, quads, sl, sb);
  cluster.sync();  // every CTA's barriers made, its samples held
  BRACKET_MARK(0);
  const T beta_prev = scal[0];
  const T target = scal[1];

  // The first pass: beta_prev, 1 and the first midpoint, as the bisection's.
  T lo = beta_prev, hi = T(1);
  int iter = 0;
  const T first[kFirst] = {beta_prev, T(1), T(0.5) * (beta_prev + T(1))};
  T ess0[kFirst];
  probe<T, kFirst, kResident>(sh, logl, bm, n, aligned, rank, sl, sb, quads, 0, first,
                              ess0 BRACKET_STAMP_ARGS);
  const T ess_cur = ess0[0], ess_one = ess0[1];
  const bool edge = ess_cur <= target || ess_one >= target;  // stay or jump: no probe
  bool stop = edge || !bracket_open(lo, hi, iter) || walk<1>(ess0 + 2, first + 2, target, lo,
                                                             hi, iter);
  BRACKET_MARK(6);
  int round = 1;
  while (!stop) {  // the same decisions in every thread of the cluster
    T tree[kTree];
    tree_betas(lo, hi, tree);
    T ess[kTree];
    probe<T, kTree, kResident>(sh, logl, bm, n, aligned, rank, sl, sb, quads, round, tree,
                               ess BRACKET_STAMP_ARGS);
    stop = walk<kBracketLevels>(ess, tree, target, lo, hi, iter);
    BRACKET_MARK(6);
    ++round;
  }
#undef BRACKET_STAMP_ARGS
#ifdef BRACKET_STAMPS
  if (threadIdx.x == 0) {
    stamps[7] = round;
    for (int f = 0; f < kBracketStampFields; ++f) g_bracket_stamps[rank][f] = stamps[f];
  }
#endif
  cluster.sync();  // no CTA exits while another may still write to it

  if (rank == 0 && threadIdx.x == 0) {
    // Stay, or the jump when ESS(beta_prev) > target too (a NaN ESS at
    // beta_prev stays): both ends at the edge, as _find_ess_bracket has it.
    if (edge) lo = hi = (ess_cur > target && ess_one >= target) ? T(1) : beta_prev;
    out[0] = lo;
    out[1] = hi;
    probes_out[0] = 2 + iter;
  }
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(BracketCta<T, kResident>::kThreads, 1)
ess_bracket_kernel(const T* __restrict__ logl, const T* __restrict__ bm,
                   const T* __restrict__ scal, T* __restrict__ bracket,
                   int32_t* __restrict__ probes, int64_t n, int64_t slice) {
  bracket_search<T, kResident>(logl, bm, scal, bracket, probes, n);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int32_t*, int64_t, int64_t);

template <typename T, bool kResident, bool kBracket>
struct Kernel {
  static KernelFn<T> fn() {
    return kBracket ? ess_bracket_kernel<T, kResident> : ess_bisect_kernel<T, kResident>;
  }
  static constexpr int kThreads =
      kBracket ? BracketCta<T, kResident>::kThreads : Cta<T>::kThreads;
};

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
  using K = Kernel<T, kResident, kBracket>;
  const KernelFn<T> kernel = K::fn();
  const int smem = kResident ? static_cast<int>(kSliceBytes) : 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    ClusterLaunch one(K::kThreads, smem, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &one.cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  }
  checked[device] = true;
  status[device] = err;
  return err;
}

// The dynamic shared memory of a launch: the bisection's slice, or the
// bracket's chunks (within the slice's maximum when S <= kCluster x it:
// that maximum is a whole number of chunks).
template <typename T, bool kResident, bool kBracket>
size_t launch_smem(int64_t n, int64_t slice) {
  if (!kResident) return 0;
  const int64_t samples =
      kBracket ? ((n + kChunk - 1) / kChunk + kCluster - 1) / kCluster * kChunk : slice;
  static_assert(kSliceMax % kChunk == 0 && (kSliceMax / 2) % kChunk == 0,
                "a slice holds whole chunks");
  return static_cast<size_t>(2 * sizeof(T) * samples);
}

template <typename T, bool kResident, bool kBracket>
cudaError_t launch(const T* logl, const T* bm, const T* scal, T* out, int32_t* probes, int64_t n,
                   int64_t slice, cudaStream_t stream) {
  cudaError_t err = prepare<T, kResident, kBracket>();
  if (err != cudaSuccess) return err;
  using K = Kernel<T, kResident, kBracket>;
  ClusterLaunch one(K::kThreads, launch_smem<T, kResident, kBracket>(n, slice), stream);
  err = cudaLaunchKernelEx(&one.cfg, K::fn(), logl, bm, scal, out, probes, n, slice);
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
// in float64: the same arguments and route (`resident`: the live samples
// held in shared memory), but `bracket` is (2,) out, (lo, hi), and `probes`
// counts the ESS evaluations of the bracket search (2 + its bisection
// probes).
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
