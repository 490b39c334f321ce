// Per-column weighted median for Hopper (sm_90a): the starting location of
// every weighted Student-t fit, in float32 or float64 (a template on the
// scalar type; one C entry each).
//
// Replaces: the three PyTorch lines of the port's CUDA route,
//   cum = torch.cumsum(wbar[..., order], dim=-2)
//   idx = torch.argmax((cum >= 0.5 - 1e-7).to(torch.int8), dim=-2)
//   mu  = d_sorted[idx, j]
// (tempest_tpu_torch/ops/cuda_median.py keeps them as the plain version).
// It is not a Pallas kernel: the JAX package computes this in XLA
// (tempest_tpu/student.py:220-231, `_weighted_median_presorted`).
//
// What it computes, for d_sorted and order (n, d) (the stable column sort of
// the data) and weights wbar (K, n): for each column (k, j) the running sum
// s_i = (((0 + w_0) + w_1) + ... + w_i) of w_i = wbar[k, order[i, j]], added
// one at a time in the scalar type, as CUDA's torch.cumsum along a non-inner
// dimension adds (ATen's tensor_kernel_scan_outer_dim: one thread a column,
// a scalar_t accumulator); idx is the first i with s_i >= thr, thr being
// 0.5 - 1e-7 rounded to the scalar type (the wrapper rounds it as PyTorch
// rounds a Python scalar compared with a tensor), or 0 if there is none, as
// argmax of all-False gives; mu[k, j] = d_sorted[idx, j]. The result is the
// plain version's bit for bit: a tree (parallel) scan would round the sums
// differently and move the crossing.
//
// Why only the nonzero weights are added (the exactness argument). The sum
// starts at +0. In round-to-nearest, s + (+0) and s + (-0) are s for every s
// other than -0 (NaN and the infinities included), and +0 + (-0) is +0; a
// sum of this chain is never -0 (that needs -0 + -0, or x + (-x) rounding
// down). So a zero weight leaves the running sum bit for bit as it was, and
// a zero weight cannot be the first crossing: s_i = s_{i-1} < thr before the
// first crossing, and s_{-1} = +0 < thr since thr > 0. The chain over the
// nonzero weights alone, in order (NaN counts as nonzero: !(w == 0)), takes
// the same sums at the same points, and its first crossing, mapped back to
// its index in the column, is the plain version's; none gives index 0. The
// same holds for zeros padded after a group's values.
//
// What bounds it on this card: the chain. A column's nonzero weights up to
// its crossing are one dependent chain of additions, so a column takes at
// least (those weights) x the FADD latency (about 4 cycles); the bytes are
// the order entries and weights up to the crossing (chip_smoke.py's
// `median_bound`). Before the first add, a gathered weight costs two
// dependent loads (order, then wbar), served from L2 on the fit's paths.
//
// What this design does about it (the design of 63fe4b1 scanned each row for
// a nonzero weight in every CTA, gathered a whole 16 KB tile, passed a CTA
// barrier and only then added, zeros included; its chain tested each sum
// with a predicate chain that set the pace at about 7 cycles a value):
//  - One CTA a column (K d CTAs) of kThreads threads. Warps 1 to 7 gather;
//    lane 0 of warp 0 runs the chain. A stage is kStage = 256 consecutive
//    points of the column: its gathering warp loads their order entries and
//    then their weights, kBatch = 8 independent loads in flight a lane, and
//    compacts the nonzero weights, in order, with their indices (a ballot
//    and a popc prefix a batch), padded with zeros to a whole group; it
//    notes whether the stage's weights are all >= 0 and none NaN (a
//    "rising" stage, as every stage of a fit's weights is). Copying a row of
//    up to 64 KB into shared memory first, so the gather reads it there,
//    was tried and not kept: at A's fit rows the first stage came ready at
//    3.6-5.1 us instead of 3.3 (the stamps; PERF.md).
//  - A ring of kRing stages between the gatherers and the chain, with one
//    mbarrier a stage each way (full: the 32 lanes of its gathering warp
//    arrive; empty: the chain thread arrives), so no CTA barrier passes after
//    the start: the chain starts on the first stage, the gatherers run up to
//    kRing stages ahead, and a gathering warp starts a stage's loads before
//    it waits for the stage's slot.
//  - The chain reads a group of 128 bytes (32 floats or 16 doubles) with
//    16-byte shared loads and tests the group once. On a rising stage the
//    sums cannot fall, so the test is the last sum alone and nothing but
//    the adds sits on the chain (63fe4b1 chained a predicate through every
//    sum): two groups an iteration in two sets of registers, the next
//    group's loads started before the current one's adds, one compare and
//    one branch a pair of groups (a branch a group cost B about 6 cycles a
//    value where the add takes 4); a group that crosses is added again from
//    its start to find the first crossing. On any other stage the test is the
//    sums' maximum by a tree (fmax drops NaN, so it is at or above thr
//    exactly when some sum is), which ptxas schedules after the adds.
//  - When the chain ends (a crossing, or every stage added), the chain
//    thread writes mu, raises a stop flag and arrives once on every slot's
//    empty barrier, so a gatherer waiting for a slot wakes, reads the flag
//    and returns. An all-zero row has an empty chain: index 0.
// Nothing is atomic and the sums go in one order: a launch repeats its bits.
//
// Built with -DMEDIAN_STAMPS (chip_smoke.py phase 4c), median_stamps.cuh
// records clock64 marks of each column (design note there).

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef MEDIAN_STAMPS
#include "median_stamps.cuh"
#endif

namespace {

constexpr int kThreads = 256;                  // warp 0: the chain; warps 1-7 gather
constexpr int kGatherers = kThreads / 32 - 1;  // gathering warps
constexpr int kBatch = 8;                      // loads in flight a gathering lane
constexpr int kStage = 32 * kBatch;            // points a stage covers
constexpr int kRing = 8;                       // stages between the gatherers and the chain
constexpr int kGroupBytes = 128;               // what the chain reads at a time

// A gathering warp waits for its slot's previous stage, kRing stages back,
// by the parity of that stage's use of the slot: right only while no
// gatherer can be a whole ring ahead of another, which kGatherers <= kRing
// ensures (a gatherer's previous stage, kGatherers back, needed the stage
// kRing before that added).
static_assert(kGatherers <= kRing, "the empty barriers' parities need kGatherers <= kRing");

template <typename T>
struct Chain {
  static constexpr int kGroup = kGroupBytes / static_cast<int>(sizeof(T));  // 32 or 16
  static_assert(kStage % kGroup == 0 && kGroup <= 32, "a stage pads to whole groups");
};

// A group of kGroup values from shared memory (16-byte aligned) into
// registers, 16 bytes a load.
template <typename T>
__device__ __forceinline__ void load_group(const T* src, T (&v)[Chain<T>::kGroup]) {
  if constexpr (sizeof(T) == 4) {
    const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int i = 0; i < Chain<T>::kGroup / 4; ++i) {
      const float4 x = p[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
    const double2* p = reinterpret_cast<const double2*>(src);
#pragma unroll
    for (int i = 0; i < Chain<T>::kGroup / 2; ++i) {
      const double2 x = p[i];
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  }
}

template <typename T>
struct __align__(16) Ring {
  T val[kRing][kStage];        // a stage's nonzero weights in order, then zeros to a group
  int32_t idx[kRing][kStage];  // their indices in the column
  int count[kRing];            // the stage's values, padded to whole groups
  int rising[kRing];           // its values are all >= 0 (no NaN): its sums cannot fall
  uint64_t full[kRing];        // a stage is staged: its gathering warp's 32 lanes arrive
  uint64_t empty[kRing];       // a stage is added: the chain thread arrives
  int stop;                    // the chain has ended
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrives on the barrier, releasing this thread's earlier writes to the CTA.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

// Whether the barrier's phase of this parity has completed (acquiring the
// arrivals' writes); it may wait a while before it answers false.
__device__ __forceinline__ bool bar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// The maximum of v[B, B + N) by a pairwise tree, every index known at
// compile time so the values stay in registers (a loop over the tree's
// levels compiled to predicated moves, and set the chain's pace at 14
// cycles a value).
template <int B, int N, typename T, int M>
__device__ __forceinline__ T tree_max(const T (&v)[M]) {
  if constexpr (N == 1) {
    return v[B];
  } else {
    return vmax(tree_max<B, N / 2>(v), tree_max<B + N / 2, N - N / 2>(v));
  }
}

template <typename T>
__device__ __forceinline__ bool stopped(const Ring<T>& r) {
  return *reinterpret_cast<const volatile int*>(&r.stop) != 0;
}

// The order entries of stage s's points, kBatch a lane; -1 past n.
__device__ __forceinline__ void load_order(const int64_t* __restrict__ ord, int64_t n, int d,
                                           int64_t s, int lane, int64_t (&src)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int64_t i = s * kStage + b * 32 + lane;
    src[b] = i < n ? __ldg(ord + i * d) : -1;
  }
}

// A gathering warp (warp >= 1): stages warp - 1, warp - 1 + kGatherers, ...
// until the last or the stop.
template <typename T>
__device__ __forceinline__ void gather(Ring<T>& r, const T* __restrict__ w,
                                       const int64_t* __restrict__ ord, int64_t n, int d,
                                       int64_t stages, int warp, int lane) {
  constexpr int kGroup = Chain<T>::kGroup;
  const unsigned below = (1u << lane) - 1u;
#ifdef MEDIAN_STAMPS
  long long* st = blockIdx.x < kStampColumns && warp == 1 && lane == 0 ? g_stamps[blockIdx.x]
                                                                        : nullptr;
  if (st != nullptr) st[7] = clock64();
#endif
  for (int64_t s = warp - 1; s < stages; s += kGatherers) {
    const int64_t base = s * kStage;
    int64_t src[kBatch];
    load_order(ord, n, d, s, lane, src);
#ifdef MEDIAN_STAMPS
    if (st != nullptr && s == 0) st[8] = clock_after(src[0], src[kBatch - 1]);
#endif
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = src[b] < 0 ? T(0) : __ldg(w + src[b]);
    }
#ifdef MEDIAN_STAMPS
    if (st != nullptr && s == 0) st[9] = clock_after(v[0], v[kBatch - 1]);
#endif
    const int slot = static_cast<int>(s % kRing);
    if (s >= kRing) {  // the slot's last stage, s - kRing, must be added first
      const uint32_t parity = static_cast<uint32_t>((s / kRing - 1) & 1);
      for (;;) {  // warp-uniform: a completed phase stays completed for every lane
        const bool done = bar_done(&r.empty[slot], parity);
        if (__any_sync(0xffffffffu, stopped(r))) return;
        if (__all_sync(0xffffffffu, done)) break;
      }
    }
    if (__any_sync(0xffffffffu, stopped(r))) return;
    int total = 0;
    bool rising = true;  // every value >= 0, none NaN: the stage's sums cannot fall
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      rising &= v[b] >= T(0);
      const bool keep = !(v[b] == T(0));  // NaN is kept
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int p = total + __popc(mask & below);
        r.val[slot][p] = v[b];
        r.idx[slot][p] = static_cast<int32_t>(base + b * 32 + lane);
      }
      total += __popc(mask);
    }
    const int padded = (total + kGroup - 1) / kGroup * kGroup;
    if (total + lane < padded) r.val[slot][total + lane] = T(0);
    rising = __all_sync(0xffffffffu, rising);
    if (lane == 0) {
      r.count[slot] = padded;
      r.rising[slot] = rising;
    }
    bar_arrive(&r.full[slot]);
#ifdef MEDIAN_STAMPS
    if (st != nullptr && s == 0) st[10] = clock64();
#endif
  }
}

// The index in a group of the first running sum >= thr, the group's values
// added again from `acc` in the same order (the same sums, bit for bit);
// called for a group whose sums reach thr.
template <typename T>
__device__ __forceinline__ int first_crossing(const T (&v)[Chain<T>::kGroup], T acc, T thr) {
  int first = -1;
#pragma unroll
  for (int e = 0; e < Chain<T>::kGroup; ++e) {
    acc = acc + v[e];
    if (first < 0 && acc >= thr) first = e;
  }
  return first;
}

// A rising stage's groups from `base` (`groups` > 0 of them) added to
// `acc`: the index in the stage of the first crossing, or -1 with `acc` the
// stage's last sum. Its sums cannot fall, so the last sum of a pair of
// groups is their maximum and the only one tested: the adds, then one test
// and one branch a pair (crossed, or the stage's end). Each group's loads
// are started before the adds of the one before it, into the other set of
// registers; the group that crosses is loaded again to find the crossing.
template <typename T>
__device__ __forceinline__ int add_rising(const T* base, int groups, T& acc, T thr) {
  constexpr int kGroup = Chain<T>::kGroup;
  T a[kGroup], b[kGroup];
  load_group(base, a);
  int q = 0;  // the pair's first group
  T s1, s2;
  bool two;   // the pair has a second group
  for (;;) {
    two = q + 1 < groups;
    load_group(base + min(q + 1, groups - 1) * kGroup, b);
    s1 = acc;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) s1 = s1 + a[e];
    load_group(base + min(q + 2, groups - 1) * kGroup, a);
    s2 = s1;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) s2 = s2 + b[e];
    if ((two ? s2 : s1) >= thr || q + 2 >= groups) break;
    acc = s2;
    q += 2;
  }
  if (s1 >= thr) {
    load_group(base + q * kGroup, a);
    return q * kGroup + first_crossing(a, acc, thr);
  }
  if (two && s2 >= thr) {
    load_group(base + (q + 1) * kGroup, b);
    return (q + 1) * kGroup + first_crossing(b, s1, thr);
  }
  acc = two ? s2 : s1;
  return -1;
}

// Any other stage's groups (a value < 0 or NaN among them): each group's
// test is the sums' maximum (fmax drops NaN, so it is >= thr exactly when
// some sum is), a tree over all but the last sum, then the last.
template <typename T>
__device__ __forceinline__ int add_any(const T* base, int groups, T& acc, T thr) {
  constexpr int kGroup = Chain<T>::kGroup;
  for (int q = 0; q < groups; ++q) {
    T v[kGroup], sums[kGroup];
    load_group(base + q * kGroup, v);
    T s = acc;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      s = s + v[e];
      sums[e] = s;
    }
    if (vmax(tree_max<0, kGroup - 1>(sums), s) >= thr) {
      return q * kGroup + first_crossing(v, acc, thr);
    }
    acc = s;
  }
  return -1;
}

// The chain thread: the stages in order; the crossing's index, or 0.
template <typename T>
__device__ __forceinline__ int64_t chain(Ring<T>& r, int64_t stages, T thr) {
  constexpr int kGroup = Chain<T>::kGroup;
#ifdef MEDIAN_STAMPS
  long long* st = blockIdx.x < kStampColumns ? g_stamps[blockIdx.x] : nullptr;
  long long t_start = clock64(), t_first = 0, waited = 0, added = 0, values = 0, used = 0;
#endif
  T acc = T(0);
  int64_t found = 0;
  for (int64_t s = 0; s < stages; ++s) {
    const int slot = static_cast<int>(s % kRing);
    const uint32_t parity = static_cast<uint32_t>((s / kRing) & 1);
#ifdef MEDIAN_STAMPS
    const long long t0 = clock64();
#endif
    while (!bar_done(&r.full[slot], parity)) {
    }
#ifdef MEDIAN_STAMPS
    const long long t1 = clock64();
    waited += t1 - t0;
    if (s == 0) t_first = t1;
    used = s + 1;
#endif
    const int groups = r.count[slot] / kGroup;
    const int hit = groups == 0     ? -1
                    : r.rising[slot] ? add_rising(r.val[slot], groups, acc, thr)
                                     : add_any(r.val[slot], groups, acc, thr);
#ifdef MEDIAN_STAMPS
    values += hit >= 0 ? static_cast<long long>(hit) + 1 : static_cast<long long>(groups) * kGroup;
    added += clock64() - t1;
#endif
    if (hit >= 0) {
      found = r.idx[slot][hit];
      break;
    }
    bar_arrive(&r.empty[slot]);
  }
#ifdef MEDIAN_STAMPS
  if (st != nullptr) {
    st[0] = t_start;
    st[1] = t_first;
    st[2] = waited;
    st[3] = added;
    st[4] = clock64();
    st[5] = used;
    st[6] = values;
  }
#endif
  return found;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
weighted_median_kernel(const T* __restrict__ d_sorted, const int64_t* __restrict__ order,
                       const T* __restrict__ wbar, T* __restrict__ mu, int64_t n, int d,
                       T thr) {
  __shared__ Ring<T> ring;
  const int col = blockIdx.x;  // k * d + j
  const int k = col / d;
  const int j = col - k * d;
  const int64_t stages = (n + kStage - 1) / kStage;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      bar_init(&ring.full[i], 32);
      bar_init(&ring.empty[i], 1);
    }
    ring.stop = 0;
  }
  __syncthreads();  // the only CTA barrier
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  if (warp > 0) {
    gather(ring, wbar + static_cast<int64_t>(k) * n, order + j, n, d, stages, warp, lane);
    return;
  }
  if (lane != 0) return;
  const int64_t idx = chain(ring, stages, thr);
  mu[col] = d_sorted[idx * d + j];
  // Stop the gatherers: the flag, then one arrival on every slot's empty
  // barrier, which completes the phase a waiting gatherer waits for (the
  // arrival releases the flag to it).
  *reinterpret_cast<volatile int*>(&ring.stop) = 1;
  for (int i = 0; i < kRing; ++i) bar_arrive(&ring.empty[i]);
}

template <typename T>
int entry(const void* d_sorted, const void* order, const void* wbar, void* mu, int64_t n,
          int64_t d, int64_t k, double thr, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k * d > 0x7fffffff || n > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  weighted_median_kernel<T><<<static_cast<unsigned>(k * d), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d_sorted), static_cast<const int64_t*>(order),
      static_cast<const T*>(wbar), static_cast<T*>(mu), n, static_cast<int>(d),
      static_cast<T>(thr));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes: tempest_weighted_median in float32,
// tempest_weighted_median_f64 in float64. d_sorted: (n, d) of the type;
// order: (n, d) int64, each column a permutation of [0, n); wbar: (k, n) of
// the type; mu: (k, d) out; thr: the crossing threshold, already rounded to
// the type. Each launches on `stream` of the current device without
// synchronising and returns a cudaError_t.
extern "C" int tempest_weighted_median(const void* d_sorted, const void* order, const void* wbar,
                                       void* mu, int64_t n, int64_t d, int64_t k, double thr,
                                       void* stream) {
  return entry<float>(d_sorted, order, wbar, mu, n, d, k, thr, stream);
}

extern "C" int tempest_weighted_median_f64(const void* d_sorted, const void* order,
                                           const void* wbar, void* mu, int64_t n, int64_t d,
                                           int64_t k, double thr, void* stream) {
  return entry<double>(d_sorted, order, wbar, mu, n, d, k, thr, stream);
}
