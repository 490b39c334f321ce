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
// What bounds it on this card: the chain. A column is one dependent chain of
// additions, so it takes at least (crossing index) x the FADD latency (about
// 4 cycles): for the large-ensemble fit (K, n, d) = (1, 524,288, 10), whose
// crossings lie near n / 2, about 0.53 ms at the 1.98 GHz boost clock. The
// bytes (order read once, K n d gathered weights) would take 0.02 ms at
// 3.35 TB/s. ATen's scan runs the same chain, but its one thread also waits
// for each gathered load in turn (about 241 ns a step on the H100, PERF.md):
// 127 ms at B's shape, where this kernel takes 0.95 ms.
//
// What this design does about it:
//  - One CTA a column (K d CTAs), of kThreads threads. Thread 0 runs the
//    chain; warps 1 and up gather the column's next tile of weights
//    wbar[k, order[i, j]] into shared memory while the chain runs on the
//    current one (two tiles, a CTA barrier between tiles), kBatch
//    independent loads in flight a thread. The whole CTA gathers the first
//    tile.
//  - The chain reads 128 staged bytes at a time (32 floats or 16 doubles,
//    16-byte shared loads), the next group loaded before the current one is
//    added, and tests the group's running sums with one predicate chain and
//    one branch; only a group that crosses is searched for its first
//    crossing. The branches set the pace more than the tests: at B's shape
//    8 values a group took 1.59 ms (12 cycles a value), 32 take 0.95 ms,
//    and one test a group instead of one a value would save 3-5 % more
//    (NVIDIA H100, scripts/median_designs.py). After the crossing tile, the
//    CTA stops.
//  - A row of wbar that is all zero never crosses: its result is d_sorted[0,
//    j] at once. The CTA tests this first, kThreads x 4 weights a round,
//    and stops at the first nonzero weight (one round for most rows). An
//    empty mode of a clustered fit is such a row.
//  - The tile past n is padded with zeros, which cannot make a sum cross
//    that did not cross before, so the chain runs whole groups.
// Nothing is atomic and the sums go in one order: a launch repeats its bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps: warp 0 holds the chain thread, 1-7 gather
constexpr int kTileBytes = 16384;   // one staged tile; two of them
constexpr int kBatch = 8;           // loads in flight a gathering thread
constexpr int kGroupBytes = 128;    // what the chain reads at a time: 32 floats or 16 doubles

template <typename T>
struct Tile {
  static constexpr int kSize = kTileBytes / static_cast<int>(sizeof(T));  // 4096 or 2048
  static constexpr int kGroup = kGroupBytes / static_cast<int>(sizeof(T));
  static constexpr int kGroups = kSize / kGroup;
};

template <typename T>
struct __align__(16) Group {
  T v[Tile<T>::kGroup];
};

// Elements [start, start + kSize) of the column into `tile`, by the threads
// [first, kThreads) of the CTA; past n, zeros.
template <typename T>
__device__ __forceinline__ void gather(T* __restrict__ tile, const T* __restrict__ w,
                                       const int64_t* __restrict__ ord, int64_t n, int d,
                                       int64_t start, int first) {
  constexpr int kSize = Tile<T>::kSize;
  const int stride = kThreads - first;
  for (int e0 = static_cast<int>(threadIdx.x) - first; e0 < kSize; e0 += stride * kBatch) {
    int64_t src[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * stride;
      const int64_t i = start + e;
      src[b] = (e < kSize && i < n) ? __ldg(ord + i * d) : -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * stride;
      if (e < kSize) tile[e] = src[b] >= 0 ? __ldg(w + src[b]) : T(0);
    }
  }
}

// Whether the row w[0, n) holds a weight other than zero (NaN counts): every
// thread of the CTA calls it; it stops at the first round that finds one.
template <typename T>
__device__ __forceinline__ bool any_weight(const T* __restrict__ w, int64_t n) {
  for (int64_t base = 0; base < n; base += 4 * kThreads) {
    bool mine = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t i = base + b * kThreads + threadIdx.x;
      mine |= i < n && !(__ldg(w + i) == T(0));
    }
    if (__syncthreads_or(mine)) return true;
  }
  return false;
}

// The chain over one staged tile: adds its values to `acc` in order; returns
// the index in the tile of the first sum >= thr, or -1. A group's adds and
// tests are straight-line code, one FADD and one predicate update a value;
// the one branch a group (a branch costs the warp more than an add) goes to
// the search of a group that crosses, which adds its values again in the
// same order to find the first crossing.
template <typename T>
__device__ __forceinline__ int chain(const T* __restrict__ tile, T& acc, T thr) {
  constexpr int kGroup = Tile<T>::kGroup;
  constexpr int kGroups = Tile<T>::kGroups;
  const Group<T>* g = reinterpret_cast<const Group<T>*>(tile);
  Group<T> cur = g[0];
  for (int q = 0; q < kGroups; ++q) {
    const Group<T> next = g[min(q + 1, kGroups - 1)];  // ahead of the adds; no branch
    T s = acc;
    bool hit = false;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      s = s + cur.v[e];
      hit |= s >= thr;
    }
    if (hit) {
      T r = acc;
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        r = r + cur.v[e];
        if (r >= thr) return q * kGroup + e;
      }
    }
    acc = s;
    cur = next;
  }
  return -1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_median_kernel(const T* __restrict__ d_sorted, const int64_t* __restrict__ order,
                       const T* __restrict__ wbar, T* __restrict__ mu, int64_t n, int d,
                       T thr) {
  constexpr int kSize = Tile<T>::kSize;
  __shared__ __align__(16) T tiles[2][kSize];
  // The crossing's index, -1 while the chain runs; by tile parity, so that
  // thread 0 never writes the word another warp may still be reading.
  __shared__ int64_t found[2];

  const int col = blockIdx.x;  // k * d + j
  const int k = col / d;
  const int j = col - k * d;
  const T* w = wbar + static_cast<int64_t>(k) * n;
  const int64_t* ord = order + j;

  if (!any_weight(w, n)) {  // uniform: the same barrier result in every thread
    if (threadIdx.x == 0) mu[col] = d_sorted[j];
    return;
  }
  if (threadIdx.x == 0) found[0] = found[1] = -1;
  gather(tiles[0], w, ord, n, d, 0, 0);
  __syncthreads();

  T acc = T(0);  // thread 0's running sum
  int buf = 0;   // the tile the chain reads, and the parity of `found`
  for (int64_t start = 0;; start += kSize) {
    if (threadIdx.x == 0) {
      const int hit = chain(tiles[buf], acc, thr);
      if (hit >= 0) {
        found[buf] = start + hit;
      } else if (start + kSize >= n) {
        found[buf] = 0;  // no crossing: argmax of all-False
      }
    } else if (threadIdx.x >= 32 && start + kSize < n) {
      gather(tiles[buf ^ 1], w, ord, n, d, start + kSize, 32);
    }
    __syncthreads();
    if (found[buf] >= 0) break;  // uniform: read after the barrier
    buf ^= 1;
  }
  if (threadIdx.x == 0) mu[col] = d_sorted[found[buf] * d + j];
}

template <typename T>
int entry(const void* d_sorted, const void* order, const void* wbar, void* mu, int64_t n,
          int64_t d, int64_t k, double thr, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k * d > 0x7fffffff) {
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
