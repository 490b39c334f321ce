// Device code shared by the two EM kernels of the fits (gmm_em.cu,
// mvstud_em.cu), for Hopper (sm_90a), templated on the scalar type.
//
// Both kernels run a whole EM loop in one launch. A fit is served by G CTAs
// (`Geometry`): CTA r owns the points [r n / G, (r + 1) n / G), holds them
// and their per-point values in shared memory for the whole launch where
// they fit, and keeps its own copy of the fit's parameters, so every CTA of
// a fit takes the same decisions without broadcasts. A fit's G CTAs are one
// thread-block cluster (G <= 16; several fits a launch), or, for a launch
// of one fit, the whole grid of up to one CTA an SM, launched cooperatively
// so that all are resident and the grid's barrier holds (`FitSync`). Every
// sum over the points is a reduction in a fixed order:
//  - over a CTA: warp shuffles (an xor tree), then the warps' partials added
//    in warp order (`cta_sum`), or per entry over the CTA's resident points
//    by a few lanes, shuffled together (`entry_sums`); in double (`Acc`);
//  - over the fit (`fit_sum`): each CTA writes its partials to its row of a
//    global buffer (L2: __stcg / __ldcg), the fit synchronises once, and
//    every CTA adds the G rows itself, a few lanes an entry in one fixed
//    tree, so all hold the same totals bit for bit; with many entries each
//    CTA adds a share of them and a second synchronisation hands the
//    totals round. Rows are
//    double-buffered by reduction parity, so a CTA never overwrites a row
//    another CTA may still read.
// The factorizations need no CTA-wide barrier at d <= 32: one warp factors
// a matrix, lanes as rows (`warp_cholesky`), and inverts the factor, lanes
// as columns (`warp_inverse`); several components factor at once, a warp
// each. Past d = 32 the CTA
// factors in panels of 32 columns, three barriers a panel (`cta_cholesky`).
// Symmetric matrices and factors are kept as packed lower triangles (`tri`).
// Nothing that a sum depends on is atomic: a launch repeats its bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "em_stamps.cuh"

namespace em {

namespace cg = cooperative_groups;

// Threads a CTA: 255 registers a thread at most, where neither kernel
// spills (at 384 or 512 threads, capped at 170 or 128, both do).
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;      // a non-portable cluster size
constexpr int kMinPoints = 128;      // a fit spreads over CTAs of at least this many points
constexpr int kRed = 16;             // sums a cta_sum takes at most

// Every sum accumulates in double, in float32 too, and is rounded to the
// type once where a CTA's partial or a fit's total is stored: the float32
// sums of a fit's thousands of points then differ from the exact ones by
// about one rounding, less than the plain loop's own sums do, so the
// kernels' float32 trajectories keep to the plain loop's through the
// iterations whose exit or dof cell a float32 rounding can tip.
using Acc = double;
constexpr int kHeaderBytes = 256;    // the flags at the start of shared memory
constexpr int64_t kMaxSmem = 232448; // 227 KB of dynamic shared memory a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float em_log(float x) { return logf(x); }
__device__ __forceinline__ double em_log(double x) { return log(x); }
__device__ __forceinline__ float em_exp(float x) { return expf(x); }
__device__ __forceinline__ double em_exp(double x) { return exp(x); }
__device__ __forceinline__ float em_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double em_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float em_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double em_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float em_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double em_abs(double x) { return fabs(x); }
__device__ __forceinline__ bool em_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool em_finite(double x) { return isfinite(x); }
__device__ __forceinline__ float em_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double em_pow(double x, double y) { return pow(x, y); }
// a * b and a + b each rounded, as the plain loops' separate operations round
// them: nvcc would contract a * b + c into one fused multiply-add.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// Entry (i, j), j <= i, of a packed lower triangle stored by rows.
__host__ __device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// (i, j) of the r-th entry of a packed lower triangle.
__device__ __forceinline__ void tri_index(int r, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * static_cast<float>(r) + 1.0f) - 1.0f) * 0.5f);
  while (tri(i, 0) > r) --i;
  while (tri(i + 1, 0) <= r) ++i;
  j = r - tri(i, 0);
}

// The row stride of points in shared memory: odd, so that a warp reading
// one value of 32 points touches (nearly) 32 banks.
__host__ __device__ __forceinline__ int smem_stride(int d) { return d | 1; }

// ---------------------------------------------------------------------------
// The launch's geometry
// ---------------------------------------------------------------------------
// G CTAs a fit. One fit of more than kMaxCluster * kMinPoints points takes
// the grid (`grid_route`): G = min(SMs, n / kMinPoints), a cooperative
// launch. Otherwise a fit is a cluster of G CTAs: the largest G up to
// kMaxCluster with the launch within the card's SMs, every CTA holding
// kMinPoints points (`largest_cluster`), and all the launch's clusters
// resident at once (the occupancy query, `resident_clusters`: on an H100
// not every GPC holds two clusters of 8, so 16 fits may take fewer).
inline bool grid_route(int64_t fits, int64_t n) {
  return fits == 1 && n > static_cast<int64_t>(kMaxCluster) * kMinPoints;
}

inline int64_t grid_ctas(int64_t n, int sms) {
  const int64_t want = n / kMinPoints;
  return want < sms ? want : sms;
}

inline int64_t largest_cluster(int64_t fits, int64_t n, int sms) {
  int64_t c = kMaxCluster;
  if (c > sms / fits) c = sms / fits;
  if (c > n / kMinPoints) c = n / kMinPoints;
  return c < 1 ? 1 : c;
}

// Clusters of `cluster` CTAs of `kernel` that can be resident at once.
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, int threads, int64_t smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size the card refuses: no cluster
    return 0;
  }
  return clusters;
}

// The SMs of the current device.
inline int device_sms() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// Synchronisation of a fit's CTAs
// ---------------------------------------------------------------------------
// A fit's barrier: the cluster's, or, for a fit over the whole grid (a
// cooperative launch), the grid's. Both release the CTAs' writes before it
// and acquire them after.
struct FitSync {
  bool grid;

  __device__ void sync() const {
    if (grid) {
      cg::this_grid().sync();
    } else {
      cg::this_cluster().sync();
    }
  }
};

// ---------------------------------------------------------------------------
// Sums
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The sum of v over the L lanes of an aligned group (L a power of two <= 32),
// in one xor tree; every lane of the group gets it. All 32 lanes call it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int L) {
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The CTA's sum of each thread's v[r] into out[r]: a warp's xor tree, then
// the warps' partials added in warp order by thread r (which alone writes
// out[r]), all in double (`Acc`), rounded to the type once. `red` holds
// kRed x 32 doubles; one barrier.
template <int R, typename T>
__device__ __forceinline__ void cta_sum(Acc (&v)[R], Acc* red, T* out) {
  static_assert(R <= kRed, "cta_sum: too many sums");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = warp_sum(v[r]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) red[r * 32 + warp] = v[r];
  }
  __syncthreads();
  if (t < R) {
    Acc s = red[t * 32];
    for (int w = 1; w < nw; ++w) s += red[t * 32 + w];
    out[t] = static_cast<T>(s);
  }
}

// The CTA's sums out[0, E) over its np resident points: `entry(e)` gives
// entry e's value at point p as entry(e)(p). L lanes share an entry, each
// adding every L-th point in four partial sums, then an xor tree, in
// rounds of threads / L entries; L, a power of two up to 32, makes the
// rounds times a lane's chain (its points and the tree's steps) least, as
// the CTA's loops are latency-bound.
template <typename T, typename Entries>
__device__ void entry_sums(const Entries& entries, int E, int np, T* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  int L = 1;
  int64_t best = -1;
  for (int l = 1, depth = 0; l <= 32; l *= 2, ++depth) {  // rounds x a lane's chain
    const int64_t rounds = (static_cast<int64_t>(E) * l + nt - 1) / nt;
    const int64_t cost = rounds * ((np + l - 1) / l + 2 * depth);
    if (best < 0 || cost < best) {
      best = cost;
      L = l;
    }
  }
  const int lane = t & (L - 1), per_round = nt / L;
  for (int e0 = 0; e0 < E; e0 += per_round) {
    const int e = e0 + t / L;
    Acc v = 0.0;
    if (e < E) {  // four partial sums in flight, added in a fixed order
      const auto value = entries(e);
      Acc v1 = 0.0, v2 = 0.0, v3 = 0.0;
      int p = lane;
      for (; p + 3 * L < np; p += 4 * L) {
        v += static_cast<Acc>(value(p));
        v1 += static_cast<Acc>(value(p + L));
        v2 += static_cast<Acc>(value(p + 2 * L));
        v3 += static_cast<Acc>(value(p + 3 * L));
      }
      for (; p < np; p += L) v += static_cast<Acc>(value(p));
      v = (v + v1) + (v2 + v3);
    }
    v = group_sum(v, L);
    if (lane == 0 && e < E) out[e] = static_cast<T>(v);
  }
}

// The fit's sums of each CTA's mine[0, R) into tot[0, R) of every CTA. Each
// CTA stores its row of `rows` (G rows of `stride`, then one row of totals)
// and the fit synchronises. Then L lanes take an entry (L the power of two
// >= G, at most 32), each adding every L-th row in rank order, four loads
// in flight, and an xor tree adds the lanes: every CTA so adds all R
// entries itself where that takes at most four rounds of the CTA's
// threads; with more entries CTA r adds only its share of them into the
// totals' row, and a second synchronisation hands them round. Begins and
// ends with a barrier.
template <typename T>
__device__ void fit_sum(const FitSync& s, T* rows, int64_t stride, int rank, int G, int R,
                        const T* mine, T* tot) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  for (int e = t; e < R; e += nt) __stcg(rows + rank * stride + e, mine[e]);
  s.sync();
  int L = 1;
  while (L < G && L < 32) L *= 2;
  const int lane = t & (L - 1), per_round = nt / L;
  const bool all = R <= 4 * per_round;
  const int lo = all ? 0 : static_cast<int>(static_cast<int64_t>(R) * rank / G);
  const int hi = all ? R : static_cast<int>(static_cast<int64_t>(R) * (rank + 1) / G);
  T* totals = rows + G * stride;
  for (int e0 = lo; e0 < hi; e0 += per_round) {
    const int e = e0 + t / L;
    Acc v = 0.0;
    if (e < hi) {
      for (int r0 = lane; r0 < G; r0 += 4 * L) {
        T u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u[r] = r0 + r * L < G ? __ldcg(rows + (r0 + r * L) * stride + e) : T(0);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r0 + r * L < G) v += static_cast<Acc>(u[r]);
        }
      }
    }
    v = group_sum(v, L);
    if (lane == 0 && e < hi) {
      if (all) {
        tot[e] = static_cast<T>(v);
      } else {
        __stcg(totals + e, static_cast<T>(v));
      }
    }
  }
  if (!all) {
    s.sync();
    for (int e = t; e < R; e += nt) tot[e] = __ldcg(totals + e);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Factorizations (packed lower triangles)
// ---------------------------------------------------------------------------
// One warp, lanes as rows: the Cholesky factor, in place, of rows and
// columns [c0, c0 + nb) of A (nb <= 32), left-looking within the block,
// whose columns < c0 are already applied (the diagonal block of a panel;
// c0 = 0, nb = d factors a whole matrix of d <= 32). False where a pivot is
// not positive (NaN included), as LAPACK's potrf reports info > 0, or a
// factor entry is not finite; warp-uniform. No barrier besides __syncwarp.
template <typename T>
__device__ bool warp_cholesky(T* A, int c0, int nb) {
  const int lane = threadIdx.x & 31;
  const int i = c0 + lane;
  bool fin = true;
  for (int c = 0; c < nb; ++c) {
    const int j = c0 + c;
    T v = T(0);
    if (lane >= c && lane < nb) {
      v = A[tri(i, j)];
      for (int k = c0; k < j; ++k) v -= A[tri(i, k)] * A[tri(j, k)];
    }
    const T piv = __shfl_sync(kFull, v, c);
    if (!(piv > T(0))) return false;  // warp-uniform: every lane has piv
    const T r = em_sqrt(piv);
    if (lane >= c && lane < nb) {
      const T l = lane == c ? r : v / r;
      A[tri(i, j)] = l;
      fin = fin && em_finite(l);
    }
    __syncwarp();
  }
  return __all_sync(kFull, fin);
}

// One warp, lanes as columns: Li = L^-1 of a packed factor of d <= 32 rows
// by forward substitution, as solve_triangular(L, I) gives it.
template <typename T>
__device__ void warp_inverse(const T* L, T* Li, int d) {
  const int j = threadIdx.x & 31;
  if (j < d) {
    for (int i = j; i < d; ++i) {
      T s = i == j ? T(1) : T(0);
      for (int m = j; m < i; ++m) s -= L[tri(i, m)] * Li[tri(m, j)];
      Li[tri(i, j)] = s / L[tri(i, i)];
    }
  }
  __syncwarp();
}

// The CTA's Cholesky factor, in place, of a packed A of any d, in panels of
// 32 columns: the panel minus the columns before it (every thread), its
// diagonal block by warp 0 (warp_cholesky), the rows below it by forward
// substitution (a thread a row). Three barriers a panel. False as
// warp_cholesky; CTA-uniform. `flag` is one int of shared memory.
template <typename T>
__device__ bool cta_cholesky(T* A, int d, int* flag) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int nb = d - c0 < 32 ? d - c0 : 32;
    if (c0 > 0) {
      for (int q = t; q < (d - c0) * nb; q += nt) {
        const int i = c0 + q / nb, j = c0 + q % nb;
        if (j <= i) {
          T v = A[tri(i, j)];
          for (int k = 0; k < c0; ++k) v -= A[tri(i, k)] * A[tri(j, k)];
          A[tri(i, j)] = v;
        }
      }
      __syncthreads();
    }
    if (t < 32) {
      const bool ok = warp_cholesky(A, c0, nb);
      if (t == 0) *flag = ok;
    }
    __syncthreads();
    if (!*flag) return false;
    bool fin = true;
    for (int i = c0 + nb + t; i < d; i += nt) {
      for (int j = c0; j < c0 + nb; ++j) {
        T v = A[tri(i, j)];
        for (int k = c0; k < j; ++k) v -= A[tri(i, k)] * A[tri(j, k)];
        v = v / A[tri(j, j)];
        A[tri(i, j)] = v;
        fin = fin && em_finite(v);
      }
    }
    if (!__syncthreads_and(fin)) return false;
  }
  return true;
}

// The CTA's Li = L^-1 of a packed factor of any d: a thread a column, by
// forward substitution. Ends with a barrier.
template <typename T>
__device__ void cta_inverse(const T* L, T* Li, int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    for (int i = j; i < d; ++i) {
      T s = i == j ? T(1) : T(0);
      for (int m = j; m < i; ++m) s -= L[tri(i, m)] * Li[tri(m, j)];
      Li[tri(i, j)] = s / L[tri(i, i)];
    }
  }
  __syncthreads();
}

// The squared distance |Li (x - m)|^2 of a point x (d values), taken by the
// g lanes of an aligned group (g a power of two), lane q adding the rows
// q, q + g, ...; every lane of the group gets the sum. All 32 lanes call it.
template <typename T>
__device__ __forceinline__ T mahalanobis(const T* Li, const T* m, const T* x, int d, int q,
                                         int g, bool valid) {
  T part = T(0);
  if (valid) {
    for (int i = q; i < d; i += 2 * g) {  // rows i and i + g: two sums in flight
      const int i2 = i + g;
      const T* row = Li + tri(i, 0);
      const T* row2 = Li + tri(i2 < d ? i2 : i, 0);
      T s = T(0), s2 = T(0);
      for (int j = 0; j <= i; ++j) {
        const T dj = x[j] - m[j];
        s += row[j] * dj;
        s2 += row2[j] * dj;
      }
      part += s * s;
      if (i2 < d) {
        for (int j = i + 1; j <= i2; ++j) s2 += row2[j] * (x[j] - m[j]);
        part += s2 * s2;
      }
    }
  }
  return group_sum(part, g);
}

// Lanes a point for the distances: the most, up to 32 and d, with all the
// CTA's np points in one round of the CTA's threads.
__device__ __forceinline__ int lanes_a_point(int np, int d) {
  int g = 1;
  while (g < 32 && g < d && 2 * g * np <= static_cast<int>(blockDim.x)) g *= 2;
  return g;
}

// ---------------------------------------------------------------------------
// The launch
// ---------------------------------------------------------------------------
// A launch of `grid` CTAs of `threads` with `smem` bytes of dynamic shared
// memory: in clusters of `cluster`, or cooperative (every CTA resident at
// once) for a fit over the whole grid.
struct FitLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  FitLaunch(int64_t grid, int cluster, bool cooperative, int threads, int64_t smem,
            cudaStream_t stream)
      : cfg() {
    if (cooperative) {
      attr[0].id = cudaLaunchAttributeCooperative;
      attr[0].val.cooperative = 1;
    } else {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
    }
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Lets `kernel` take non-portable clusters and all of kMaxSmem.
template <typename Kernel>
cudaError_t allow_cluster_and_smem(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
  }
  return err;
}

// Shared memory of a CTA: the base (flags and cta_sum's double partials), then the
// work area (if it fits beside the per-point values), the per-point values
// (if they fit), then the points (if they still fit). Bytes of each, and
// where each lives.
struct SmemPlan {
  int64_t bytes;
  bool work, points, x;
};

inline SmemPlan smem_plan(int64_t elem, int64_t work_elems, int64_t per_point, int64_t np,
                          int64_t ld) {
  SmemPlan p;
  const int64_t base = kHeaderBytes + kRed * 32 * static_cast<int64_t>(sizeof(Acc));
  const int64_t work = work_elems * elem, pts = per_point * np * elem, xs = ld * np * elem;
  p.work = base + work <= kMaxSmem;
  int64_t used = base + (p.work ? work : 0);
  p.points = used + pts <= kMaxSmem;
  used += p.points ? pts : 0;
  p.x = used + xs <= kMaxSmem;
  p.bytes = used + (p.x ? xs : 0);
  return p;
}

}  // namespace em
