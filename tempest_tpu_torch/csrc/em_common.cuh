// Device code shared by the two EM kernels of the fits (gmm_em.cu,
// mvstud_em.cu), for Hopper (sm_90a), templated on the scalar type.
//
// Both kernels run a whole EM loop in one launch, one thread-block cluster
// a fit: CTA r of a cluster of C owns the points [r n / C, (r + 1) n / C) of
// its fit, every CTA keeps its own copy of the fit's parameters, and every
// sum over the points is a reduction in a fixed order:
//  - a per-thread sum, then a tree over the CTA's threads (cta_sum), or an
//    entry-parallel sum over staged points (weighted_sums);
//  - then the cluster: each CTA writes its partials to its row of a global
//    buffer, the cluster syncs once, and every CTA adds the C rows in rank
//    order (cluster_sum), so every CTA holds the same totals bit for bit and
//    takes the same decisions without a second barrier. The buffer is
//    double-buffered by reduction parity, so a CTA never overwrites a row
//    another CTA may still read. Partials go through global memory (L2, not
//    L1: __stcg / __ldcg) rather than distributed shared memory because
//    their number grows with K d^2 for any K and d the mixture classes take.
// Nothing is atomic: a launch repeats its bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace em {

namespace cg = cooperative_groups;

constexpr int kSmallCta = 256;       // CTA sizes: powers of two (cta_sum's tree)
constexpr int kLargeCta = 512;
constexpr int kSlots = 2;            // sums a thread carries through one sweep of weighted_sums
constexpr int kMaxCluster = 16;      // a non-portable cluster size
constexpr int kPointsPerCta = 512;   // a cluster grows until its CTAs hold at most this many
constexpr int kHeaderBytes = 512;    // the scalars at the start of shared memory
constexpr int64_t kMaxSmem = 232448; // 227 KB of dynamic shared memory a CTA
constexpr int64_t kStageBytes = 98304;  // the largest staging buffer

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

// torch.clamp(x, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// The cluster size for n points a fit: CTAs of at most kPointsPerCta points,
// a power of two up to kMaxCluster.
__host__ __device__ inline int cluster_for(int64_t n) {
  int c = 1;
  while (c < kMaxCluster && n > static_cast<int64_t>(c) * kPointsPerCta) c *= 2;
  return c;
}

// The CTA size for `ctas` CTAs in all of elements of `elem` bytes: 512
// threads, whose 16 warps an SM hide more of the loops' latency; but 256 in
// float32 where the CTAs fill the card (more than 64 of its 132 SMs), the
// one case where 256 was faster (scripts/em_designs.py, PERF.md).
__host__ __device__ inline int cta_for(int64_t ctas, int64_t elem) {
  return elem == 4 && ctas > 64 ? kSmallCta : kLargeCta;
}

// Rows of the staging buffer: P points of `width` values in `budget` bytes,
// at most `cap`; a multiple of 32 when at least 32.
__host__ __device__ inline int stage_rows(int64_t width, int64_t elem, int64_t budget, int cap) {
  int64_t p = budget / (width * elem);
  if (p > cap) p = cap;
  if (p >= 32) p -= p % 32;
  return p < 1 ? 1 : static_cast<int>(p);
}

// (i, j), j <= i, of the r-th entry of a lower triangle stored by rows.
__device__ __forceinline__ void tri_index(int r, int& i, int& j) {
  i = 0;
  while (r > i) {
    r -= i + 1;
    ++i;
  }
  j = r;
}

__device__ __forceinline__ int tri_entry(int i, int j) {  // j <= i
  return i * (i + 1) / 2 + j;
}

// The CTA's sum of each thread's v[r]: a tree over the threads in a fixed
// order; red[r * blockDim.x] holds sum r on return. The caller syncs before
// red is written again.
template <typename T, int R>
__device__ __forceinline__ void cta_sum(const T (&v)[R], T* red) {
  const int t = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int r = 0; r < R; ++r) red[r * nt + t] = v[r];
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int r = 0; r < R; ++r) red[r * nt + t] += red[r * nt + t + s];
    }
    __syncthreads();
  }
}

// The cluster's sum of each CTA's mine[0, R): the CTA writes its row of
// `rows` (C rows of `stride`), the cluster syncs (its barrier releases the
// writes and acquires them at cluster scope), and every CTA loads the C rows
// at once and adds them in rank order into tot[0, R).
template <typename T>
__device__ void cluster_sum(cg::cluster_group& cluster, T* rows, int64_t stride, int rank, int C,
                            int R, const T* mine, T* tot) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int e = t; e < R; e += nt) __stcg(rows + rank * stride + e, mine[e]);
  cluster.sync();
  for (int e = t; e < R; e += nt) {
    T s = __ldcg(rows + e);
    for (int r0 = 1; r0 < C; r0 += 4) {  // four loads in flight, added in rank order
      T v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = r0 + r < C ? __ldcg(rows + (r0 + r) * stride + e) : T(0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r0 + r < C) s += v[r];
      }
    }
    tot[e] = s;
  }
  __syncthreads();
}

// In-place Cholesky factor of the lower triangle of A (d x d, by rows), by
// the whole CTA, right-looking: false (CTA-uniform) when a pivot is not
// positive (NaN included), as LAPACK's potrf reports info > 0, or a factor
// entry is not finite. `flag` is one int of shared memory.
template <typename T>
__device__ bool cholesky(T* A, int d, int* flag) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < d; ++j) {
    if (t == 0) {
      const T a = A[j * d + j];
      *flag = a > T(0);
      A[j * d + j] = em_sqrt(a);
    }
    __syncthreads();
    if (!*flag) return false;
    const T r = A[j * d + j];
    for (int i = j + 1 + t; i < d; i += nt) A[i * d + j] = A[i * d + j] / r;
    __syncthreads();
    const int m = d - j - 1;
    for (int q = t; q < m * m; q += nt) {
      const int i = j + 1 + q / m, c = j + 1 + q % m;
      if (c <= i) A[i * d + c] -= A[i * d + j] * A[c * d + j];
    }
    __syncthreads();
  }
  bool fin = true;
  for (int q = t; q < d * d; q += nt) {
    if (q % d <= q / d) fin = fin && em_finite(A[q]);
  }
  return __syncthreads_and(fin);
}

// Li = L^-1 (lower, zeros above) of the lower triangle of L, one thread a
// column by forward substitution, as solve_triangular(L, I) gives it.
template <typename T>
__device__ void tri_inverse(const T* L, T* Li, int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    for (int i = 0; i < j; ++i) Li[i * d + j] = T(0);
    for (int i = j; i < d; ++i) {
      T s = i == j ? T(1) : T(0);
      for (int m = j; m < i; ++m) s -= L[i * d + m] * Li[m * d + j];
      Li[i * d + j] = s / L[i * d + i];
    }
  }
  __syncthreads();
}

// The squared distances |Li (x_c - m)|^2 of the np staged points c (column
// c of xs, [d][P]) into out[c], by the whole CTA: g threads a point, g the
// largest power of two with g P <= blockDim.x (1 where the points fill the
// CTA; at large d, few points fit the staging buffer, and the rows of one
// point are shared out), thread q of a point taking the rows i = q, q + g,
// ...; the g partial sums are added in lane order. `dif` is [d][P] scratch
// and red holds blockDim.x values; ends with a barrier.
template <typename T>
__device__ void mahalanobis_chunk(const T* Li, const T* m, int d, const T* xs, T* dif, int P,
                                  int np, T* red, T* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  int g = 1;
  while (2 * g * P <= nt) g *= 2;
  for (int idx = t; idx < np * d; idx += nt) {
    const int j = idx / np, c = idx - j * np;
    dif[j * P + c] = xs[j * P + c] - m[j];
  }
  __syncthreads();
  const int c = t / g, q = t - c * g;
  T part = T(0);
  if (c < np) {
    for (int i = q; i < d; i += g) {
      T s = T(0);
      for (int j = 0; j <= i; ++j) s += Li[i * d + j] * dif[j * P + c];
      part += s * s;
    }
  }
  red[t] = part;
  __syncthreads();
  if (q == 0 && c < np) {
    T maha = red[t];
    for (int r = 1; r < g; ++r) maha += red[t + r];
    out[c] = maha;
  }
  __syncthreads();
}

// One entry of weighted_sums: at a staged row (vec[0, wofs), weights after),
// weights[w] * vec[a] * vec[b] (a or b < 0: a factor of 1), or with len > 0
// weights[w] * sum_{i < len} vec[a + i]^2.
struct Entry {
  int w, a, b, len;
};

template <typename T>
__device__ __forceinline__ T entry_value(const Entry& e, const T* row, int wofs) {
  T x = row[wofs + e.w];
  if (e.len > 0) {
    T s = T(0);
    for (int i = 0; i < e.len; ++i) s += row[e.a + i] * row[e.a + i];
    return x * s;
  }
  if (e.a >= 0) x = x * row[e.a];
  if (e.b >= 0) x = x * row[e.b];
  return x;
}

// The CTA's sums out[0, E) over its points [begin, end) of E entries
// (`entries(e)`), each summed over rows that `stage(p0, np, buf)` stages
// (np rows of `width` values, cooperatively) P points at a time. Entries are
// spread over the threads; with fewer entries than threads, G = nt / E
// threads share an entry, each taking every G-th point of a chunk, and
// their sums are added in group order. More entries than kSlots x nt take
// several sweeps over the points.
template <typename T, typename Stage, typename Entries>
__device__ void weighted_sums(const Stage& stage, const Entries& entries, int E, int64_t begin,
                              int64_t end, int width, int wofs, int P, T* buf, T* red, T* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int G = E >= nt ? 1 : nt / E;
  const int S = E * G;
  for (int base = 0; base < S; base += kSlots * nt) {
    T acc[kSlots];
    Entry ent[kSlots];
    int grp[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int s = base + u * nt + t;
      acc[u] = T(0);
      grp[u] = s < S ? s / E : -1;
      ent[u] = entries(s < S ? s % E : 0);
    }
    for (int64_t p0 = begin; p0 < end; p0 += P) {
      const int np = static_cast<int>(end - p0 < P ? end - p0 : P);
      stage(p0, np, buf);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (grp[u] < 0) continue;
        for (int p = grp[u]; p < np; p += G) acc[u] += entry_value(ent[u], buf + p * width, wofs);
      }
      __syncthreads();
    }
    if (G == 1) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int s = base + u * nt + t;
        if (s < S) out[s] = acc[u];
      }
    } else {  // S <= nt: one sweep, slot t
      if (t < S) red[t] = acc[0];
      __syncthreads();
      for (int e = t; e < E; e += nt) {
        T v = red[e];
        for (int g = 1; g < G; ++g) v += red[g * E + e];
        out[e] = v;
      }
    }
    __syncthreads();
  }
}

// A launch of `grid` CTAs of `threads` in clusters of `cluster`, with
// `smem` bytes of dynamic shared memory.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int64_t grid, int cluster, int threads, int64_t smem, cudaStream_t stream)
      : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
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

}  // namespace em
