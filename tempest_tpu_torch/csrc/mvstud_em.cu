// Weighted multivariate Student-t EM for Hopper (sm_90a): the whole EM loop
// of K weightings of the same points in one launch, in float32 or float64 (a
// template on the scalar type; one C entry each).
//
// Replaces: the `lax.while_loop` of `fit_mvstud_weighted`
// (tempest_tpu/student.py:323), vmapped over the modes by
// tempest_tpu/modes.py:145, which XLA runs on the TPU without a host read,
// and on CUDA tensors the port's "mode_em" device loop
// (tempest_tpu_torch/student.py, `_em_body` run by `loops.run_loop`: chunks
// of a few dozen small launches a body and one blocking read a chunk). It
// is not a Pallas kernel; the plain loop stays the CPU route and the
// yardstick (tempest_tpu_torch/ops/cuda_em.py).
//
// What it computes, for each weighting k of the points data (n, d) under
// wbar (K, n), from the carry (mu, Sigma, nu, last_nu, i, hit_inf, active),
// while active:
//  - `regularized_cholesky`: L = chol(Sigma); where that fails or is not
//    finite, Sigma += max(1e-6, 1e-6 |trace|) I (kept in the carry) and L =
//    chol of that;
//  - the squared distances delta = |L^-1 (x - mu)|^2;
//  - `_opt_nu`: the Gaussian limit when the stationarity function at log 1e6
//    is >= 0, else 5 passes of the 16-way multisection of [log 1e-30, log
//    1e6] in log nu, each counting the 15 midpoints where the function is
//    > 0; nu = exp of the final bracket's middle. The function is
//    lmd(nu / 2) - lmd((nu + d) / 2) + sum wbar (log1p(e) - e), e = (d -
//    delta) / (nu + delta), lmd(x) = log(x) - digamma(x) (its series beyond
//    x = 20; digamma as ATen computes it, a device function here);
//  - the E-step scale g = (nu + d) / (nu + delta), wg = wbar g, Sigma_new =
//    sum wg (x - mu)(x - mu)^T and mu_new = sum wg x / sum wg, taken unless
//    nu is the Gaussian limit (which keeps mu and the regularized Sigma);
//  - last_nu = nu, nu = nu_new, i += 1, hit_inf, and active = not
//    `_nu_converged` (|d nu| <= tol max(1, |nu|) or |d(1/nu)| <= 1000 eps),
//    i < max_iter and not at the Gaussian limit.
// A weighting that is not active stays frozen, as under vmap.
//
// What bounds it on this card: in the least time, the chain where the
// points are few and the operations where they are many. An EM iteration
// is seven sums over all the points, each needing the one before (the
// bound test at log 1e6, the five multisection passes, the M-step), so it
// costs at least seven cluster reductions (about 1 us each on an H100),
// times the iterations the data needs. The multisection evaluates log1p
// and a division at 76 values of nu a point and iteration (B's n =
// 524,288: 40 M of each an iteration); the scatter costs d^2 n flops
// (rosenbrock100: 82 M an iteration). Measured, an iteration takes about
// 90 us at A's modes and 2 ms at B's fit, far above both (PERF.md): the
// CTAs issue below the SMs' rate, and at K = 1 few SMs take part.
//
// What this design does about it:
//  - One cluster of C CTAs a weighting (em::cluster_for: at most 512 points
//    a CTA, C <= 16); CTA r owns a contiguous slice of the points; CTAs of
//    512 threads, but 256 in float32 where the weightings fill the card
//    (em::cta_for). The distances (em::mahalanobis_chunk, a group of
//    threads a point at large d) go to a global scratch (K, n) that each
//    CTA writes and re-reads for its own slice, once a pass.
//  - Every CTA factors Sigma itself (a CTA-parallel Cholesky, then one
//    thread a column of L^-1) from its own copy of the parameters, in shared
//    memory where they fit and in a global work area otherwise.
//  - A multisection pass sums all 15 midpoints' data terms in one pass over
//    the points and one cluster reduction (em::cluster_sum), each in a fixed
//    order; every CTA then counts the same signs.
//  - At K = 1 (B, rosenbrock100, the unclustered paths) one cluster of at
//    most 16 CTAs leaves at least 116 of the card's 132 SMs idle. The
//    kernel takes CTAs of 512 threads there, but at B's n = 524,288 the 16
//    SMs' issue rate still bounds it: about 2 ms an EM iteration against
//    its seven reductions' 11 us (PERF.md). Spreading a mode over several
//    clusters would need a grid-wide reduction.
//  - max_iter and the tolerance are device words, so a CUDA graph can hold
//    the launch.
// Nothing is atomic: a launch repeats its bits.

#include "em_common.cuh"

namespace {

using namespace em;

constexpr int kMaxDevices = 64;
constexpr int kSplit = 16;   // the multisection's intervals
constexpr int kPasses = 5;   // its passes
constexpr double kNuLogLo = -69.0;       // log(1e-30)
constexpr double kNuLogHi = 13.815511;   // log(1e6)
constexpr double kRegFloor = 1e-6;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr double eps = 1.1920928955078125e-07;
};
template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
};

template <typename T>
struct MvArgs {
  const T* data;     // (n, d)
  const T* wbar;     // (K, n)
  T* mu;             // (K, d) carry, in and out
  T* Sigma;          // (K, d, d)
  T* nu;             // (K,)
  T* last_nu;        // (K,)
  int32_t* it;       // (K,)
  uint8_t* hit_inf;  // (K,)
  uint8_t* active;   // (K,)
  const T* tol;      // device word
  const int32_t* max_iter;  // device word
  T* delta;          // (K, n) scratch
  T* part;           // (2, K C, emax) scratch
  T* work;           // (K C, work_elems) global work area, or null: in shared memory
  int64_t n;
  int d, C, P1, P2;
};

// Sizes and offsets (in elements of the type) of a CTA's work area and its
// staging buffer; the host plans with the same struct.
struct MvLayout {
  int64_t mu, sigma, l, linv, mine, tot, elems, e, emax, stage;

  __host__ __device__ MvLayout(int64_t d, int64_t P1, int64_t P2) {
    e = 1 + d + d * (d + 1) / 2;  // sum wg, sum wg x, the scatter
    emax = e > kSplit - 1 ? e : kSplit - 1;
    mu = 0;
    sigma = mu + d;
    l = sigma + d * d;
    linv = l + d * d;
    mine = linv + d * d;
    tot = mine + emax;
    elems = tot + emax;
    const int64_t s1 = 2 * d * P1, s2 = P2 * (2 * d + 1);
    stage = s1 > s2 ? s1 : s2;
  }
};

template <typename T>
struct MvHeader {
  T nu, last_nu, reg, lo, hi;
  T mids[kSplit - 1], nus[kSplit - 1];  // a multisection pass's log nu and nu
  int flag, it, hit_inf, active, is_inf;
  int positive[kSplit - 1];  // the stationarity function's sign at each midpoint
};

// digamma(x) for x > 0, as ATen's calc_digamma takes it: the recurrence up
// to 10, then the asymptotic series.
template <typename T>
__device__ T digamma(T x) {
  if (x == T(0)) return -INFINITY;
  T result = T(0);
  while (x < T(10)) {
    result -= T(1) / x;
    x += T(1);
  }
  if (x == T(10)) return result + T(2.25175258906672110764);
  const T A[] = {T(8.33333333333333333333E-2), T(-2.10927960927960927961E-2),
                 T(7.57575757575757575758E-3), T(-4.16666666666666666667E-3),
                 T(3.96825396825396825397E-3), T(-8.33333333333333333333E-3),
                 T(8.33333333333333333333E-2)};
  T y = T(0);
  if (x < T(1.0e17)) {
    const T z = T(1) / (x * x);
    T poly = T(0);
    for (int i = 0; i <= 6; ++i) poly = poly * z + A[i];
    y = z * poly;
  }
  return em_log(x) - (T(0.5) / x) - y + result;
}

// log(x) - digamma(x), by its asymptotic series beyond x = 20.
template <typename T>
__device__ T log_minus_digamma(T x) {
  if (x > T(20)) {
    const T inv = T(1) / x;
    const T inv2 = inv * inv;
    return T(0.5) * inv + T(1.0 / 12.0) * inv2 - T(1.0 / 120.0) * (inv2 * inv2);
  }
  return em_log(x) - digamma(x);
}

// The stationarity function's nu part, for the data term `data`.
template <typename T>
__device__ __forceinline__ T nu_objective(T nu, int d, T data) {
  return (log_minus_digamma(nu / T(2)) - log_minus_digamma((nu + static_cast<T>(d)) / T(2))) + data;
}

// This thread's sums of wbar (log1p(e) - e), e = (d - delta) / (nu_j + delta),
// over its points of [begin, end), two points a step (their loads in flight
// together), at each of the M values nus[j].
template <typename T, int M>
__device__ __forceinline__ void data_terms(const T* nus, const T* delta, const T* wbar,
                                           int64_t begin, int64_t end, T dim, T (&acc)[M]) {
  const int64_t nt = blockDim.x;
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = T(0);
  int64_t p = begin + threadIdx.x;
  for (; p + nt < end; p += 2 * nt) {
    const T dl0 = delta[p], dl1 = delta[p + nt];
    const T wb0 = __ldg(wbar + p), wb1 = __ldg(wbar + p + nt);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T nu = nus[j];
      const T e0 = (dim - dl0) / (nu + dl0);
      const T e1 = (dim - dl1) / (nu + dl1);
      acc[j] += wb0 * (em_log1p(e0) - e0);
      acc[j] += wb1 * (em_log1p(e1) - e1);
    }
  }
  if (p < end) {
    const T dl = delta[p], wb = __ldg(wbar + p);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T e = (dim - dl) / (nus[j] + dl);
      acc[j] += wb * (em_log1p(e) - e);
    }
  }
}

// Rows of the M-step: x - mu (d), x (d), wg.
template <typename T>
struct StageM {
  const T* data;
  const T* wbar;
  const T* delta;
  const T* mu;
  T nu;
  int d;
  __device__ void operator()(int64_t p0, int np, T* buf) const {
    const int width = 2 * d + 1;
    for (int idx = threadIdx.x; idx < np * width; idx += blockDim.x) {
      const int p = idx / width, c = idx - p * width;
      const int64_t q = p0 + p;
      if (c < d) {
        buf[idx] = __ldg(data + q * d + c) - mu[c];
      } else if (c < 2 * d) {
        buf[idx] = __ldg(data + q * d + (c - d));
      } else {
        const T g = (nu + static_cast<T>(d)) / (nu + delta[q]);
        buf[idx] = __ldg(wbar + q) * g;
      }
    }
  }
};

struct MEntries {  // sum wg, sum wg x_i, then sum wg (x - mu)_i (x - mu)_j, j <= i
  int d;
  __device__ Entry operator()(int e) const {
    if (e == 0) return Entry{0, -1, -1, 0};
    if (e <= d) return Entry{0, d + e - 1, -1, 0};
    int i, j;
    tri_index(e - 1 - d, i, j);
    return Entry{0, i, j, 0};
  }
};

template <typename T>
__device__ void mvstud_em_body(const MvArgs<T>& a, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.C, d = a.d, P1 = a.P1;
  const int t = threadIdx.x, nt = blockDim.x;
  const int mode = blockIdx.x / C;
  const MvLayout lay(d, P1, a.P2);
  MvHeader<T>& h = *reinterpret_cast<MvHeader<T>*>(smem);
  T* red = reinterpret_cast<T*>(smem + kHeaderBytes);  // (kSplit - 1) nt
  T* stage = red + (kSplit - 1) * nt;
  T* w = a.work ? a.work + static_cast<int64_t>(blockIdx.x) * lay.elems : stage + lay.stage;
  T* mu = w + lay.mu;
  T* Sigma = w + lay.sigma;
  T* L = w + lay.l;
  T* Linv = w + lay.linv;
  T* mine = w + lay.mine;
  T* tot = w + lay.tot;

  const int64_t n = a.n;
  const T* data = a.data;
  const T* wbar = a.wbar + static_cast<int64_t>(mode) * n;
  T* delta = a.delta + static_cast<int64_t>(mode) * n;
  const int64_t buf_elems = static_cast<int64_t>(gridDim.x) * lay.emax;
  T* rows = a.part + static_cast<int64_t>(mode) * C * lay.emax;
  const int64_t begin = n * rank / C, end = n * (rank + 1) / C;
  const int DD = d * d;

  for (int i = t; i < d; i += nt) mu[i] = a.mu[mode * d + i];
  for (int i = t; i < DD; i += nt) Sigma[i] = a.Sigma[static_cast<int64_t>(mode) * DD + i];
  if (t == 0) {
    h.nu = a.nu[mode];
    h.last_nu = a.last_nu[mode];
    h.it = a.it[mode];
    h.hit_inf = a.hit_inf[mode] != 0;
    h.active = a.active[mode] != 0;
  }
  const T tol = *a.tol;
  const int max_iter = *a.max_iter;
  const T dim = static_cast<T>(d);
  __syncthreads();

  int parity = 0;
  while (h.active) {  // CTA- and cluster-uniform
    // regularized_cholesky: the floor on the diagonal where Cholesky fails.
    for (int q = t; q < DD; q += nt) L[q] = Sigma[q];
    __syncthreads();
    if (!cholesky(L, d, &h.flag)) {
      if (t == 0) {
        T tr = T(0);
        for (int i = 0; i < d; ++i) tr += Sigma[i * d + i];
        h.reg = clamp_min(static_cast<T>(kRegFloor) * em_abs(tr), static_cast<T>(kRegFloor));
      }
      __syncthreads();
      for (int i = t; i < d; i += nt) Sigma[i * d + i] += h.reg;
      __syncthreads();
      for (int q = t; q < DD; q += nt) L[q] = Sigma[q];
      __syncthreads();
      cholesky(L, d, &h.flag);
    }
    tri_inverse(L, Linv, d);

    // The squared distances of this CTA's points.
    T* xs = stage;            // [d][P1]
    T* dif = stage + d * P1;  // [d][P1]
    for (int64_t p0 = begin; p0 < end; p0 += P1) {
      const int np = static_cast<int>(end - p0 < P1 ? end - p0 : P1);
      for (int idx = t; idx < np * d; idx += nt) {
        const int p = idx / d, j = idx - p * d;
        xs[j * P1 + p] = __ldg(data + (p0 + p) * d + j);
      }
      __syncthreads();
      mahalanobis_chunk(Linv, mu, d, xs, dif, P1, np, red, delta + p0);
    }

    // _opt_nu: the Gaussian-limit test at log 1e6, then the multisection.
    // Thread 0 keeps the bracket; threads j < 15 evaluate the midpoints.
    {
      const T nu_hi[1] = {em_exp(static_cast<T>(kNuLogHi))};
      T acc[1];
      data_terms<T, 1>(nu_hi, delta, wbar, begin, end, dim, acc);
      cta_sum<T, 1>(acc, red);
      if (t == 0) mine[0] = red[0];
      __syncthreads();
      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, 1, mine, tot);
      parity ^= 1;
      if (t == 0) {
        h.is_inf = nu_objective(nu_hi[0], d, tot[0]) >= T(0);
        h.lo = static_cast<T>(kNuLogLo);
        h.hi = static_cast<T>(kNuLogHi);
      }
      __syncthreads();
    }
    for (int pass = 0; pass < kPasses; ++pass) {
      if (t < kSplit - 1) {
        const T m = h.lo + (h.hi - h.lo) * (static_cast<T>(t + 1) / static_cast<T>(kSplit));
        h.mids[t] = m;
        h.nus[t] = em_exp(m);
      }
      __syncthreads();
      T acc[kSplit - 1];
      data_terms<T, kSplit - 1>(h.nus, delta, wbar, begin, end, dim, acc);
      cta_sum<T, kSplit - 1>(acc, red);
      for (int j = t; j < kSplit - 1; j += nt) mine[j] = red[j * nt];
      __syncthreads();
      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, kSplit - 1, mine, tot);
      parity ^= 1;
      if (t < kSplit - 1) h.positive[t] = nu_objective(h.nus[t], d, tot[t]) > T(0);
      __syncthreads();
      if (t == 0) {
        int count = 0;
        for (int j = 0; j < kSplit - 1; ++j) count += h.positive[j];
        const T lo = count == 0 ? h.lo : h.mids[count - 1];
        const T hi = count == kSplit - 1 ? h.hi : h.mids[count];
        h.lo = lo;
        h.hi = hi;
      }
      __syncthreads();
    }
    const T nu_new = h.is_inf ? static_cast<T>(INFINITY) : em_exp(T(0.5) * (h.lo + h.hi));
    const bool now_inf = !em_finite(nu_new);

    // The M-step, unless at the Gaussian limit (mu and the regularized
    // Sigma stay).
    if (!now_inf) {
      weighted_sums(StageM<T>{data, wbar, delta, mu, nu_new, d}, MEntries{d},
                    static_cast<int>(lay.e), begin, end, 2 * d + 1, 2 * d, a.P2, stage, red, mine);
      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C,
                  static_cast<int>(lay.e), mine, tot);
      parity ^= 1;
      for (int i = t; i < d; i += nt) mu[i] = tot[1 + i] / tot[0];
      for (int q = t; q < DD; q += nt) {
        const int i = q / d, j = q % d;
        Sigma[q] = tot[1 + d + (i >= j ? tri_entry(i, j) : tri_entry(j, i))];
      }
    }
    if (t == 0) {
      const T last = h.nu;
      h.last_nu = last;
      h.nu = nu_new;
      h.it += 1;
      h.hit_inf = now_inf;
      const T tol_abs = tol * clamp_min(em_abs(nu_new), T(1));
      const T inv_tol = static_cast<T>(1000.0 * Limits<T>::eps);
      const T safe_last = last == T(0) ? static_cast<T>(INFINITY) : last;
      const bool converged = em_abs(last - nu_new) <= tol_abs ||
                             em_abs(T(1) / safe_last - T(1) / nu_new) <= inv_tol;
      h.active = !converged && h.it < max_iter && !now_inf;
    }
    __syncthreads();
  }

  if (rank == 0) {
    for (int i = t; i < d; i += nt) a.mu[mode * d + i] = mu[i];
    for (int i = t; i < DD; i += nt) a.Sigma[static_cast<int64_t>(mode) * DD + i] = Sigma[i];
    if (t == 0) {
      a.nu[mode] = h.nu;
      a.last_nu[mode] = h.last_nu;
      a.it[mode] = h.it;
      a.hit_inf[mode] = static_cast<uint8_t>(h.hit_inf);
      a.active[mode] = static_cast<uint8_t>(h.active);
    }
  }
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) mvstud_em_kernel(MvArgs<T> a) {
  extern __shared__ __align__(16) unsigned char em_dynamic_smem[];
  mvstud_em_body<T>(a, em_dynamic_smem);
}

// The launch plan of K weightings of n points: cluster size, shared memory
// bytes, where the work area lives and the scratch sizes (elements).
struct MvPlan {
  int64_t C, smem, work_in_smem, work_elems, emax, P1, P2, delta, part, work_global, threads;
};

MvPlan mvstud_plan(int64_t K, int64_t n, int64_t d, int64_t elem) {
  MvPlan p;
  p.C = cluster_for(n);
  p.threads = cta_for(K * p.C, elem);
  const int threads = static_cast<int>(p.threads);
  const int64_t red = (kSplit - 1) * threads * elem;
  const MvLayout fixed(d, 1, 1);
  const int64_t work_bytes = fixed.elems * elem;
  int64_t room = kMaxSmem - kHeaderBytes - red - work_bytes;
  p.work_in_smem = room >= 32 * (2 * d + 1) * elem && room >= 2 * 32 * d * elem;
  if (!p.work_in_smem) room = kMaxSmem - kHeaderBytes - red;
  const int64_t budget = room < kStageBytes ? room : kStageBytes;
  p.P1 = stage_rows(2 * d, elem, budget, threads);
  p.P2 = stage_rows(2 * d + 1, elem, budget, 128);
  const MvLayout lay(d, p.P1, p.P2);
  p.work_elems = lay.elems;
  p.emax = lay.emax;
  p.smem = kHeaderBytes + red + lay.stage * elem + (p.work_in_smem ? lay.elems * elem : 0);
  p.delta = K * n;
  p.part = 2 * K * p.C * lay.emax;
  p.work_global = p.work_in_smem ? 0 : K * p.C * lay.elems;
  return p;
}

template <typename T>
cudaError_t prepare() {
  static bool done[kMaxDevices] = {};
  static cudaError_t status[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    status[device] = allow_cluster_and_smem(mvstud_em_kernel<T, kSmallCta>);
    if (status[device] == cudaSuccess) {
      status[device] = allow_cluster_and_smem(mvstud_em_kernel<T, kLargeCta>);
    }
    done[device] = true;
  }
  return status[device];
}

template <typename T>
int entry(const void* data, const void* wbar, void* mu, void* Sigma, void* nu, void* last_nu,
          void* it, void* hit_inf, void* active, const void* tol, const void* max_iter,
          void* delta, void* part, void* work, int64_t K, int64_t n, int64_t d, void* stream) {
  if (K <= 0 || n <= 0 || d <= 0 || K * 16 > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MvPlan p = mvstud_plan(K, n, d, sizeof(T));
  if (p.smem > kMaxSmem || (!p.work_in_smem && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  MvArgs<T> a;
  a.data = static_cast<const T*>(data);
  a.wbar = static_cast<const T*>(wbar);
  a.mu = static_cast<T*>(mu);
  a.Sigma = static_cast<T*>(Sigma);
  a.nu = static_cast<T*>(nu);
  a.last_nu = static_cast<T*>(last_nu);
  a.it = static_cast<int32_t*>(it);
  a.hit_inf = static_cast<uint8_t*>(hit_inf);
  a.active = static_cast<uint8_t*>(active);
  a.tol = static_cast<const T*>(tol);
  a.max_iter = static_cast<const int32_t*>(max_iter);
  a.delta = static_cast<T*>(delta);
  a.part = static_cast<T*>(part);
  a.work = p.work_in_smem ? nullptr : static_cast<T*>(work);
  a.n = n;
  a.d = static_cast<int>(d);
  a.C = static_cast<int>(p.C);
  a.P1 = static_cast<int>(p.P1);
  a.P2 = static_cast<int>(p.P2);
  const int threads = static_cast<int>(p.threads);
  ClusterLaunch launch(K * p.C, a.C, threads, p.smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.cfg,
                           threads == kLargeCta ? mvstud_em_kernel<T, kLargeCta>
                                                : mvstud_em_kernel<T, kSmallCta>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.
//
// tempest_mvstud_em_plan: the plan of K weightings of n points in d
// dimensions with elements of elem bytes, into out[0, 11): cluster size,
// shared memory bytes, whether the work area is in shared memory, its
// elements a CTA, the partials a CTA, the staging rows P1 and P2, the
// elements of the three scratch buffers (distances, partials, global work
// area; 0 when in shared memory) and the CTA's threads. Host only.
extern "C" int tempest_mvstud_em_plan(int64_t K, int64_t n, int64_t d, int64_t elem,
                                      int64_t* out) {
  if (K <= 0 || n <= 0 || d <= 0 || (elem != 4 && elem != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MvPlan p = mvstud_plan(K, n, d, elem);
  const int64_t v[11] = {p.C, p.smem, p.work_in_smem, p.work_elems, p.emax, p.P1,
                         p.P2, p.delta, p.part, p.work_global, p.threads};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// tempest_mvstud_em in float32, tempest_mvstud_em_f64 in float64: data (n,
// d) and wbar (K, n) of the type; the carry mu (K, d), Sigma (K, d, d), nu
// and last_nu (K,) of the type, i (K,) int32, hit_inf and active (K,) bool,
// updated in place; tol (the type) and max_iter (int32) device words; the
// scratch buffers of the plan's sizes (work may be null when the plan keeps
// it in shared memory). Each launches on `stream` of the current device
// without synchronising and returns a cudaError_t.
extern "C" int tempest_mvstud_em(const void* data, const void* wbar, void* mu, void* Sigma,
                                 void* nu, void* last_nu, void* it, void* hit_inf, void* active,
                                 const void* tol, const void* max_iter, void* delta, void* part,
                                 void* work, int64_t K, int64_t n, int64_t d, void* stream) {
  return entry<float>(data, wbar, mu, Sigma, nu, last_nu, it, hit_inf, active, tol, max_iter,
                      delta, part, work, K, n, d, stream);
}

extern "C" int tempest_mvstud_em_f64(const void* data, const void* wbar, void* mu, void* Sigma,
                                     void* nu, void* last_nu, void* it, void* hit_inf,
                                     void* active, const void* tol, const void* max_iter,
                                     void* delta, void* part, void* work, int64_t K, int64_t n,
                                     int64_t d, void* stream) {
  return entry<double>(data, wbar, mu, Sigma, nu, last_nu, it, hit_inf, active, tol, max_iter,
                       delta, part, work, K, n, d, stream);
}
