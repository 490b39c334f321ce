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
// costs at least seven fit reductions (about 1 us each on an H100), times
// the iterations the data needs. The multisection evaluates log1p and a
// division at 76 values of nu a point and iteration (B's n = 524,288: 40 M
// of each an iteration, which CUDA's precise log1pf and division make
// instruction-bound); the scatter costs d^2 n flops (rosenbrock100: 82 M an
// iteration).
//
// What this design does about it (em_common.cuh has the shared parts):
//  - A weighting's G CTAs (em_common.cuh, "The launch's geometry"): a
//    cluster of up to 16 where a launch has several weightings, as large as
//    keeps all its clusters resident at once (A's 16 modes: 16 x 6 = 96
//    CTAs on an H100); a launch of one weighting of more than 2,048 points
//    (B, rosenbrock100, the unclustered and dynamic paths) takes the grid,
//    up to one CTA an SM (B: 132 CTAs), launched cooperatively, its
//    reductions closed by the grid's barrier. CTA r loads its slice of the
//    points and of wbar into shared memory once a launch, its points of
//    nonzero weight first (a clustered fit's mode weights about 1/K of
//    them; the sums run over those, the others only get their distances,
//    which say where the plain loop's sums turn NaN), and keeps each
//    point's distance there between the passes (then its wg). Where they
//    do not fit, the points are read from global memory (of phase 4d's
//    shapes: B's in float64, 350 KB a CTA, and rosenbrock100's in float64,
//    beside the 200 KB of its factors), and the distances go to a global
//    scratch (K, n) (none of phase 4d's shapes).
//  - One warp factors Sigma and inverts the factor at d <= 32, the retry
//    with the floor included, with no CTA barrier (em::warp_cholesky,
//    em::warp_inverse); past 32 the CTA factors in panels.
//  - The bound test's terms are added in the distances' pass; a
//    multisection pass sums all 15 midpoints' terms in one pass over the
//    resident distances, warp shuffles and one barrier for the CTA's 15
//    sums (em::cta_sum), and one fit reduction (em::fit_sum); warp 0
//    counts the signs. The M-step's sums run over the resident points, a
//    few lanes an entry (em::entry_sums). Each sum keeps a fixed order.
//  - max_iter and the tolerance are device words, so a CUDA graph can hold
//    the launch.
// Nothing is atomic: a launch repeats its bits.

#include <map>
#include <tuple>

#include "em_common.cuh"
#include "em_stamps.cuh"

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
  static constexpr double max = 3.4028234663852886e+38;
};
template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double max = 1.7976931348623157e+308;
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
  T* delta;          // (K, n) scratch, or null: in shared memory
  T* part;           // (2, K, G + 1, emax) scratch
  T* work;           // (K G, work_elems) global work area, or null: in shared memory
  int64_t n;
  int d, G, points;  // points: a CTA's at most
  bool x_smem, grid;  // grid: the fit's CTAs are the cooperative grid
};

// Sizes and offsets (in elements of the type) of a CTA's work area; the
// host plans with the same struct. Sigma and its factors are packed lower
// triangles.
struct MvLayout {
  int64_t td, mu, sigma, l, li, mine, tot, elems, e, emax;

  __host__ __device__ explicit MvLayout(int64_t d) {
    td = d * (d + 1) / 2;
    e = 1 + d + td;  // sum wg, sum wg x, the scatter
    emax = e > kSplit - 1 ? e : kSplit - 1;
    mu = 0;
    sigma = mu + d;
    l = sigma + td;
    li = l + td;
    mine = li + td;
    tot = mine + emax;
    elems = tot + emax;
  }
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

// log(x) - digamma(x), by its asymptotic series beyond x = 20, each
// operation rounded as `_log_minus_digamma` rounds it on the card: 0.5 inv +
// (1/12) inv inv - (1/120) pow(inv, 4).
template <typename T>
__device__ T log_minus_digamma(T x) {
  if (x > T(20)) {
    const T inv = T(1) / x;
    const T second = mul_rn(mul_rn(T(1.0 / 12.0), inv), inv);
    const T fourth = mul_rn(T(1.0 / 120.0), em_pow(inv, T(4)));
    return add_rn(mul_rn(T(0.5), inv), second) - fourth;
  }
  return em_log(x) - digamma(x);
}

// The stationarity function's nu part, for the data term `data`.
template <typename T>
__device__ __forceinline__ T nu_objective(T nu, int d, T data) {
  return (log_minus_digamma(nu / T(2)) - log_minus_digamma((nu + static_cast<T>(d)) / T(2))) + data;
}

// Whether e = (d - delta) / (nu + delta) may round to -1 in the type for
// some delta <= dmax: e = -1 + (d + nu) / (nu + delta) is taken within
// about 1.5 eps, so it cannot where (d + nu) / (nu + dmax) > 4 eps.
template <typename T>
__device__ __forceinline__ bool rounds_to_minus_one(T dim, T nu, T dmax) {
  return static_cast<double>(dim) + nu <= 4.0 * Limits<T>::eps * (static_cast<double>(nu) + dmax);
}

// The multisection's midpoint j of [lo, hi] in log nu, rounded as `_opt_nu`
// rounds lo + (hi - lo) x fraction (a fused multiply-add moves the grid by
// an ulp, and with it the cells that decide nu and the exit).
template <typename T>
__device__ __forceinline__ T midpoint(T lo, T hi, int j) {
  return add_rn(lo, mul_rn(hi - lo, static_cast<T>(j + 1) / static_cast<T>(kSplit)));
}

template <typename T>
__device__ void mvstud_em_body(const MvArgs<T>& a, unsigned char* smem) {
  const int G = a.G, d = a.d;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int mode = blockIdx.x / G, rank = blockIdx.x % G;
  const FitSync sync{a.grid};
  const MvLayout lay(d);
  const int td = static_cast<int>(lay.td);
  int* flag = reinterpret_cast<int*>(smem);
  int* count = flag + 1;
  int* regged = flag + 2;  // the floor was added since the launch began
  Acc* red = reinterpret_cast<Acc*>(smem + kHeaderBytes);
  T* next = reinterpret_cast<T*>(red + kRed * 32);
  T* w = a.work ? a.work + static_cast<int64_t>(blockIdx.x) * lay.elems : next;
  if (!a.work) next += lay.elems;
  T* mu = w + lay.mu;
  T* Sigma = w + lay.sigma;
  T* L = w + lay.l;
  T* Li = w + lay.li;
  T* mine = w + lay.mine;
  T* tot = w + lay.tot;

  const int64_t n = a.n;
  const int64_t begin = n * rank / G, end = n * (rank + 1) / G;
  int np = static_cast<int>(end - begin);
  const T* Xg = a.data + begin * d;
  const T* wbg = a.wbar + static_cast<int64_t>(mode) * n + begin;
  const T* wb = wbg;
  T* ws = next;  // the weights in shared memory
  T* dl;         // (np,): the distances, then wg
  if (a.delta) {
    dl = a.delta + static_cast<int64_t>(mode) * n + begin;
  } else {
    wb = ws;
    dl = ws + a.points;
    next = dl + a.points;
  }
  const T* xs = Xg;
  int ld = d;
  if (a.x_smem) {
    ld = smem_stride(d);
    xs = next;
  }
  // Where the points and their distances fit in shared memory, a CTA holds
  // its points of nonzero weight first, in their order, and its points of
  // zero weight after them (a mode of a clustered fit weights about 1/K of
  // the points): distances are taken for all np_x, the stationarity sums
  // and the M-step run over the first np only. A point of zero weight adds
  // 0 x (log1p(e) - e) to a stationarity sum of the plain loop: an exact
  // zero, but NaN where e rounds to -1 (a distance past about (d + nu) /
  // eps) or the distance is not finite. Its M-step terms 0 x g (x - mu)
  // stay exact zeros (g = (nu + d) / (nu + delta) is finite, or 0) unless
  // the distance is NaN. So each thread notes the largest finite distance
  // of its zero-weight points and whether one was not finite, and makes a
  // sum NaN where the plain loop's is. A CTA whose zero-weight points hold a
  // coordinate that is not finite or past a quarter of the type's largest
  // value (where x - mu may overflow) keeps all its points in the sums.
  int np_x = np;
  bool held = false;  // the points held in that order
  if (!a.delta && a.x_smem) {
    if (warp == 0) {
      bool far = false;
      for (int p = lane; p < np; p += 32) {
        if (wbg[p] != T(0)) continue;
        for (int j = 0; j < d; ++j) {
          const T x = Xg[static_cast<int64_t>(p) * d + j];
          far = far || !(em_abs(x) <= static_cast<T>(0.25 * Limits<T>::max));
        }
      }
      far = __any_sync(kFull, far);
      int placed = 0, kept = 0;
      for (int side = 0; side < 2 && !far; ++side) {  // nonzero weights, then zero
        for (int c0 = 0; c0 < np; c0 += 32) {
          const int p = c0 + lane;
          const T wp = p < np ? wbg[p] : T(0);
          const bool take = p < np && (wp != T(0)) == (side == 0);
          const unsigned m = __ballot_sync(kFull, take);
          if (take) {
            const int q = placed + __popc(m & ((1u << lane) - 1u));
            ws[q] = wp;
            for (int j = 0; j < d; ++j) next[q * ld + j] = Xg[static_cast<int64_t>(p) * d + j];
          }
          placed += __popc(m);
        }
        if (side == 0) kept = placed;
      }
      if (lane == 0) *count = far ? -1 : kept;
    }
    __syncthreads();
    held = *count >= 0;
    if (held) np = *count;
  }
  if (!held) {
    if (!a.delta) {
      for (int p = t; p < np; p += nt) ws[p] = wbg[p];
    }
    if (a.x_smem) {
      for (int idx = t; idx < np * d; idx += nt) {
        const int p = idx / d, j = idx - p * d;
        next[p * ld + j] = Xg[idx];
      }
    }
  }

  for (int i = t; i < d; i += nt) mu[i] = a.mu[mode * d + i];
  for (int q = t; q < td; q += nt) {
    int i, j;
    tri_index(q, i, j);
    Sigma[q] = a.Sigma[static_cast<int64_t>(mode) * d * d + i * d + j];
  }
  if (t == 0) *regged = 0;
  T nu = a.nu[mode], last_nu = a.last_nu[mode];
  int it = a.it[mode];
  bool hit_inf = a.hit_inf[mode] != 0, active = a.active[mode] != 0, stepped = false;
  const T tol = *a.tol;
  const int max_iter = *a.max_iter;
  const T dim = static_cast<T>(d);
  const T nu_hi = em_exp(static_cast<T>(kNuLogHi));
  const T reg_floor = static_cast<T>(kRegFloor);
  const int64_t block = static_cast<int64_t>(G + 1) * lay.emax;
  T* rows0 = a.part + static_cast<int64_t>(mode) * block;
  const int64_t parity_stride = static_cast<int64_t>(gridDim.x / G) * block;
  __syncthreads();

  Stamps st;
  st.start();
  int parity = 0;
  while (active) {  // CTA- and fit-uniform
    st.iteration();
    // regularized_cholesky, then L^-1.
    if (d <= 32) {
      if (warp == 0) {  // one warp, no CTA barrier
        if (lane < d) {
          for (int j = 0; j <= lane; ++j) L[tri(lane, j)] = Sigma[tri(lane, j)];
        }
        __syncwarp();
        if (!warp_cholesky(L, 0, d)) {
          const T tr = warp_sum(lane < d ? Sigma[tri(lane, lane)] : T(0));
          const T rg = clamp_min(reg_floor * em_abs(tr), reg_floor);
          if (lane < d) {
            Sigma[tri(lane, lane)] += rg;
            for (int j = 0; j <= lane; ++j) L[tri(lane, j)] = Sigma[tri(lane, j)];
          }
          __syncwarp();
          warp_cholesky(L, 0, d);
          if (lane == 0) *regged = 1;
        }
        warp_inverse(L, Li, d);
      }
    } else {
      for (int q = t; q < td; q += nt) L[q] = Sigma[q];
      __syncthreads();
      if (!cta_cholesky(L, d, flag)) {
        if (warp == 0) {
          T tr = T(0);
          for (int i = lane; i < d; i += 32) tr += Sigma[tri(i, i)];
          const T rg = clamp_min(reg_floor * em_abs(warp_sum(tr)), reg_floor);
          for (int i = lane; i < d; i += 32) Sigma[tri(i, i)] += rg;
          if (lane == 0) *regged = 1;
        }
        __syncthreads();
        for (int q = t; q < td; q += nt) L[q] = Sigma[q];
        __syncthreads();
        cta_cholesky(L, d, flag);
      }
      cta_inverse(L, Li, d);
    }
    __syncthreads();
    st.mark(0);

    // The distances, and their terms of the Gaussian-limit test at log 1e6.
    Acc acc_hi = 0.0;
    T far_max = T(-1);     // the largest finite distance of this thread's zero-weight points
    bool far_bad = false;  // one of them not finite: every stationarity sum is NaN
    bool far_nan = false;  // NaN: the M-step's sums too
    const int g = lanes_a_point(np_x, d), q = t & (g - 1), per_round = nt / g;
    for (int base = 0; base < np_x; base += per_round) {
      const int p = base + t / g;
      const bool valid = p < np_x;
      const T m = mahalanobis(Li, mu, xs + static_cast<int64_t>(valid ? p : 0) * ld, d, q, g,
                              valid);
      if (valid && q == 0) {
        dl[p] = m;
        const T e = (dim - m) / (nu_hi + m);
        if (p < np) {
          acc_hi += static_cast<Acc>(wb[p] * (em_log1p(e) - e));
        } else {
          if (em_finite(m)) {
            far_max = m > far_max ? m : far_max;
          } else {
            far_bad = true;
            far_nan = far_nan || m != m;
          }
          if (!em_finite(m) || e == T(-1)) acc_hi = NAN;
        }
      }
    }
    st.mark(1);
    {
      Acc v[2] = {acc_hi, far_nan ? static_cast<Acc>(NAN) : 0.0};
      cta_sum<2>(v, red, mine);
    }
    st.mark(2);
    fit_sum(sync, rows0 + parity * parity_stride, lay.emax, rank, G, 2, mine, tot);
    parity ^= 1;
    st.mark(3);
    const bool m_nan = tot[1] != tot[1];
    const bool is_inf = nu_objective(nu_hi, d, tot[0]) >= T(0);

    // _opt_nu's multisection: the 15 midpoints' terms in one pass a pass.
    T lo = static_cast<T>(kNuLogLo), hi = static_cast<T>(kNuLogHi);
    for (int pass = 0; pass < kPasses; ++pass) {
      T nus[kSplit - 1];
      Acc acc[kSplit - 1];
#pragma unroll
      for (int j = 0; j < kSplit - 1; ++j) {
        nus[j] = em_exp(midpoint(lo, hi, j));
        acc[j] = 0.0;
      }
      for (int p = t; p < np; p += nt) {
        const T dp = dl[p], wp = wb[p];
#pragma unroll
        for (int j = 0; j < kSplit - 1; ++j) {
          const T e = (dim - dp) / (nus[j] + dp);
          acc[j] += static_cast<Acc>(wp * (em_log1p(e) - e));
        }
      }
      if (far_bad) {
#pragma unroll
        for (int j = 0; j < kSplit - 1; ++j) acc[j] = NAN;
      } else if (far_max >= T(0) && rounds_to_minus_one(dim, nus[0], far_max)) {
        // A zero-weight point's e may round to -1 at the lowest midpoints.
        for (int base = 0; base < np_x; base += per_round) {
          const int p = base + t / g;
          if (q != 0 || p < np || p >= np_x) continue;
          const T dp = dl[p];
#pragma unroll
          for (int j = 0; j < kSplit - 1; ++j) {
            if (rounds_to_minus_one(dim, nus[j], far_max) &&
                (dim - dp) / (nus[j] + dp) == T(-1)) {
              acc[j] = NAN;
            }
          }
        }
      }
      cta_sum<kSplit - 1>(acc, red, mine);
      st.mark(2);
      fit_sum(sync, rows0 + parity * parity_stride, lay.emax, rank, G, kSplit - 1, mine, tot);
      parity ^= 1;
      st.mark(3);
      if (warp == 0) {
        const bool positive =
            lane < kSplit - 1 && nu_objective(em_exp(midpoint(lo, hi, lane)), d, tot[lane]) > T(0);
        const unsigned b = __ballot_sync(kFull, positive);
        if (lane == 0) *count = __popc(b);
      }
      __syncthreads();
      const int c = *count;
      const T nlo = c == 0 ? lo : midpoint(lo, hi, c - 1);
      const T nhi = c == kSplit - 1 ? hi : midpoint(lo, hi, c);
      lo = nlo;
      hi = nhi;
      st.mark(6);
    }
    const T nu_new = is_inf ? static_cast<T>(INFINITY) : em_exp(T(0.5) * (lo + hi));
    const bool now_inf = !em_finite(nu_new);

    // The M-step, unless at the Gaussian limit (mu and the regularized
    // Sigma stay).
    if (!now_inf) {
      for (int p = t; p < np; p += nt) dl[p] = wb[p] * ((nu_new + dim) / (nu_new + dl[p]));
      __syncthreads();
      const int E = static_cast<int>(lay.e);
      entry_sums<T>(
          [&](int e) {
            int i = -1, j = -1;
            if (e > d) tri_index(e - 1 - d, i, j);
            const int xi = e >= 1 && e <= d ? e - 1 : -1;
            return [=](int p) {
              const T wg = dl[p];
              const T* x = xs + static_cast<int64_t>(p) * ld;
              if (i >= 0) return wg * (x[i] - mu[i]) * (x[j] - mu[j]);
              return xi >= 0 ? wg * x[xi] : wg;
            };
          },
          E, np, mine);
      if (m_nan) {  // a zero-weight point's distance is NaN, so is its plain wg
        __syncthreads();
        for (int e = t; e < E; e += nt) mine[e] = static_cast<T>(NAN);
      }
      st.mark(4);
      fit_sum(sync, rows0 + parity * parity_stride, lay.emax, rank, G, E, mine, tot);
      parity ^= 1;
      st.mark(5);
      for (int i = t; i < d; i += nt) mu[i] = tot[1 + i] / tot[0];
      for (int q = t; q < td; q += nt) Sigma[q] = tot[1 + d + q];
      stepped = true;
      __syncthreads();
    }
    const T last = nu;
    last_nu = last;
    nu = nu_new;
    it += 1;
    hit_inf = now_inf;
    const T tol_abs = tol * clamp_min(em_abs(nu_new), T(1));
    const T inv_tol = static_cast<T>(1000.0 * Limits<T>::eps);
    const T safe_last = last == T(0) ? static_cast<T>(INFINITY) : last;
    const bool converged = em_abs(last - nu_new) <= tol_abs ||
                           em_abs(T(1) / safe_last - T(1) / nu_new) <= inv_tol;
    active = !converged && it < max_iter && !now_inf;
    st.mark(6);
  }
  st.finish();

  if (rank == 0) {
    for (int i = t; i < d; i += nt) a.mu[mode * d + i] = mu[i];
    T* out = a.Sigma + static_cast<int64_t>(mode) * d * d;
    if (stepped) {  // the M-step's symmetric Sigma, with any floor since
      for (int q = t; q < d * d; q += nt) {
        const int i = q / d, j = q % d;
        out[q] = Sigma[i >= j ? tri(i, j) : tri(j, i)];
      }
    } else if (*regged) {  // the carry's Sigma with the floor: its diagonal
      for (int i = t; i < d; i += nt) out[i * d + i] = Sigma[tri(i, i)];
    }
    if (t == 0) {
      a.nu[mode] = nu;
      a.last_nu[mode] = last_nu;
      a.it[mode] = it;
      a.hit_inf[mode] = static_cast<uint8_t>(hit_inf);
      a.active[mode] = static_cast<uint8_t>(active);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mvstud_em_kernel(MvArgs<T> a) {
  extern __shared__ __align__(16) unsigned char em_dynamic_smem[];
  mvstud_em_body<T>(a, em_dynamic_smem);
}

// The launch plan of K weightings of n points (tempest_mvstud_em_plan's
// fields).
struct MvPlan {
  int64_t ctas, cluster, grid, threads, smem, work_in_smem, work_elems, x_resident,
      points_resident, points, emax, scratch, part, work_global;
};

// The plan with G = ctas CTAs a weighting.
MvPlan mvstud_plan_at(int64_t K, int64_t n, int64_t d, int64_t elem, int64_t ctas, bool grid) {
  MvPlan p;
  p.ctas = ctas;
  p.grid = grid;
  p.cluster = grid ? 1 : ctas;
  p.points = (n + ctas - 1) / ctas;
  p.threads = kThreads;
  const MvLayout lay(d);
  const SmemPlan s = smem_plan(elem, lay.elems, 2, p.points, smem_stride(static_cast<int>(d)));
  p.smem = s.bytes;
  p.work_in_smem = s.work;
  p.work_elems = lay.elems;
  p.x_resident = s.x;
  p.points_resident = s.points;
  p.emax = lay.emax;
  p.scratch = s.points ? 0 : K * n;
  p.part = 2 * K * (ctas + 1) * lay.emax;
  p.work_global = s.work ? 0 : K * ctas * lay.elems;
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
    status[device] = allow_cluster_and_smem(mvstud_em_kernel<T>);
    done[device] = true;
  }
  return status[device];
}

// The plan: the grid for one large weighting, else the largest cluster
// whose clusters are all resident at once (em_common.cuh's geometry).
template <typename T>
MvPlan mvstud_plan_for(int64_t K, int64_t n, int64_t d, int sms) {
  if (grid_route(K, n)) return mvstud_plan_at(K, n, d, sizeof(T), grid_ctas(n, sms), true);
  for (int64_t c = largest_cluster(K, n, sms); c > 1; --c) {
    const MvPlan p = mvstud_plan_at(K, n, d, sizeof(T), c, false);
    if (resident_clusters(mvstud_em_kernel<T>, static_cast<int>(c), kThreads, p.smem) >= K) {
      return p;
    }
  }
  return mvstud_plan_at(K, n, d, sizeof(T), 1, false);
}

// mvstud_plan_for, once a shape and device (its occupancy queries cost host
// time).
template <typename T>
MvPlan mvstud_plan(int64_t K, int64_t n, int64_t d, int sms) {
  static std::map<std::tuple<int, int64_t, int64_t, int64_t>, MvPlan> cache;
  int device = 0;
  cudaGetDevice(&device);
  const auto key = std::make_tuple(device, K, n, d);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  const MvPlan p = mvstud_plan_for<T>(K, n, d, sms);
  cache.emplace(key, p);
  return p;
}

bool valid_shape(int64_t K, int64_t n, int64_t d) {
  return K > 0 && n > 0 && d > 0 && K * 16 <= 0x7fffffff && d * (d + 1) / 2 <= 0x7fffffff &&
         n <= 0x7fffffffLL * 16;
}

template <typename T>
int entry(const void* data, const void* wbar, void* mu, void* Sigma, void* nu, void* last_nu,
          void* it, void* hit_inf, void* active, const void* tol, const void* max_iter,
          void* delta, void* part, void* work, int64_t K, int64_t n, int64_t d,
          void* stream) {
  const int sms = device_sms();
  if (!valid_shape(K, n, d) || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const MvPlan p = mvstud_plan<T>(K, n, d, sms);
  if (p.smem > kMaxSmem || (p.work_global && work == nullptr) ||
      (p.scratch && delta == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.delta = p.scratch ? static_cast<T*>(delta) : nullptr;
  a.part = static_cast<T*>(part);
  a.work = p.work_global ? static_cast<T*>(work) : nullptr;
  a.grid = p.grid != 0;
  a.n = n;
  a.d = static_cast<int>(d);
  a.G = static_cast<int>(p.ctas);
  a.points = static_cast<int>(p.points);
  a.x_smem = p.x_resident != 0;
  const int threads = static_cast<int>(p.threads);
  FitLaunch launch(K * p.ctas, static_cast<int>(p.cluster), p.grid != 0, threads, p.smem,
                   static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.cfg, mvstud_em_kernel<T>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.
//
// tempest_mvstud_em_plan: the plan of K weightings of n points in d
// dimensions with elements of elem bytes, on the current device (whose
// occupancy query sizes the clusters), into out[0, 14), the fields of
// tempest_gmm_em_plan (gmm_em.cu), the per-point scratch holding the
// distances. Host only.
extern "C" int tempest_mvstud_em_plan(int64_t K, int64_t n, int64_t d, int64_t elem,
                                      int64_t* out) {
  const int sms = device_sms();
  if (!valid_shape(K, n, d) || (elem != 4 && elem != 8) || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = elem == 4 ? prepare<float>() : prepare<double>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const MvPlan p = elem == 4 ? mvstud_plan<float>(K, n, d, sms) : mvstud_plan<double>(K, n, d, sms);
  const int64_t v[14] = {p.ctas, p.cluster, p.grid, p.threads, p.smem,
                         p.work_in_smem, p.work_elems, p.x_resident, p.points_resident, p.points,
                         p.emax, p.scratch, p.part, p.work_global};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// tempest_mvstud_em in float32, tempest_mvstud_em_f64 in float64: data (n,
// d) and wbar (K, n) of the type; the carry mu (K, d), Sigma (K, d, d), nu
// and last_nu (K,) of the type, i (K,) int32, hit_inf and active (K,) bool,
// updated in place; tol (the type) and max_iter (int32) device words; the
// scratch buffers of the plan's sizes (delta and work may be null where
// the plan has none). Each launches on `stream` of the
// current device without synchronising and returns a cudaError_t.
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
                                     void* delta, void* part, void* work, int64_t K,
                                     int64_t n, int64_t d, void* stream) {
  return entry<double>(data, wbar, mu, Sigma, nu, last_nu, it, hit_inf, active, tol, max_iter,
                       delta, part, work, K, n, d, stream);
}
