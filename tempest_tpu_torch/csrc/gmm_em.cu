// Weighted Gaussian-mixture EM for Hopper (sm_90a): the whole EM loop of a
// batch of fits in one launch, in float32 or float64 (a template on the
// scalar type; one C entry each).
//
// Replaces: the vmapped `lax.while_loop` of the GMM EM
// (tempest_tpu/cluster.py:256), which XLA runs on the TPU without a host
// read, and on CUDA tensors the port's "gmm_em" device loop
// (tempest_tpu_torch/cluster.py, `_gmm_em_body` run by `loops.run_loop`:
// chunks of a few dozen small launches a body and one blocking read a
// chunk). It is not a Pallas kernel; the plain loop stays the CPU route and
// the yardstick (tempest_tpu_torch/ops/cuda_em.py).
//
// What it computes, for each fit b of X (B, n, d) under normalized weights
// sw (B, n), from the carry (pi, means, covs, lb, n_iter, done), while
// !done and n_iter < max_iter:
//  - the E-step at the current parameters: L_k = chol(cov_k + reg I), or
//    sqrt(reg) I where that fails or is not finite; log N(x | mean_k, cov_k
//    + reg I) through L_k^-1; lik = sum_k pi_k exp(lp_k); the
//    responsibilities r_k = pi_k exp(lp_k) / (lik + 1e-10); the lower bound
//    new_lb = sum sw log(lik + 1e-10);
//  - done = new_lb - lb < tol, n_iter += 1; a fit that is done keeps its
//    pre-M-step parameters and bound (PARITY.md deviation 5);
//  - else the M-step of `_m_step` for the covariance type ("full", "tied",
//    "diag", "spherical"; every type stored as full d x d matrices):
//    nk = sum w r, pi = nk / max(sum nk, eps), means = sum w r x / (nk +
//    eps), then the scatter around the new means.
// A fit that is done, or at max_iter, stays frozen, as under vmap. Any K and
// d are taken.
//
// What bounds it on this card: the chain, in the least time. Each EM
// iteration is two sums over all the fit's points whose results the next
// step needs (the E-step's nk, sum w r x and bound; then the scatter), so
// an iteration costs at least two fit reductions (about 1 us each on an
// H100) and the K factorizations between them, times the iterations the
// data needs: 0.03-0.05 ms at A's leaf fits. The bytes (X read once, 82 KB
// a fit there) and the operations (about 2 K d^2 n flops an iteration) are
// smaller still.
//
// What this design does about it (em_common.cuh has the shared parts):
//  - A fit's G CTAs (em_common.cuh, "The launch's geometry"): a cluster of
//    up to 16, as large as keeps the launch within the card's SMs and all
//    its clusters resident at once (A's largest round, 16 fits of 2,048
//    points: 16 x 6 = 96 CTAs on an H100), or, for one fit of more than 2,048
//    points, the whole grid, launched cooperatively. CTA r loads its slice
//    of X and sw into shared memory once a launch, and keeps each point's
//    weighted responsibilities there between the E-step and the sums (a
//    global scratch (B, n, K) only where they do not fit: none of phase
//    4d's shapes).
//  - The K factorizations run at once, a warp each, with no CTA barrier
//    at d <= 32 (em::warp_cholesky, em::warp_inverse, logdet a warp sum);
//    past 32 the CTA factors each component in panels.
//  - The E-step takes a point a thread (a group of lanes a point where the
//    CTA has few points: em::mahalanobis); the first sums (nk, sum w r x)
//    and the scatter are sums over the resident points, a few lanes an
//    entry (em::entry_sums), the bound a warp-shuffle sum (em::cta_sum);
//    two fit reductions an iteration (em::fit_sum), each in a fixed order;
//    a converged fit skips its second one, whose results it would not keep.
//  - max_iter and tol are device words, so a CUDA graph can hold the launch.
// Nothing is atomic: a launch repeats its bits.

#include <map>
#include <tuple>

#include "em_common.cuh"
#include "em_stamps.cuh"

namespace {

using namespace em;

constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
constexpr double kEps = 1e-10;
constexpr int kMaxDevices = 64;

enum CovType { kFull = 0, kTied = 1, kDiag = 2, kSpherical = 3 };

template <typename T>
struct GmmArgs {
  const T* X;        // (B, n, d)
  const T* sw;       // (B, n)
  T* pi;             // (B, K) carry, in and out
  T* means;          // (B, K, d)
  T* covs;           // (B, K, d, d)
  T* lb;             // (B,)
  int32_t* n_iter;   // (B,)
  uint8_t* done;     // (B,)
  const T* tol;      // device word
  const int32_t* max_iter;  // device word
  T* wresp;          // (B, n, K) scratch, or null: in shared memory
  T* part;           // (2, B, G + 1, emax) scratch
  T* work;           // (B G, work_elems) global work area, or null: in shared memory
  int64_t n;
  int d, K, cov, G, points;  // points: a CTA's at most
  bool x_smem, grid;  // grid: the fit's CTAs are the cooperative grid
  double reg;
};

// Sizes and offsets (in elements of the type) of a CTA's work area; the
// host plans with the same struct. Matrices are packed lower triangles.
struct GmmLayout {
  int64_t td, pi, means, covs, li, lwork, logdet, nk, mine, tot, elems, e1, e2, emax;

  __host__ __device__ GmmLayout(int64_t K, int64_t d, int cov, int64_t warps) {
    td = d * (d + 1) / 2;
    e1 = K + K * d + 1;  // nk, sum w r x, the bound
    e2 = cov == kDiag ? K * d : cov == kSpherical ? K : K * td;
    emax = e1 > e2 ? e1 : e2;
    const int64_t slots = d <= 32 ? (warps < K ? warps : K) : 1;  // a factor a warp
    pi = 0;
    means = pi + K;
    covs = means + K * d;
    li = covs + K * td;
    lwork = li + K * td;
    logdet = lwork + slots * td;
    nk = logdet + K;
    mine = nk + K;
    tot = mine + emax;
    elems = tot + emax;
  }
};

template <typename T>
__device__ void gmm_em_body(const GmmArgs<T>& a, unsigned char* smem) {
  const int G = a.G, d = a.d, K = a.K, cov = a.cov;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int fit = blockIdx.x / G, rank = blockIdx.x % G;
  const FitSync sync{a.grid};
  const GmmLayout lay(K, d, cov, nw);
  const int td = static_cast<int>(lay.td);
  int* flag = reinterpret_cast<int*>(smem);
  Acc* red = reinterpret_cast<Acc*>(smem + kHeaderBytes);
  T* next = reinterpret_cast<T*>(red + kRed * 32);
  T* w = a.work ? a.work + static_cast<int64_t>(blockIdx.x) * lay.elems : next;
  if (!a.work) next += lay.elems;
  T* pi = w + lay.pi;
  T* means = w + lay.means;
  T* covs = w + lay.covs;
  T* li = w + lay.li;
  T* lwork = w + lay.lwork;
  T* logdet = w + lay.logdet;
  T* nk = w + lay.nk;
  T* mine = w + lay.mine;
  T* tot = w + lay.tot;

  const int64_t n = a.n;
  const int64_t begin = n * rank / G, end = n * (rank + 1) / G;
  const int np = static_cast<int>(end - begin);
  const T* Xg = a.X + (static_cast<int64_t>(fit) * n + begin) * d;
  const T* swg = a.sw + static_cast<int64_t>(fit) * n + begin;
  const T* sw = swg;
  T* wr;  // (np, K): log densities, then weighted responsibilities
  if (a.wresp) {
    wr = a.wresp + (static_cast<int64_t>(fit) * n + begin) * K;
  } else {
    T* s = next;
    for (int p = t; p < np; p += nt) s[p] = swg[p];
    sw = s;
    wr = s + a.points;
    next = wr + static_cast<int64_t>(a.points) * K;
  }
  const T* xs = Xg;
  int ld = d;
  if (a.x_smem) {
    ld = smem_stride(d);
    for (int idx = t; idx < np * d; idx += nt) {
      const int p = idx / d, j = idx - p * d;
      next[p * ld + j] = Xg[idx];
    }
    xs = next;
  }

  for (int i = t; i < K; i += nt) pi[i] = a.pi[fit * K + i];
  for (int i = t; i < K * d; i += nt) means[i] = a.means[static_cast<int64_t>(fit) * K * d + i];
  for (int q = t; q < K * td; q += nt) {
    const int k = q / td;
    int i, j;
    tri_index(q - k * td, i, j);
    covs[q] = a.covs[(static_cast<int64_t>(fit) * K + k) * d * d + i * d + j];
  }
  T lb = a.lb[fit];
  int n_iter = a.n_iter[fit];
  bool done = a.done[fit] != 0, stepped = false;
  const T tol = *a.tol;
  const int max_iter = *a.max_iter;
  const T reg = static_cast<T>(a.reg);
  const T sqrt_reg = static_cast<T>(sqrt(a.reg));
  const T eps = static_cast<T>(kEps);
  const T c0 = static_cast<T>(d * kLog2Pi);
  const int64_t block = static_cast<int64_t>(G + 1) * lay.emax;
  T* rows0 = a.part + static_cast<int64_t>(fit) * block;
  const int64_t parity_stride = static_cast<int64_t>(gridDim.x / G) * block;
  __syncthreads();

  Stamps st;
  st.start();
  int parity = 0;
  while (!done && n_iter < max_iter) {  // CTA- and fit-uniform
    st.iteration();
    // The factors of cov_k + reg I, or sqrt(reg) I where Cholesky fails;
    // logdet; L^-1.
    if (d <= 32) {
      for (int k = warp; k < K; k += nw) {  // a warp a component, no CTA barrier
        T* L = lwork + warp * td;
        if (lane < d) {
          for (int j = 0; j <= lane; ++j) {
            L[tri(lane, j)] = covs[k * td + tri(lane, j)] + (j == lane ? reg : T(0));
          }
        }
        __syncwarp();
        if (!warp_cholesky(L, 0, d)) {
          if (lane < d) {
            for (int j = 0; j <= lane; ++j) L[tri(lane, j)] = j == lane ? sqrt_reg : T(0);
          }
          __syncwarp();
        }
        const T s = warp_sum(lane < d ? em_log(L[tri(lane, lane)]) : T(0));
        if (lane == 0) logdet[k] = T(2) * s;
        warp_inverse(L, li + k * td, d);
      }
    } else {
      for (int k = 0; k < K; ++k) {  // the CTA, a component at a time
        for (int i = warp; i < d; i += nw) {
          for (int j = lane; j <= i; j += 32) {
            lwork[tri(i, j)] = covs[k * td + tri(i, j)] + (j == i ? reg : T(0));
          }
        }
        __syncthreads();
        if (!cta_cholesky(lwork, d, flag)) {
          for (int i = warp; i < d; i += nw) {
            for (int j = lane; j <= i; j += 32) lwork[tri(i, j)] = j == i ? sqrt_reg : T(0);
          }
          __syncthreads();
        }
        if (warp == 0) {
          T s = T(0);
          for (int i = lane; i < d; i += 32) s += em_log(lwork[tri(i, i)]);
          s = warp_sum(s);
          if (lane == 0) logdet[k] = T(2) * s;
        }
        cta_inverse(lwork, li + k * td, d);
      }
    }
    __syncthreads();
    st.mark(0);

    // The E-step: each point's K log densities, then its weighted
    // responsibilities and its share of the bound.
    Acc lbacc = 0.0;
    {
      const int g = lanes_a_point(np, d), q = t & (g - 1), per_round = nt / g;
      for (int base = 0; base < np; base += per_round) {
        const int p = base + t / g;
        const bool valid = p < np;
        const T* x = xs + static_cast<int64_t>(valid ? p : 0) * ld;
        T* r = wr + static_cast<int64_t>(p) * K;
        for (int k = 0; k < K; ++k) {
          const T m = mahalanobis(li + k * td, means + k * d, x, d, q, g, valid);
          if (valid && q == 0) r[k] = pi[k] * em_exp(T(-0.5) * ((c0 + logdet[k]) + m));
        }
        if (valid && q == 0) {
          T lik = T(0);
          for (int k = 0; k < K; ++k) lik += r[k];
          const T swp = sw[p];
          for (int k = 0; k < K; ++k) r[k] = r[k] / (lik + eps) * swp;
          lbacc += static_cast<Acc>(swp * em_log(lik + eps));
        }
      }
    }
    __syncthreads();
    st.mark(1);

    // The first sums: nk, sum w r x and the bound.
    {
      Acc v[1] = {lbacc};
      cta_sum<1>(v, red, mine + lay.e1 - 1);
    }
    entry_sums<T>(
        [&](int e) {
          const int k = e < K ? e : (e - K) / d, i = e < K ? -1 : (e - K) % d;
          return [=](int p) {
            const T rk = wr[static_cast<int64_t>(p) * K + k];
            return i < 0 ? rk : rk * xs[static_cast<int64_t>(p) * ld + i];
          };
        },
        K + K * d, np, mine);
    st.mark(2);
    fit_sum(sync, rows0 + parity * parity_stride, lay.emax, rank, G, static_cast<int>(lay.e1),
            mine, tot);
    parity ^= 1;
    st.mark(3);

    const T new_lb = tot[lay.e1 - 1];
    n_iter += 1;
    done = (new_lb - lb) < tol;
    if (done) break;  // the pre-M-step parameters stay
    lb = new_lb;

    // The M-step: pi, means, then the scatter around the new means.
    T nksum = T(0);
    for (int k = 0; k < K; ++k) nksum += tot[k];
    const T denom = clamp_min(nksum, eps);
    for (int k = t; k < K; k += nt) {
      nk[k] = tot[k];
      pi[k] = tot[k] / denom;
    }
    for (int i = t; i < K * d; i += nt) means[i] = tot[K + i] / (tot[i / d] + eps);
    __syncthreads();
    st.mark(6);
    const int e2 = static_cast<int>(lay.e2);
    entry_sums<T>(
        [&](int e) {
          int k, i, j;
          if (cov == kSpherical) {
            k = e;
            i = j = -1;
          } else if (cov == kDiag) {
            k = e / d;
            i = j = e - k * d;
          } else {
            k = e / td;
            tri_index(e - k * td, i, j);
          }
          const T* m = means + k * d;
          return [=](int p) {
            const T* x = xs + static_cast<int64_t>(p) * ld;
            const T rk = wr[static_cast<int64_t>(p) * K + k];
            if (i < 0) {
              T s = T(0);
              for (int c = 0; c < d; ++c) s += (x[c] - m[c]) * (x[c] - m[c]);
              return rk * s;
            }
            return rk * (x[i] - m[i]) * (x[j] - m[j]);
          };
        },
        e2, np, mine);
    st.mark(4);
    fit_sum(sync, rows0 + parity * parity_stride, lay.emax, rank, G, e2, mine, tot);
    parity ^= 1;
    st.mark(5);
    for (int q = t; q < K * td; q += nt) {
      const int k = q / td, r = q - k * td;
      int i, j;
      tri_index(r, i, j);
      T v;
      if (cov == kFull) {
        v = tot[q] / (nk[k] + eps);
      } else if (cov == kTied) {
        T s = T(0);
        for (int c = 0; c < K; ++c) s += tot[c * td + r];
        v = s / denom;
      } else if (cov == kDiag) {
        v = i == j ? tot[k * d + i] / (nk[k] + eps) : T(0);
      } else {
        v = i == j ? tot[k] / (nk[k] * static_cast<T>(d) + eps) : T(0);
      }
      covs[q] = v;
    }
    stepped = true;
    __syncthreads();
  }
  st.mark(6);
  st.finish();

  if (rank == 0) {
    for (int i = t; i < K; i += nt) a.pi[fit * K + i] = pi[i];
    for (int i = t; i < K * d; i += nt) a.means[static_cast<int64_t>(fit) * K * d + i] = means[i];
    if (stepped) {  // else the carry's own bits stay
      for (int64_t q = t; q < static_cast<int64_t>(K) * d * d; q += nt) {
        const int k = static_cast<int>(q / (d * d)), r = static_cast<int>(q % (d * d));
        const int i = r / d, j = r % d;
        a.covs[static_cast<int64_t>(fit) * K * d * d + q] =
            covs[k * td + (i >= j ? tri(i, j) : tri(j, i))];
      }
    }
    if (t == 0) {
      a.lb[fit] = lb;
      a.n_iter[fit] = n_iter;
      a.done[fit] = static_cast<uint8_t>(done);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gmm_em_kernel(GmmArgs<T> a) {
  extern __shared__ __align__(16) unsigned char em_dynamic_smem[];
  gmm_em_body<T>(a, em_dynamic_smem);
}

// The launch plan of B fits of n points (tempest_gmm_em_plan's fields).
struct GmmPlan {
  int64_t ctas, cluster, grid, threads, smem, work_in_smem, work_elems, x_resident,
      points_resident, points, emax, scratch, part, work_global;
};

// The plan with G = ctas CTAs a fit.
GmmPlan gmm_plan_at(int64_t B, int64_t n, int64_t d, int64_t K, int cov, int64_t elem,
                    int64_t ctas, bool grid) {
  GmmPlan p;
  p.ctas = ctas;
  p.grid = grid;
  p.cluster = grid ? 1 : ctas;
  p.points = (n + ctas - 1) / ctas;
  p.threads = kThreads;
  const GmmLayout lay(K, d, cov, p.threads / 32);
  const SmemPlan s = smem_plan(elem, lay.elems, 1 + K, p.points, smem_stride(static_cast<int>(d)));
  p.smem = s.bytes;
  p.work_in_smem = s.work;
  p.work_elems = lay.elems;
  p.x_resident = s.x;
  p.points_resident = s.points;
  p.emax = lay.emax;
  p.scratch = s.points ? 0 : B * n * K;
  p.part = 2 * B * (ctas + 1) * lay.emax;
  p.work_global = s.work ? 0 : B * ctas * lay.elems;
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
    status[device] = allow_cluster_and_smem(gmm_em_kernel<T>);
    done[device] = true;
  }
  return status[device];
}

// The plan: the grid for one large fit, else the largest cluster whose
// clusters are all resident at once (em_common.cuh, "The launch's geometry").
template <typename T>
GmmPlan gmm_plan_for(int64_t B, int64_t n, int64_t d, int64_t K, int cov, int sms) {
  if (grid_route(B, n)) return gmm_plan_at(B, n, d, K, cov, sizeof(T), grid_ctas(n, sms), true);
  for (int64_t c = largest_cluster(B, n, sms); c > 1; --c) {
    const GmmPlan p = gmm_plan_at(B, n, d, K, cov, sizeof(T), c, false);
    if (resident_clusters(gmm_em_kernel<T>, static_cast<int>(c), kThreads, p.smem) >= B) {
      return p;
    }
  }
  return gmm_plan_at(B, n, d, K, cov, sizeof(T), 1, false);
}

// gmm_plan_for, once a shape and device (its occupancy queries cost host time).
template <typename T>
GmmPlan gmm_plan(int64_t B, int64_t n, int64_t d, int64_t K, int cov, int sms) {
  static std::map<std::tuple<int, int64_t, int64_t, int64_t, int64_t, int>, GmmPlan> cache;
  int device = 0;
  cudaGetDevice(&device);
  const auto key = std::make_tuple(device, B, n, d, K, cov);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  const GmmPlan p = gmm_plan_for<T>(B, n, d, K, cov, sms);
  cache.emplace(key, p);
  return p;
}

bool valid_shape(int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov) {
  return B > 0 && n > 0 && d > 0 && K > 0 && cov >= 0 && cov <= 3 && B * 16 <= 0x7fffffff &&
         d * (d + 1) / 2 * K <= 0x7fffffff && n <= 0x7fffffffLL * 16;
}

template <typename T>
int entry(const void* X, const void* sw, void* pi, void* means, void* covs, void* lb, void* n_iter,
          void* done, const void* tol, const void* max_iter, void* wresp, void* part, void* work,
          int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov, double reg,
          void* stream) {
  const int sms = device_sms();
  if (!valid_shape(B, n, d, K, cov) || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const GmmPlan p = gmm_plan<T>(B, n, d, K, static_cast<int>(cov), sms);
  if (p.smem > kMaxSmem || (p.work_global && work == nullptr) ||
      (p.scratch && wresp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GmmArgs<T> a;
  a.X = static_cast<const T*>(X);
  a.sw = static_cast<const T*>(sw);
  a.pi = static_cast<T*>(pi);
  a.means = static_cast<T*>(means);
  a.covs = static_cast<T*>(covs);
  a.lb = static_cast<T*>(lb);
  a.n_iter = static_cast<int32_t*>(n_iter);
  a.done = static_cast<uint8_t*>(done);
  a.tol = static_cast<const T*>(tol);
  a.max_iter = static_cast<const int32_t*>(max_iter);
  a.wresp = p.scratch ? static_cast<T*>(wresp) : nullptr;
  a.part = static_cast<T*>(part);
  a.work = p.work_global ? static_cast<T*>(work) : nullptr;
  a.grid = p.grid != 0;
  a.n = n;
  a.d = static_cast<int>(d);
  a.K = static_cast<int>(K);
  a.cov = static_cast<int>(cov);
  a.G = static_cast<int>(p.ctas);
  a.points = static_cast<int>(p.points);
  a.x_smem = p.x_resident != 0;
  a.reg = reg;
  const int threads = static_cast<int>(p.threads);
  FitLaunch launch(B * p.ctas, static_cast<int>(p.cluster), p.grid != 0, threads, p.smem,
                   static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.cfg, gmm_em_kernel<T>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.
//
// tempest_gmm_em_plan: the plan of B fits of n points in d dimensions with
// K components, covariance type cov (0 full, 1 tied, 2 diag, 3 spherical)
// and elements of elem bytes, on the current device (whose occupancy
// query sizes the clusters), into out[0, 14): CTAs
// a fit, cluster size (1 for a fit over the grid), whether one fit takes the
// grid (a cooperative launch), the CTA's threads, shared memory bytes,
// whether the work area is in shared memory, its elements a CTA, whether
// the points and their per-point values are in shared memory, a CTA's
// points at most, the partials a CTA and reduction, and the elements of the
// scratch buffers: responsibilities (0 when in shared memory), partials,
// the global work area (0 when in shared memory). Host only.
extern "C" int tempest_gmm_em_plan(int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov,
                                   int64_t elem, int64_t* out) {
  const int sms = device_sms();
  if (!valid_shape(B, n, d, K, cov) || (elem != 4 && elem != 8) || sms <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = elem == 4 ? prepare<float>() : prepare<double>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const GmmPlan p = elem == 4 ? gmm_plan<float>(B, n, d, K, static_cast<int>(cov), sms)
                              : gmm_plan<double>(B, n, d, K, static_cast<int>(cov), sms);
  const int64_t v[14] = {p.ctas, p.cluster, p.grid, p.threads, p.smem,
                         p.work_in_smem, p.work_elems, p.x_resident, p.points_resident, p.points,
                         p.emax, p.scratch, p.part, p.work_global};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// tempest_gmm_em in float32, tempest_gmm_em_f64 in float64: X (B, n, d) and
// sw (B, n) of the type; the carry pi (B, K), means (B, K, d), covs (B, K, d,
// d), lb (B,) of the type, n_iter (B,) int32 and done (B,) bool, updated in
// place; tol (the type) and max_iter (int32) device words; the scratch
// buffers of the plan's sizes (wresp and work may be null where the plan
// has none); reg the covariance floor. Each launches on
// `stream` of the current device without synchronising and returns a
// cudaError_t.
extern "C" int tempest_gmm_em(const void* X, const void* sw, void* pi, void* means, void* covs,
                              void* lb, void* n_iter, void* done, const void* tol,
                              const void* max_iter, void* wresp, void* part, void* work,
                              int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov, double reg,
                              void* stream) {
  return entry<float>(X, sw, pi, means, covs, lb, n_iter, done, tol, max_iter, wresp, part, work,
                      B, n, d, K, cov, reg, stream);
}

extern "C" int tempest_gmm_em_f64(const void* X, const void* sw, void* pi, void* means, void* covs,
                                  void* lb, void* n_iter, void* done, const void* tol,
                                  const void* max_iter, void* wresp, void* part, void* work,
                                  int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov,
                                  double reg, void* stream) {
  return entry<double>(X, sw, pi, means, covs, lb, n_iter, done, tol, max_iter, wresp, part, work,
                       B, n, d, K, cov, reg, stream);
}
