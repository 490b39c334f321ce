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
// an iteration costs at least two cluster reductions (about 1 us each on an
// H100) and the K factorizations between them, times the iterations the
// data needs: 0.03-0.05 ms at A's leaf fits. The bytes (X read once, 82 KB
// a fit there) and the operations (about 2 K d^2 n flops an iteration) are
// smaller still. Measured, an iteration takes 50-80 us there: the CTAs'
// dependent loads, divisions and barriers issue far below the SMs' rate
// (PERF.md).
//
// What this design does about it:
//  - One cluster of C CTAs a fit (em::cluster_for: at most 512 points a CTA,
//    C <= 16), so B fits run side by side; CTA r owns a contiguous slice of
//    the points and stages it through shared memory, P1 points at a time
//    for the E-step (column-major; a point a thread, or at large d, where
//    few points fit, a group of threads sharing out its rows:
//    em::mahalanobis_chunk) and P2 at a time for the sums (row-major, every
//    thread reading the same point). CTAs of 512 threads, but 256 in
//    float32 where the fits fill the card (em::cta_for).
//  - Every CTA factors all K covariances itself (a CTA-parallel Cholesky
//    and one thread a column of L^-1) from its own copy of the parameters:
//    no broadcast and no barrier besides the reductions. Parameters and
//    factors live in shared memory where they fit and in a global work area
//    otherwise (large K d^2).
//  - Two cluster reductions an iteration (em::cluster_sum), each in a fixed
//    order; a converged fit skips its second one, whose results it would not
//    keep. The responsibilities go to a global scratch (B, n, K) between the
//    E-step and the sums, read back by the same CTA.
//  - max_iter and tol are device words, so a CUDA graph can hold the launch.
// Nothing is atomic: a launch repeats its bits.

#include "em_common.cuh"

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
  T* wresp;          // (B, n, K) scratch
  T* part;           // (2, B C, emax) scratch
  T* work;           // (B C, work_elems) global work area, or null: in shared memory
  int64_t n;
  int d, K, cov, C, P1, P2;
  double reg;
};

// Sizes and offsets (in elements of the type) of a CTA's work area, and of
// its staging buffer; the host plans with the same struct.
struct GmmLayout {
  int64_t pi, means, covs, linv, logdet, ltmp, nk, mine, tot, elems;
  int64_t e1, e2, emax, stage;

  __host__ __device__ GmmLayout(int64_t K, int64_t d, int cov, int64_t P1, int64_t P2) {
    e1 = K + K * d + 1;  // nk, sum w r x, the bound
    e2 = cov == kDiag ? K * d : cov == kSpherical ? K : K * d * (d + 1) / 2;
    emax = e1 > e2 ? e1 : e2;
    pi = 0;
    means = pi + K;
    covs = means + K * d;
    linv = covs + K * d * d;
    logdet = linv + K * d * d;
    ltmp = logdet + K;
    nk = ltmp + d * d;
    mine = nk + K;
    tot = mine + emax;
    elems = tot + emax;
    const int64_t s1 = (2 * d + 1) * P1, s2 = P2 * (K * d + K);
    stage = s1 > s2 ? s1 : s2;
  }
};

template <typename T>
struct GmmHeader {
  T lb, nksum;
  int flag, done, n_iter;
};

// Rows of the first sums: the point (d), then its K weighted responsibilities.
template <typename T>
struct StageSums {
  const T* X;
  const T* wresp;
  int d, K;
  __device__ void operator()(int64_t p0, int np, T* buf) const {
    const int width = d + K;
    for (int idx = threadIdx.x; idx < np * width; idx += blockDim.x) {
      const int p = idx / width, c = idx - p * width;
      buf[idx] = c < d ? __ldg(X + (p0 + p) * d + c) : wresp[(p0 + p) * K + (c - d)];
    }
  }
};

// Rows of the scatter: x - means_k for each k (K d), then the K weighted
// responsibilities.
template <typename T>
struct StageScatter {
  const T* X;
  const T* wresp;
  const T* means;
  int d, K;
  __device__ void operator()(int64_t p0, int np, T* buf) const {
    const int width = K * d + K;
    for (int idx = threadIdx.x; idx < np * width; idx += blockDim.x) {
      const int p = idx / width, c = idx - p * width;
      if (c < K * d) {
        const int i = c % d;
        buf[idx] = __ldg(X + (p0 + p) * d + i) - means[c];
      } else {
        buf[idx] = wresp[(p0 + p) * K + (c - K * d)];
      }
    }
  }
};

struct SumsEntries {  // nk_k, then sum w r_k x_i
  int d, K;
  __device__ Entry operator()(int e) const {
    if (e < K) return Entry{e, -1, -1, 0};
    const int k = (e - K) / d, i = (e - K) % d;
    return Entry{k, i, -1, 0};
  }
};

struct ScatterEntries {  // per component: the lower triangle, the diagonal, or the trace
  int d, K, cov;
  __device__ Entry operator()(int e) const {
    if (cov == kSpherical) return Entry{e, e * d, -1, d};
    if (cov == kDiag) {
      const int k = e / d, i = e % d;
      return Entry{k, k * d + i, k * d + i, 0};
    }
    const int per = d * (d + 1) / 2;
    const int k = e / per;
    int i, j;
    tri_index(e % per, i, j);
    return Entry{k, k * d + i, k * d + j, 0};
  }
};

template <typename T>
__device__ void gmm_em_body(const GmmArgs<T>& a, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.C, d = a.d, K = a.K, P1 = a.P1;
  const int t = threadIdx.x, nt = blockDim.x;
  const int fit = blockIdx.x / C;
  const GmmLayout lay(K, d, a.cov, P1, a.P2);
  GmmHeader<T>& h = *reinterpret_cast<GmmHeader<T>*>(smem);
  T* red = reinterpret_cast<T*>(smem + kHeaderBytes);
  T* stage = red + nt;
  T* w = a.work ? a.work + static_cast<int64_t>(blockIdx.x) * lay.elems : stage + lay.stage;
  T* pi = w + lay.pi;
  T* means = w + lay.means;
  T* covs = w + lay.covs;
  T* linv = w + lay.linv;
  T* logdet = w + lay.logdet;
  T* ltmp = w + lay.ltmp;
  T* nk = w + lay.nk;
  T* mine = w + lay.mine;
  T* tot = w + lay.tot;

  const int64_t n = a.n;
  const T* X = a.X + static_cast<int64_t>(fit) * n * d;
  const T* sw = a.sw + static_cast<int64_t>(fit) * n;
  T* wresp = a.wresp + static_cast<int64_t>(fit) * n * K;
  const int64_t buf_elems = static_cast<int64_t>(gridDim.x) * lay.emax;
  T* rows = a.part + static_cast<int64_t>(fit) * C * lay.emax;
  const int64_t begin = n * rank / C, end = n * (rank + 1) / C;
  const int KD = K * d, KDD = K * d * d;

  for (int i = t; i < K; i += nt) pi[i] = a.pi[fit * K + i];
  for (int i = t; i < KD; i += nt) means[i] = a.means[static_cast<int64_t>(fit) * KD + i];
  for (int i = t; i < KDD; i += nt) covs[i] = a.covs[static_cast<int64_t>(fit) * KDD + i];
  if (t == 0) {
    h.lb = a.lb[fit];
    h.n_iter = a.n_iter[fit];
    h.done = a.done[fit] != 0;
  }
  const T tol = *a.tol;
  const int max_iter = *a.max_iter;
  const T reg = static_cast<T>(a.reg);
  const T sqrt_reg = static_cast<T>(sqrt(a.reg));
  const T eps = static_cast<T>(kEps);
  const T c0 = static_cast<T>(d * kLog2Pi);
  __syncthreads();

  int parity = 0;
  while (!h.done && h.n_iter < max_iter) {  // CTA- and cluster-uniform
    // The factors of cov_k + reg I, or sqrt(reg) I where Cholesky fails.
    for (int k = 0; k < K; ++k) {
      for (int q = t; q < d * d; q += nt) {
        ltmp[q] = covs[k * d * d + q] + (q / d == q % d ? reg : T(0));
      }
      __syncthreads();
      if (!cholesky(ltmp, d, &h.flag)) {
        for (int q = t; q < d * d; q += nt) ltmp[q] = q / d == q % d ? sqrt_reg : T(0);
        __syncthreads();
      }
      if (t == 0) {
        T s = T(0);
        for (int i = 0; i < d; ++i) s += em_log(ltmp[i * d + i]);
        logdet[k] = T(2) * s;
      }
      tri_inverse(ltmp, linv + k * d * d, d);
    }

    // The E-step: log densities, responsibilities and this CTA's bound.
    T* xs = stage;            // [d][P1]
    T* dif = stage + d * P1;  // [d][P1]
    T* maha = stage + 2 * d * P1;  // [P1]
    T lbacc = T(0);
    for (int64_t p0 = begin; p0 < end; p0 += P1) {
      const int np = static_cast<int>(end - p0 < P1 ? end - p0 : P1);
      for (int idx = t; idx < np * d; idx += nt) {
        const int p = idx / d, j = idx - p * d;
        xs[j * P1 + p] = __ldg(X + (p0 + p) * d + j);
      }
      __syncthreads();
      for (int k = 0; k < K; ++k) {
        mahalanobis_chunk(linv + k * d * d, means + k * d, d, xs, dif, P1, np, red, maha);
        for (int c = t; c < np; c += nt) {
          wresp[(p0 + c) * K + k] = T(-0.5) * ((c0 + logdet[k]) + maha[c]);
        }
      }
      for (int c = t; c < np; c += nt) {
        const int64_t p = p0 + c;
        T* wr = wresp + p * K;
        T lik = T(0);
        for (int k = 0; k < K; ++k) lik += pi[k] * em_exp(wr[k]);
        const T swp = __ldg(sw + p);
        for (int k = 0; k < K; ++k) wr[k] = (pi[k] * em_exp(wr[k])) / (lik + eps) * swp;
        lbacc += swp * em_log(lik + eps);
      }
      __syncthreads();
    }
    {
      const T v[1] = {lbacc};
      cta_sum<T, 1>(v, red);
      if (t == 0) mine[lay.e1 - 1] = red[0];
      __syncthreads();
    }
    weighted_sums(StageSums<T>{X, wresp, d, K}, SumsEntries{d, K}, K + KD, begin, end, d + K, d,
                  a.P2, stage, red, mine);
    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, static_cast<int>(lay.e1),
                mine, tot);
    parity ^= 1;

    const T new_lb = tot[lay.e1 - 1];
    if (t == 0) {
      h.n_iter += 1;
      h.done = (new_lb - h.lb) < tol;
      if (!h.done) {
        T s = T(0);
        for (int k = 0; k < K; ++k) s += tot[k];
        h.nksum = s;
        h.lb = new_lb;
      }
    }
    __syncthreads();
    if (h.done) break;  // the pre-M-step parameters stay

    // The M-step: pi, means, then the scatter around the new means.
    const T denom = clamp_min(h.nksum, eps);
    for (int k = t; k < K; k += nt) {
      nk[k] = tot[k];
      pi[k] = tot[k] / denom;
    }
    for (int i = t; i < KD; i += nt) means[i] = tot[K + i] / (tot[i / d] + eps);
    __syncthreads();
    weighted_sums(StageScatter<T>{X, wresp, means, d, K}, ScatterEntries{d, K, a.cov},
                  static_cast<int>(lay.e2), begin, end, KD + K, KD, a.P2, stage, red, mine);
    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, static_cast<int>(lay.e2),
                mine, tot);
    parity ^= 1;
    const int per = d * (d + 1) / 2;
    for (int q = t; q < KDD; q += nt) {
      const int k = q / (d * d), r = q % (d * d), i = r / d, j = r % d;
      T v;
      if (a.cov == kFull) {
        v = tot[k * per + (i >= j ? tri_entry(i, j) : tri_entry(j, i))] / (nk[k] + eps);
      } else if (a.cov == kTied) {
        const int e = i >= j ? tri_entry(i, j) : tri_entry(j, i);
        T s = T(0);
        for (int c = 0; c < K; ++c) s += tot[c * per + e];
        v = s / denom;
      } else if (a.cov == kDiag) {
        v = i == j ? tot[k * d + i] / (nk[k] + eps) : T(0);
      } else {
        v = tot[k] / (nk[k] * static_cast<T>(d) + eps) * (i == j ? T(1) : T(0));
      }
      covs[q] = v;
    }
    __syncthreads();
  }

  if (rank == 0) {
    for (int i = t; i < K; i += nt) a.pi[fit * K + i] = pi[i];
    for (int i = t; i < KD; i += nt) a.means[static_cast<int64_t>(fit) * KD + i] = means[i];
    for (int i = t; i < KDD; i += nt) a.covs[static_cast<int64_t>(fit) * KDD + i] = covs[i];
    if (t == 0) {
      a.lb[fit] = h.lb;
      a.n_iter[fit] = h.n_iter;
      a.done[fit] = static_cast<uint8_t>(h.done);
    }
  }
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) gmm_em_kernel(GmmArgs<T> a) {
  extern __shared__ __align__(16) unsigned char em_dynamic_smem[];
  gmm_em_body<T>(a, em_dynamic_smem);
}

// The launch plan of B fits of n points: cluster size, shared memory bytes,
// where the work area lives and the scratch sizes (elements).
struct GmmPlan {
  int64_t C, smem, work_in_smem, work_elems, emax, P1, P2, wresp, part, work_global, threads;
};

GmmPlan gmm_plan(int64_t B, int64_t n, int64_t d, int64_t K, int cov, int64_t elem) {
  GmmPlan p;
  p.C = cluster_for(n);
  p.threads = cta_for(B * p.C, elem);
  const int64_t red = p.threads * elem;
  const GmmLayout fixed(K, d, cov, 1, 1);
  const int64_t work_bytes = fixed.elems * elem;
  int64_t room = kMaxSmem - kHeaderBytes - red - work_bytes;
  p.work_in_smem = room >= 32 * (K * d + K) * elem && room >= 32 * (2 * d + 1) * elem;
  if (!p.work_in_smem) room = kMaxSmem - kHeaderBytes - red;
  const int64_t budget = room < kStageBytes ? room : kStageBytes;
  p.P1 = stage_rows(2 * d + 1, elem, budget, static_cast<int>(p.threads));
  p.P2 = stage_rows(K * d + K, elem, budget, 128);
  const GmmLayout lay(K, d, cov, p.P1, p.P2);
  p.work_elems = lay.elems;
  p.emax = lay.emax;
  p.smem = kHeaderBytes + red + lay.stage * elem + (p.work_in_smem ? lay.elems * elem : 0);
  p.wresp = B * n * K;
  p.part = 2 * B * p.C * lay.emax;
  p.work_global = p.work_in_smem ? 0 : B * p.C * lay.elems;
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
    status[device] = allow_cluster_and_smem(gmm_em_kernel<T, kSmallCta>);
    if (status[device] == cudaSuccess) {
      status[device] = allow_cluster_and_smem(gmm_em_kernel<T, kLargeCta>);
    }
    done[device] = true;
  }
  return status[device];
}

template <typename T>
int entry(const void* X, const void* sw, void* pi, void* means, void* covs, void* lb, void* n_iter,
          void* done, const void* tol, const void* max_iter, void* wresp, void* part, void* work,
          int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov, double reg, void* stream) {
  if (B <= 0 || n <= 0 || d <= 0 || K <= 0 || cov < 0 || cov > 3 || B * 16 > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GmmPlan p = gmm_plan(B, n, d, K, static_cast<int>(cov), sizeof(T));
  if (p.smem > kMaxSmem || (!p.work_in_smem && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
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
  a.wresp = static_cast<T*>(wresp);
  a.part = static_cast<T*>(part);
  a.work = p.work_in_smem ? nullptr : static_cast<T*>(work);
  a.n = n;
  a.d = static_cast<int>(d);
  a.K = static_cast<int>(K);
  a.cov = static_cast<int>(cov);
  a.C = static_cast<int>(p.C);
  a.P1 = static_cast<int>(p.P1);
  a.P2 = static_cast<int>(p.P2);
  a.reg = reg;
  const int threads = static_cast<int>(p.threads);
  ClusterLaunch launch(B * p.C, a.C, threads, p.smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.cfg,
                           threads == kLargeCta ? gmm_em_kernel<T, kLargeCta>
                                                : gmm_em_kernel<T, kSmallCta>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.
//
// tempest_gmm_em_plan: the plan of B fits of n points in d dimensions with
// K components, covariance type cov (0 full, 1 tied, 2 diag, 3 spherical)
// and elements of elem bytes, into out[0, 11): cluster size, shared memory
// bytes, whether the work area is in shared memory, its elements a CTA, the
// partials a CTA, the staging rows P1 and P2, the elements of the three
// scratch buffers (responsibilities, partials, global work area; 0 when in
// shared memory) and the CTA's threads. Host only.
extern "C" int tempest_gmm_em_plan(int64_t B, int64_t n, int64_t d, int64_t K, int64_t cov,
                                   int64_t elem, int64_t* out) {
  if (B <= 0 || n <= 0 || d <= 0 || K <= 0 || cov < 0 || cov > 3 || (elem != 4 && elem != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GmmPlan p = gmm_plan(B, n, d, K, static_cast<int>(cov), elem);
  const int64_t v[11] = {p.C, p.smem, p.work_in_smem, p.work_elems, p.emax, p.P1,
                         p.P2, p.wresp, p.part, p.work_global, p.threads};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// tempest_gmm_em in float32, tempest_gmm_em_f64 in float64: X (B, n, d) and
// sw (B, n) of the type; the carry pi (B, K), means (B, K, d), covs (B, K, d,
// d), lb (B,) of the type, n_iter (B,) int32 and done (B,) bool, updated in
// place; tol (the type) and max_iter (int32) device words; the scratch
// buffers of the plan's sizes (work may be null when the plan keeps it in
// shared memory); reg the covariance floor. Each launches on `stream` of the
// current device without synchronising and returns a cudaError_t.
extern "C" int tempest_gmm_em(const void* X, const void* sw, void* pi, void* means, void* covs,
                              void* lb, void* n_iter, void* done, const void* tol,
                              const void* max_iter, void* wresp, void* part, void* work, int64_t B,
                              int64_t n, int64_t d, int64_t K, int64_t cov, double reg,
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
