// Eigenvalues of a batch of symmetric matrices for Hopper (sm_90a): one CTA
// a matrix, Householder tridiagonalization in shared memory, then Sturm-count
// multisection, in float32 or float64 (a template on the scalar type; one C
// entry each).
//
// Replaces: XLA's `jnp.linalg.eigvalsh` in tempest_tpu/ops/tools.py:214
// (`volume_variation_dtn`) and :274 (`volume_variation`). It is not a Pallas
// kernel: the JAX package leaves this to XLA. The port needs its own because
// `torch.linalg.eigvalsh` on a CUDA tensor checks LAPACK's `info` on the host
// (a blocking read), which a CUDA graph cannot capture, and the CV is
// evaluated in every reweight, inside the loops that the fused route replays
// as graphs. Callers use the eigenvalues only for the rank test
// `eigvals > max|eigvals| d eps`.
//
// What it computes: the ascending eigenvalues of each (d, d) matrix, read
// from its lower triangle (as torch.linalg.eigvalsh reads UPLO="L"). A matrix
// with a non-finite entry gives NaN eigenvalues (no host check, no error).
//
// What bounds it on this card: one matrix lives on one SM, so neither the
// card's bytes nor its issue rate but one SM's latency through a chain of
// dependent steps. The least work is the reduction to tridiagonal form,
// about 4/3 d^3 flops, and reading the matrix once: at d = 100, 0.00002 ms
// over the whole card and 0.0026 ms at one SM's float32 issue rate. This
// kernel takes 0.2642 ms there and 0.0158-0.0160 ms at d = 10 (device time, one
// float32 matrix, NVIDIA H100 80GB HBM3 at 700 W, scripts/eig_designs.py),
// about 2.5 us a Householder step.
//
// What this design does about it (LAPACK's sytd2 + stebz, laid out for one
// CTA): the matrix, scaled by a power of two (exact) so that no square
// underflows or overflows, stays in shared memory, kept exactly symmetric.
// Step k of the d - 2 Householder steps takes two barriers: (1) every warp
// computes the reflector (v, tau) from row k itself, with a warp reduction
// (the same sums in the same order in every warp, so no barrier and no
// shared copy); (2) p = tau A22 v, eight lanes a row and four rows a warp,
// into shared memory; barrier; (3) every warp forms w = p - (tau/2)(p.v) v;
// (4) A22 -= v w^T + w v^T, a warp a row and a lane a column, each update
// summed as two rounded products so that a_ij and a_ji stay equal; barrier.
// At d = 100 that is 196 barriers where the parallel cyclic Jacobi this
// replaced took 2,673 (9 sweeps of 99 rounds, 3 barriers a round, 50
// of its 1024 threads computing rotations while the rest waited).
// Then each eigenvalue of the tridiagonal matrix comes from Sturm counts
// with no barrier: a group of g lanes of one warp (g = 8 at d = 10 and 100)
// evaluates g points of the eigenvalue's interval, a ballot picks the
// subinterval, and the interval shrinks (g + 1)-fold a round from the
// Gershgorin bounds down to 2 eps ||T|| (8 rounds in float32, 17 in float64
// at g = 8). The error is LAPACK syevd's class, a few d eps ||A|| absolute,
// which is what the rank test was written against. A rank sort writes the
// values in order (ties by index). Sums and maxima go in a fixed order and
// nothing is atomic, so a launch repeats its bits.
//
// The design it was weighed against, Jacobi with a round made one phase (a
// thread applies J_k^T A_kl J_l to a 2x2 block for each pair of pairs, the
// rotations computed by every thread from a read-only copy, one barrier a
// round), took 0.0265 ms at d = 10 and 1.974 ms at d = 100 in the same
// timing, slower than this kernel at both sizes (and than
// torch.linalg.eigvalsh's 1.361 ms at d = 100); its source is in
// scripts/eig_designs.py.
//
// Above what shared memory holds (the wrapper's plan: d > 238 in float32,
// d > 168 in float64) the matrix lives in a global workspace the wrapper
// allocates, one slice a CTA, and the same steps run on it (a barrier also
// orders the CTA's global memory accesses). No host read and no allocation
// here: the launch goes on the caller's stream and can be captured in a
// CUDA graph.

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxThreads = 1024;
// A cap on the multisection rounds of one eigenvalue (float64 at one lane a
// group, the least, needs about 55).
constexpr int kMaxRounds = 80;
// The shared memory a block of sm_90 may opt into: 227 KB.
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Per type: eps; a floor for the reflector's norm and for the Sturm pivots
// (the matrix is scaled to entries below 1, so both are far below
// eps ||A||); exact powers of two from the exponent bits; square root,
// reciprocal square root and division from the hardware's approximations
// and Newton steps: CUDA's IEEE division and square root call a slow-path
// subroutine that costs the kernel a stack frame (ptxas reported 4-16 bytes
// of spills with them); the product and sum of two products rounded apart
// (no contraction), so that the update of a_ij and a_ji is the same number.
template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ float eps() { return FLT_EPSILON; }
  static __device__ float tiny() { return 1e-18f; }
  static constexpr int kEmax = 125;
  // e with |a| < 2^e, for finite a > 0 (a subnormal a gives e = -126).
  static __device__ int exponent(float a) { return ((__float_as_int(a) >> 23) & 0xff) - 126; }
  static __device__ float pow2(int k) { return __int_as_float((k + 127) << 23); }
  // For a, b normal: the approximate hardware reciprocal (square root) and
  // one Newton step.
  static __device__ float rsqrt(float a) {
    const float y = rsqrtf(a);
    return y * (1.5f - 0.5f * a * y * y);
  }
  static __device__ float sqrt(float a) { return a * rsqrt(a); }
  static __device__ float div(float a, float b) {
    const float y = __fdividef(1.0f, b);
    return a * (y * (2.0f - b * y));
  }
  // The Sturm recurrence's a / b, |b| >= tiny: the hardware reciprocal
  // (about 1 ulp), on the recurrence's critical path.
  static __device__ float quick_div(float a, float b) { return __fdividef(a, b); }
  static __device__ float sym2(float a, float b, float c, float e) {
    return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, e));
  }
};
template <>
struct Num<double> {
  static __device__ double eps() { return DBL_EPSILON; }
  static __device__ double tiny() { return 1e-150; }
  static constexpr int kEmax = 1021;
  static __device__ int exponent(double a) {
    return static_cast<int>((__double_as_longlong(a) >> 52) & 0x7ff) - 1022;
  }
  static __device__ double pow2(int k) {
    return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
  }
  // For a > 0 normal: a = s 4^k with s in [1, 4), a float seed of
  // 1/sqrt(s) (about 2^-22 relative), three Newton steps, exact rescaling.
  static __device__ double rsqrt(double a) {
    const int k = (exponent(a) - 1) >> 1;  // floor, for negative exponents too
    const double s = a * pow2(-2 * k);
    double y = static_cast<double>(rsqrtf(static_cast<float>(s)));
    for (int i = 0; i < 3; ++i) y = y * (1.5 - 0.5 * s * y * y);
    return y * pow2(-k);
  }
  static __device__ double sqrt(double a) { return a * rsqrt(a); }
  // For |b| normal: b = s 2^k with |s| in [0.5, 1), a float seed of 1/s,
  // Newton steps (2^-22 -> 2^-44 -> 2^-88: two reach double precision),
  // exact rescaling.
  template <int kSteps = 3>
  static __device__ double div(double a, double b) {
    const int k = exponent(b);
    const double s = b * pow2(-k);
    double y = static_cast<double>(__fdividef(1.0f, static_cast<float>(s)));
#pragma unroll
    for (int i = 0; i < kSteps; ++i) y = y * (2.0 - s * y);
    return a * (y * pow2(-k));
  }
  static __device__ double quick_div(double a, double b) { return div<2>(a, b); }
  static __device__ double sym2(double a, double b, double c, double e) {
    return __dadd_rn(__dmul_rn(a, b), __dmul_rn(c, e));
  }
};

__device__ __forceinline__ float my_fabs(float a) { return fabsf(a); }
__device__ __forceinline__ double my_fabs(double a) { return ::fabs(a); }

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// The reduction of v over the lanes of an aligned group of `width` lanes
// (a power of two up to 32), the same bits in every lane of the group.
template <typename T, typename Op>
__device__ __forceinline__ T group_reduce(T v, int width, Op op) {
  for (int o = width >> 1; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The reduction of v over the CTA, the same value in every thread: warps by
// shuffles, then every thread combines the warp partials in warp order.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  v = group_reduce(v, 32, op);
  __syncthreads();  // the last reduction's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) r = op(r, red[w]);
  return r;
}

// The shared memory of one CTA: [A: m * ld if resident][diagonal, off-
// diagonal, p: m each][red: 32], with m = d rounded up to even and the row
// pitch ld = m + 1 (the wrapper's plan mirrors this).
template <typename T>
size_t smem_bytes(int d, bool resident) {
  const size_t m = d + (d & 1), ld = m + 1;
  return (resident ? m * ld * sizeof(T) : 0) + (3 * m + 32) * sizeof(T);
}

// The threads of a CTA for d: four rows of the matrix-vector product a warp,
// so that one pass covers the trailing block; 1 to 32 warps.
int threads_for(int d) {
  int warps = (d - 1 + 3) / 4;
  warps = warps < 1 ? 1 : (warps > 32 ? 32 : warps);
  return 32 * warps;
}

// The number of eigenvalues of the tridiagonal (dg, e) below x: the
// negative pivots of T - x I = L D L^T (Sturm), a pivot below pivmin in
// magnitude taken as -pivmin.
template <typename T>
__device__ __forceinline__ int sturm_count(const T* dg, const T* e, int n, T x, T pivmin) {
  T q = dg[0] - x;
  if (my_fabs(q) < pivmin) q = -pivmin;
  int count = q < 0;
  for (int i = 1; i < n; ++i) {
    const T ei = e[i - 1];
    q = (dg[i] - x) - Num<T>::quick_div(ei * ei, q);
    if (my_fabs(q) < pivmin) q = -pivmin;
    count += q < 0;
  }
  return count;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    sym_eigvals_kernel(const T* __restrict__ in, T* __restrict__ out, T* __restrict__ work,
                       int32_t* __restrict__ rounds_out, int d, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d, m = d + (d & 1), ld = m + 1;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  T* shared = reinterpret_cast<T*>(smem);
  T* A = resident ? shared : work + b * static_cast<int64_t>(m) * ld;
  T* dg = resident ? shared + static_cast<size_t>(m) * ld : shared;
  T* e = dg + m;
  T* p = e + m;  // the product A22 v, then the eigenvalues
  T* red = p + m;
  const T* a = in + b * static_cast<int64_t>(d) * d;

  // Load the lower triangle, a warp a row and a lane a column (coalesced),
  // and mirror it.
  T amax = 0;
  int bad = 0;
  for (int i = warp; i < n; i += warps) {
    for (int j = lane; j <= i; j += 32) {
      const T v = a[static_cast<int64_t>(i) * d + j];
      bad |= !isfinite(v);
      amax = Max()(amax, my_fabs(v));
      A[i * ld + j] = v;
      A[j * ld + i] = v;
    }
  }
  bad = __syncthreads_or(bad);
  if (bad) {
    for (int i = tid; i < d; i += nt) out[b * d + i] = static_cast<T>(CUDART_NAN_F);
    if (rounds_out != nullptr && tid == 0) rounds_out[b] = 0;
    return;
  }
  amax = block_reduce(amax, red, Max());

  // Scale by 2^-e so that the largest entry is in [0.5, 1) (e clamped to
  // the normal range): exact, and a_ij = a_ji still.
  int ex = amax > 0 ? Num<T>::exponent(amax) : 0;
  ex = ex < -Num<T>::kEmax ? -Num<T>::kEmax : (ex > Num<T>::kEmax ? Num<T>::kEmax : ex);
  const T down = Num<T>::pow2(-ex), up = Num<T>::pow2(ex);
  for (int i = warp; i < n; i += warps)
    for (int j = lane; j < n; j += 32) A[i * ld + j] *= down;
  __syncthreads();

  // Householder steps k = 0 .. n - 3: Q_k^T A Q_k zeroes column k below the
  // subdiagonal (LAPACK's dsytd2, lower). Row k equals column k, and neither
  // changes after step k.
  const int sub = lane >> 3, l8 = lane & 7;
  for (int k = 0; k + 2 < n; ++k) {
    const T* rk = A + k * ld;
    // (1) The reflector, in every warp: v = (1, x / (alpha - beta)),
    // tau = (beta - alpha) / beta, beta = -sign(alpha) ||(alpha, x)||.
    const T alpha = rk[k + 1];
    T sig = 0;
    for (int j = k + 2 + lane; j < n; j += 32) sig += rk[j] * rk[j];
    sig = group_reduce(sig, 32, Sum());
    T beta = alpha, tau = 0, scale = 0;
    if (sig > Num<T>::tiny()) {  // else H = I: |x| is far below eps ||A||
      const T norm = Num<T>::sqrt(alpha * alpha + sig);
      beta = alpha >= 0 ? -norm : norm;
      tau = Num<T>::div(beta - alpha, beta);
      scale = Num<T>::div(T(1), alpha - beta);
    }
    if (tid == 0) {
      dg[k] = rk[k];
      e[k] = beta;
    }
    if (tau == 0) continue;  // the same decision in every thread; A unchanged
    // (2) p = tau A22 v: eight lanes a row, four rows a warp.
    for (int base = k + 1 + 4 * warp; base < n; base += 4 * warps) {
      const int i = base + sub;
      T s = 0;
      if (i < n) {
        const T* ri = A + i * ld;
        for (int j = k + 1 + l8; j < n; j += 8) s += ri[j] * (j == k + 1 ? T(1) : rk[j] * scale);
      }
      s = group_reduce(s, 8, Sum());
      if (i < n && l8 == 0) p[i] = tau * s;
    }
    __syncthreads();
    // (3) w = p + c v with c = -(tau / 2) (p . v), in every warp.
    T pv = 0;
    for (int j = k + 1 + lane; j < n; j += 32) pv += p[j] * (j == k + 1 ? T(1) : rk[j] * scale);
    const T c = T(-0.5) * tau * group_reduce(pv, 32, Sum());
    // (4) A22 -= v w^T + w v^T: a warp a row, a lane a column.
    for (int i = k + 1 + warp; i < n; i += warps) {
      const T vi = i == k + 1 ? T(1) : rk[i] * scale;
      const T wi = p[i] + c * vi;
      T* ri = A + i * ld;
      for (int j = k + 1 + lane; j < n; j += 32) {
        const T vj = j == k + 1 ? T(1) : rk[j] * scale;
        const T wj = p[j] + c * vj;
        ri[j] -= Num<T>::sym2(vi, wj, wi, vj);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (n >= 2) {
      dg[n - 2] = A[(n - 2) * ld + n - 2];
      e[n - 2] = A[(n - 2) * ld + n - 1];
    }
    dg[n - 1] = A[(n - 1) * ld + n - 1];
  }
  __syncthreads();

  // Multisection: groups of g lanes (a power of two, g n <= threads where it
  // can), one eigenvalue a group; each round the g points lo + (l + 1) h,
  // h = (hi - lo) / (g + 1), are counted, and the interval shrinks to the
  // one between the last point with at most `target` eigenvalues below it
  // and the next.
  int g = 32;
  while (g > 1 && g * n > nt) g >>= 1;
  const int gl = lane & (g - 1), gbase = lane & ~(g - 1);
  const unsigned gmask = g == 32 ? kFull : ((1u << g) - 1u) << gbase;
  // The Gershgorin interval, in every group.
  T lo0 = 0, hi0 = 0;
  for (int i = gl; i < n; i += g) {
    const T r = (i > 0 ? my_fabs(e[i - 1]) : T(0)) + (i + 1 < n ? my_fabs(e[i]) : T(0));
    lo0 = i == gl ? dg[i] - r : Min()(lo0, dg[i] - r);
    hi0 = i == gl ? dg[i] + r : Max()(hi0, dg[i] + r);
  }
  if (gl >= n) lo0 = hi0 = dg[0];
  lo0 = group_reduce(lo0, g, Min());
  hi0 = group_reduce(hi0, g, Max());
  const T eps = Num<T>::eps(), pivmin = Num<T>::tiny();
  const T tnorm = Max()(my_fabs(lo0), my_fabs(hi0));
  const T widen = T(2.1) * eps * tnorm * n + T(4.2) * pivmin;
  lo0 -= widen;
  hi0 += widen;
  const T tol = T(2) * eps * tnorm + pivmin;
  const T step = Num<T>::div(T(1), T(g + 1));
  int rounds = 0;
  for (int first = 0; first < n; first += nt / g) {
    const int idx = first + tid / g;
    const int target = idx < n ? idx : n - 1;
    T lo = lo0, hi = hi0;
    int r = 0;
    for (; r < kMaxRounds && __any_sync(kFull, hi - lo > tol); ++r) {
      const T x = lo + T(gl + 1) * ((hi - lo) * step);
      const int below = __popc(__ballot_sync(kFull, sturm_count(dg, e, n, x, pivmin) <= target)
                               & gmask);
      const T xlo = __shfl_sync(kFull, x, gbase + (below > 0 ? below - 1 : 0));
      const T xhi = __shfl_sync(kFull, x, gbase + (below < g ? below : g - 1));
      if (below > 0) lo = xlo;
      if (below < g) hi = xhi;
    }
    rounds = r > rounds ? r : rounds;
    if (idx < n && gl == 0) p[idx] = T(0.5) * (lo + hi);
  }
  const T max_rounds = block_reduce(static_cast<T>(rounds), red, Max());  // its barrier orders p

  // Each value ranked (ties by index), scaled back and written in order.
  for (int i = tid; i < n; i += nt) {
    const T v = p[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T w = p[j];
      rank += (w < v) || (w == v && j < i);
    }
    out[b * d + rank] = v * up;
  }
  if (rounds_out != nullptr && tid == 0) rounds_out[b] = static_cast<int32_t>(max_rounds);
}

// Opts the kernel into the largest shared memory once per device; returns
// the cudaError_t of that step.
template <typename T>
cudaError_t prepare() {
  static bool checked[kMaxDevices] = {};
  static cudaError_t status[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!checked[device]) {
    status[device] = cudaFuncSetAttribute(sym_eigvals_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(kSmemMax));
    checked[device] = true;
  }
  return status[device];
}

template <typename T>
int entry(const void* a, void* w, void* work, void* rounds, int64_t batch, int d, int resident,
          void* stream) {
  if (batch < 0 || batch > 0x7fffffff || d < 1 || (!resident && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T>(d, resident != 0);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_eigvals_kernel<T><<<static_cast<unsigned>(batch), threads_for(d), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(work),
      static_cast<int32_t*>(rounds), d, resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes: tempest_sym_eigvals in float32,
// tempest_sym_eigvals_f64 in float64. a: (batch, d, d) contiguous, of which
// the lower triangle is read; w: (batch, d) out, ascending; work: (batch, m,
// m + 1) of the type with m = d rounded up to even, used when `resident` is
// 0 (else may be null); rounds: (batch,) int32 out, the multisection rounds
// of each matrix's slowest eigenvalue, or null. `resident` holds each matrix
// in shared memory (the wrapper's plan). Each launches on `stream` of the
// current device without synchronising and returns a cudaError_t.
extern "C" int tempest_sym_eigvals(const void* a, void* w, void* work, void* rounds,
                                   int64_t batch, int d, int resident, void* stream) {
  return entry<float>(a, w, work, rounds, batch, d, resident, stream);
}

extern "C" int tempest_sym_eigvals_f64(const void* a, void* w, void* work, void* rounds,
                                       int64_t batch, int d, int resident, void* stream) {
  return entry<double>(a, w, work, rounds, batch, d, resident, stream);
}
