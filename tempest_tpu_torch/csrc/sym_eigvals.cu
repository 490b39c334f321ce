// Eigenvalues of a batch of symmetric matrices for Hopper (sm_90a): one CTA
// a matrix, parallel cyclic Jacobi, in float32 or float64 (a template on the
// scalar type; one C entry each).
//
// Replaces: XLA's `jnp.linalg.eigvalsh` in tempest_tpu/ops/tools.py:214
// (`volume_variation_dtn`) and :274 (`volume_variation`). It is not a Pallas
// kernel: the JAX package leaves this to XLA. The port needs its own because
// `torch.linalg.eigvalsh` on a CUDA tensor checks LAPACK's `info` on the host
// (a blocking read), which a CUDA graph cannot capture, and the CV of dynamic
// mode is evaluated inside the bisection loop that the fused route replays as
// a graph. Callers use the eigenvalues only for the rank test
// `eigvals > max|eigvals| d eps`.
//
// What it computes: the ascending eigenvalues of each (d, d) matrix, read
// from its lower triangle (as torch.linalg.eigvalsh reads UPLO="L"). A matrix
// with a non-finite entry gives NaN eigenvalues (no host check, no error).
//
// What bounds it on this card: at the caller's d = 10 and a batch of one,
// neither bytes (440) nor operations (about 10^5 flops) but the launch and
// the chain of the sweeps: each rotation round depends on the last, and one
// matrix lives on one SM. The launch floor (about 1 us of device time) is the
// practical bound there.
//
// What this design does about it, and why Jacobi: a d <= 128 matrix fits one
// SM's shared memory (64 KB in float32, 128 KB in float64), so every sweep
// reads and writes shared memory only, and the convergence test runs on the
// device. Jacobi needs no tridiagonal reduction and no shift strategy (the
// LAPACK route: Householder steps of sequential matrix-vector products, then
// QR or divide and conquer), only rotations that are independent within a
// round: the round-robin (tournament) order pairs the m = d rounded up to
// even indices into m/2 disjoint pairs per round, m - 1 rounds a sweep, so a
// round is one step for the whole CTA: (1) each pair's rotation (c, s) from
// a_pp, a_qq, a_pq (Golub and Van Loan's symmetric Schur step, written
// with one division that cannot overflow); (2) the rows p, q of every
// pair, J^T A; (3) the columns, (J^T A) J, with a_pq = a_qp = 0 written
// exactly; a barrier after each (a CTA has a thread for each of a step's
// m^2 / 2 updates, up to 1024). Disjoint rotations commute, so the round is
// the product of its rotations. The matrix is scaled by a power of two first
// (exact), so its squares neither underflow nor overflow. Before each sweep
// the CTA sums the off-diagonal squares and stops when
// off(A) <= eps ||A||_F, at most kMaxSweeps = 30 sweeps (quadratic
// convergence takes 5-10 at d <= 128). The sums and maxima are in a fixed
// order, so a launch repeats its bits. At the end each thread ranks its
// diagonal entries among all (ties by index) and writes them sorted.
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
constexpr int kMaxSweeps = 30;
// The shared memory a block of sm_90 may opt into: 227 KB.
constexpr size_t kSmemMax = 232448;

// Per type: eps; the |a_pq| below which no rotation is made (its square
// would underflow; the matrix is scaled to entries below 1, so such an
// entry is far below eps ||A||_F); exact powers of two from the exponent
// bits; square root, reciprocal square root and reciprocal, from the
// hardware's approximations and Newton steps: CUDA's IEEE division and
// square root call a slow-path subroutine that costs the kernel a stack
// frame (ptxas reported 4-16 bytes of spills with them).
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
  // For a, b normal and positive: the approximate hardware reciprocal
  // (square root) and one Newton step.
  static __device__ float rsqrt(float a) {
    const float y = rsqrtf(a);
    return y * (1.5f - 0.5f * a * y * y);
  }
  static __device__ float sqrt(float a) { return a * rsqrt(a); }
  static __device__ float div(float a, float b) {
    const float y = __fdividef(1.0f, b);
    return a * (y * (2.0f - b * y));
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
  // For b > 0 normal: b = s 2^k with s in [0.5, 1), a float seed of 1/s,
  // three Newton steps, exact rescaling.
  static __device__ double div(double a, double b) {
    const int k = exponent(b);
    const double s = b * pow2(-k);
    double y = static_cast<double>(__fdividef(1.0f, static_cast<float>(s)));
    for (int i = 0; i < 3; ++i) y = y * (2.0 - s * y);
    return a * (y * pow2(-k));
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

// The reduction of v over the CTA, the same value in every thread: warps by
// shuffles, then every thread combines the warp partials in warp order.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the last reduction's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) r = op(r, red[w]);
  return r;
}

// The shared memory of one CTA: [A: m * ld if resident][red: 32][c, s: m/2
// each][p, q: m/2 ints each].
template <typename T>
size_t smem_bytes(int d, bool resident) {
  const size_t m = d + (d & 1), ld = m + 1, half = m / 2;
  return (resident ? m * ld * sizeof(T) : 0) + (32 + 2 * half) * sizeof(T) + 2 * half * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    sym_eigvals_kernel(const T* __restrict__ in, T* __restrict__ out, T* __restrict__ work,
                       int32_t* __restrict__ sweeps_out, int d, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = d + (d & 1), ld = m + 1, half = m / 2;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* shared = reinterpret_cast<T*>(smem);
  T* A = resident ? shared : work + b * static_cast<int64_t>(m) * ld;
  T* red = resident ? shared + static_cast<size_t>(m) * ld : shared;
  T* cs = red + 32;
  T* sn = cs + half;
  int* P = reinterpret_cast<int*>(sn + half);
  int* Q = P + half;
  const T* a = in + b * static_cast<int64_t>(d) * d;

  // Load the lower triangle, mirrored; the padding row and column are 0.
  T amax = 0;
  int bad = 0;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - i * m;
    T v = 0;
    if (i < d && j < d) v = i >= j ? a[i * d + j] : a[j * d + i];
    bad |= !isfinite(v);
    amax = Max()(amax, my_fabs(v));
    A[i * ld + j] = v;
  }
  bad = __syncthreads_or(bad);
  if (bad) {
    for (int i = tid; i < d; i += nt) out[b * d + i] = static_cast<T>(CUDART_NAN_F);
    if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = 0;
    return;
  }
  amax = block_reduce(amax, red, Max());

  // Scale by 2^-e so that the largest entry is in [0.5, 1) (e clamped to
  // the normal range): exact.
  int e = amax > 0 ? Num<T>::exponent(amax) : 0;
  e = e < -Num<T>::kEmax ? -Num<T>::kEmax : (e > Num<T>::kEmax ? Num<T>::kEmax : e);
  const T down = Num<T>::pow2(-e), up = Num<T>::pow2(e);
  T norm2 = 0;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - i * m;
    const T v = A[i * ld + j] * down;
    A[i * ld + j] = v;
    norm2 += v * v;
  }
  norm2 = block_reduce(norm2, red, Sum());
  const T eps = Num<T>::eps();
  const T tol2 = eps * eps * norm2;

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    T off2 = 0;
    for (int idx = tid; idx < m * m; idx += nt) {
      const int i = idx / m, j = idx - i * m;
      if (i != j) off2 += A[i * ld + j] * A[i * ld + j];
    }
    off2 = block_reduce(off2, red, Sum());
    if (!(off2 > tol2)) break;
    for (int r = 0; r < m - 1; ++r) {
      // (1) The rotations of the round's pairs: positions k and m - 1 - k of
      // the tournament, index 0 fixed and the others shifted by r.
      for (int k = tid; k < half; k += nt) {
        int p = k == 0 ? 0 : (k - 1 + r) % (m - 1) + 1;
        int q = (m - 2 - k + r) % (m - 1) + 1;
        if (p > q) {
          const int t = p;
          p = q;
          q = t;
        }
        // tau = (a_qq - a_pp) / g with g = 2 a_pq, and t = sign(tau) /
        // (|tau| + sqrt(1 + tau^2)) = sign(tau) |g| / (|diff| + sqrt(diff^2 +
        // g^2)): one division, no overflow for entries of the scaled matrix.
        const T g = 2 * A[p * ld + q], diff = A[q * ld + q] - A[p * ld + p];
        T c = 1, s = 0;
        if (my_fabs(g) > Num<T>::tiny()) {
          T t = Num<T>::div(my_fabs(g), my_fabs(diff) + Num<T>::sqrt(diff * diff + g * g));
          if ((diff < 0 && g > 0) || (diff > 0 && g < 0)) t = -t;
          c = Num<T>::rsqrt(1 + t * t);
          s = t * c;
        }
        cs[k] = c;
        sn[k] = s;
        P[k] = p;
        Q[k] = q;
      }
      __syncthreads();
      // (2) Rows p and q of every pair: J^T A.
      for (int idx = tid; idx < half * m; idx += nt) {
        const int k = idx / m, j = idx - k * m;
        const int p = P[k], q = Q[k];
        const T c = cs[k], s = sn[k];
        const T apj = A[p * ld + j], aqj = A[q * ld + j];
        A[p * ld + j] = c * apj - s * aqj;
        A[q * ld + j] = s * apj + c * aqj;
      }
      __syncthreads();
      // (3) Columns p and q of every pair: (J^T A) J, a_pq = a_qp = 0.
      for (int idx = tid; idx < half * m; idx += nt) {
        const int k = idx / m, i = idx - k * m;
        const int p = P[k], q = Q[k];
        const T c = cs[k], s = sn[k];
        const T aip = A[i * ld + p], aiq = A[i * ld + q];
        A[i * ld + p] = i == q ? T(0) : c * aip - s * aiq;
        A[i * ld + q] = i == p ? T(0) : s * aip + c * aiq;
      }
      __syncthreads();
    }
  }

  // The diagonal, scaled back, ranked (ties by index) and written in order.
  for (int i = tid; i < d; i += nt) {
    const T v = A[i * ld + i];
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const T w = A[j * ld + j];
      rank += (w < v) || (w == v && j < i);
    }
    out[b * d + rank] = v * up;
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = sweep;
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
int entry(const void* a, void* w, void* work, void* sweeps, int64_t batch, int d, int resident,
          void* stream) {
  if (batch < 0 || batch > 0x7fffffff || d < 1 || (!resident && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T>(d, resident != 0);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = d + (d & 1);
  int threads = ((m / 2) * m + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  sym_eigvals_kernel<T><<<static_cast<unsigned>(batch), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(work),
      static_cast<int32_t*>(sweeps), d, resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes: tempest_sym_eigvals in float32,
// tempest_sym_eigvals_f64 in float64. a: (batch, d, d) contiguous, of which
// the lower triangle is read; w: (batch, d) out, ascending; work: (batch, m,
// m + 1) of the type with m = d rounded up to even, used when `resident` is
// 0 (else may be null); sweeps: (batch,) int32 out, the Jacobi sweeps each
// matrix took, or null. `resident` holds each matrix in shared memory (the
// wrapper's plan). Each launches on `stream` of the current device without
// synchronising and returns a cudaError_t.
extern "C" int tempest_sym_eigvals(const void* a, void* w, void* work, void* sweeps,
                                   int64_t batch, int d, int resident, void* stream) {
  return entry<float>(a, w, work, sweeps, batch, d, resident, stream);
}

extern "C" int tempest_sym_eigvals_f64(const void* a, void* w, void* work, void* sweeps,
                                       int64_t batch, int d, int resident, void* stream) {
  return entry<double>(a, w, work, sweeps, batch, d, resident, stream);
}
