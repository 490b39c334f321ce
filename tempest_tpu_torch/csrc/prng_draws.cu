// Counter-based draw kernels for Hopper (sm_90a): normals, raw bits, gamma
// draws, and all draws of one tpCN step in one launch.
//
// Replaces the Pallas hardware-PRNG kernels of tempest_tpu/ops/pallas_prng.py:
//   tempest_normal          <- `_normal_kernel` (:83; entry hw_normal)
//   tempest_bits            <- `_bits_kernel` (:108; entry hw_uniform), and
//   tempest_uniform            the same kernel with hw_uniform's map to (0, 1]
//   tempest_gamma           <- `hw_gamma` (:275), which composes 6 `_normal_kernel`
//                              and 7 `_bits_kernel` calls with elementwise XLA ops
//   tempest_mutation_draws  <- `_mutation_draws_kernel` (:159; entry hw_mutation_draws)
// and their float64 entries, tempest_normal_f64, tempest_uniform_f64,
// tempest_gamma_f64 and tempest_mutation_draws_f64, which replace XLA's
// threefry draws in double (JAX sends every dtype but float32 to threefry,
// pallas_prng.py:46-48; the float64 section at the end of this file).
// The TPU kernels seed the TPU's hardware generator. Hopper has none, so every
// word here comes from Philox4x32-10 (Random123), written out by hand with
// __umulhi. The plain PyTorch versions in tempest_tpu_torch/ops/philox.py
// compute the same function with the same counter layout, so kernel and plain
// version agree bit for bit on the words:
//   block i of sub-stream s of call `counter` encrypts (i, s, counter_lo, counter_hi)
//   under the key (k0, k1) and yields 4 words;
//   normals: block i -> elements 4i..4i+3, paired Box-Muller on words (0,1), (2,3);
//   bits: block i -> elements 4i..4i+3, the words themselves;
//   gamma draws (calls counter .. counter + 12, as philox.gamma): walker
//   4i + j's round r takes normal j of block i of call counter + 2r and
//   word j of block i of call counter + 2r + 1, its boost word j of block i
//   of call counter + 12, all on stream 0;
//   mutation draws: proposal normals as above on stream 0; walker n's
//   Marsaglia-Tsang round r on stream 1+r, words (u1, u2, u_accept), one
//   cos-only normal per round; its boost and Metropolis uniforms from words 0
//   and 1 of stream 7.
// A word maps to (0, 1] as pallas_prng.py:67-74 does: 2 - float(0x3F800000 | w >> 9).
//
// Numerics: precise logf, sqrtf, sincosf, cosf and powf (log, sqrt, sincos,
// cos and pow in double for the float64 entries), no --use_fast_math,
// and the source is built with -fmad=false, so no product is contracted into
// an FMA that PyTorch's separate elementwise kernels would round twice; the
// plain version on the card then reproduces the kernel's values, except where
// a math function's last bit differs.
//
// What bounds them: the output bytes and the instructions, about equally. A
// normal costs one Philox block per 4 outputs (10 rounds of two 32x32
// products), one log, one sqrt and one sincos per 2 outputs; at 4 bytes per
// output the card writes 3.35 TB/s, i.e. ~0.84 G normals per ms, and issues
// the instructions for about as many (chip_smoke.py counts both; the bits
// kernel, without the float32 functions, is bound by its bytes). So the
// normal and bits kernels do no more than they must: a grid-stride loop in
// which every thread encrypts one counter, computes four outputs in
// registers and writes them as one 16-byte store; nothing but the outputs
// touches device memory. The key and the call index are launch arguments
// (the public functions), or two device words that every thread reads
// (`state`: the call counter of a draws object's MCMC steps, advanced on
// the stream, which a CUDA graph replays); no launch syncs the host. Any size: no 128-lane
// alignment is needed.
//
// The mutation-draws kernel, at the sizes its route takes (R N d <= 2^19,
// N <= 6,553 at R = 8, d = 10), is far below those bounds and far below the
// card: it is bound by the launch and by its longest thread. A walker's
// work is seven Philox blocks and six Marsaglia-Tsang rounds (three logs, a
// sqrt, a cos each) and a pow. The first design ran them in series on
// thread n of the first N threads, beside that thread's normals: at N =
// 1,024 the whole tail sat on 4 of 80 CTAs and set the launch's length
// (4.2 us on the H100 against a 1.0 us launch floor). Now walker work has
// CTAs of its own, 8 lanes a walker (N = 1,024: 32 CTAs beside 80 of
// normals), and the rounds run side by side, one per lane, so the longest
// thread does one Philox block and one round. Every round uses the same
// words and float32 operations in the same order as before, so the kernel
// still equals philox.mutation_draws. The wrapper hands one buffer for z,
// g and u, so a call allocates once.
//
// The gamma kernel replaces 13 launches and about 60 elementwise PyTorch
// kernels, each of which wrote its (N,) intermediate to device memory, by
// one launch that reads alpha and writes g (8 bytes a walker) and keeps
// every normal, uniform and test in registers. At B's N = 2^17 the bytes
// take 0.0003 ms and the instructions of the rounds these draws need (1.004
// rounds a walker at alpha = 7.5) 0.0005 ms of the whole card, against a
// launch floor of 0.0010 ms. What bounds it is, at once, how many warps hide
// each thread's chain of dependent instructions (ten Philox rounds of 32x32
// products, then a log, a sqrt and a sincos, then two logs a test) and how
// many instructions a walker costs. PR 7's layout (0), one thread a Philox
// block of four walkers running both blocks of a round, two Box-Muller
// pairs and four tests in series, put 8 warps on an SM that holds 64. PR 7
// also timed eight lanes a block running all six rounds (0.0093 ms at
// 2^17) and a walker a thread encrypting each block four times over
// (0.0047 ms). The layout kept here spreads a block's work over two lanes
// and encrypts no block twice: in round r lane h of block i's pair
// encrypts call counter + 2r + h (h = 0 the normals, 1 the uniforms), and
// one exchange of two words gives each lane the normal pair and the
// uniforms of its two walkers. It issues about (0)'s instructions a walker
// over twice its warps, and gives (0)'s values bit for bit. Four lanes a
// block, a walker a lane (lane j encrypting call counter + 4p + j, two
// rounds a pass), hid the latency better, but each lane ran its pair's
// log, sqrt and sincos, about 1.6x (0)'s instructions, and it lost to (0)
// at 2^18 in a trial whose kernel was not kept. Device time a launch at
// alpha = 7.5 on an NVIDIA H100 80GB HBM3 at 700 W, in turns with (0)
// (chip_smoke.py --kernels-only, this package and the parent's by
// --package-root): 2^17 0.0031 / 0.0031 ms against (0)'s 0.0040 / 0.0040;
// 2^18 0.0047 / 0.0042 against 0.0048 / 0.0049; torch._standard_gamma
// 0.0034 and 0.0050-0.0052.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Random123 philox.h
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;  // pallas_prng.py:42
constexpr int kMtRounds = 6;                  // pallas_prng.py:43
constexpr uint32_t kStreamNormal = 0, kStreamBits = 0;
constexpr uint32_t kStreamGammaRound0 = 1;  // rounds on 1..6, boost/accept on 7
constexpr int kLanesPerWalker = 8;          // 6 rounds, boost/accept, one idle
constexpr unsigned kFullMask = 0xffffffffu;
// hw_gamma: rounds r on calls counter + 2r (normals) and counter + 2r + 1
// (uniforms), the boost on counter + 12; philox.GAMMA_CALLS in all.
constexpr uint32_t kGammaBoostCall = 2 * kMtRounds;

struct Call {
  uint32_t k0, k1, ctr_lo, ctr_hi;
};

// What a launch is told about its call: the key words and the call index
// from the host, or, where `state` is set, from two 64-bit device words:
// state[0] + counter is the call index and state[1] the key (k0 | k1 << 32).
struct CallArgs {
  uint32_t k0, k1;
  uint64_t counter;
  const uint64_t* state;
};

__device__ __forceinline__ Call resolve(const CallArgs& a) {
  uint64_t c = a.counter;
  uint32_t k0 = a.k0, k1 = a.k1;
  if (a.state != nullptr) {
    c += a.state[0];
    const uint64_t k = a.state[1];
    k0 = static_cast<uint32_t>(k);
    k1 = static_cast<uint32_t>(k >> 32);
  }
  return Call{k0, k1, static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32)};
}

__device__ __forceinline__ uint4 philox(uint32_t index, uint32_t stream, const Call& call) {
  uint32_t c0 = index, c1 = stream, c2 = call.ctr_lo, c3 = call.ctr_hi;
  uint32_t k0 = call.k0, k1 = call.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The call `k` indices after `call` (the wrapper checks that counter + 12
// fits 64 bits).
__device__ __forceinline__ Call call_plus(const Call& call, uint32_t k) {
  const uint64_t c = ((static_cast<uint64_t>(call.ctr_hi) << 32) | call.ctr_lo) + k;
  return Call{call.k0, call.k1, static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32)};
}

__device__ __forceinline__ float unit_open_closed(uint32_t w) {
  return 2.0f - __uint_as_float(0x3F800000u | (w >> 9));
}

__device__ __forceinline__ float2 box_muller(uint32_t wa, uint32_t wb) {
  const float r = sqrtf(-2.0f * logf(unit_open_closed(wa)));
  float s, c;
  sincosf(kTwoPi * unit_open_closed(wb), &s, &c);
  return make_float2(r * c, r * s);
}

// Normals 4i..4i+3 into out[0, total).
__device__ __forceinline__ void normal_block(float* __restrict__ out, int64_t total, int64_t i,
                                             const Call& call) {
  const uint4 w = philox(static_cast<uint32_t>(i), kStreamNormal, call);
  const float2 a = box_muller(w.x, w.y);
  const float2 b = box_muller(w.z, w.w);
  const int64_t base = 4 * i;
  if (base + 4 <= total) {
    reinterpret_cast<float4*>(out)[i] = make_float4(a.x, a.y, b.x, b.y);  // 16-byte aligned
  } else {
    const float v[4] = {a.x, a.y, b.x, b.y};
    for (int j = 0; base + j < total; ++j) out[base + j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
normal_kernel(float* __restrict__ out, int64_t total, CallArgs args) {
  const Call call = resolve(args);
  const int64_t n_blocks = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_blocks;
       i += stride) {
    normal_block(out, total, i, call);
  }
}

// Words 4i..4i+3 of stream 0, as raw bits (uint32 out) or mapped to (0, 1]
// (float out: the uniforms of `philox.uniform`, hw_uniform's mapping done in
// registers).
__device__ __forceinline__ uint4 as_out(uint4 w, uint32_t*) { return w; }
__device__ __forceinline__ float4 as_out(uint4 w, float*) {
  return make_float4(unit_open_closed(w.x), unit_open_closed(w.y), unit_open_closed(w.z),
                     unit_open_closed(w.w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bits_kernel(T* __restrict__ out, int64_t total, CallArgs args) {
  using Vec = decltype(as_out(uint4{}, out));
  const Call call = resolve(args);
  const int64_t n_blocks = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_blocks;
       i += stride) {
    const Vec w = as_out(philox(static_cast<uint32_t>(i), kStreamBits, call), out);
    const int64_t base = 4 * i;
    if (base + 4 <= total) {
      reinterpret_cast<Vec*>(out)[i] = w;  // 16-byte aligned
    } else {
      const T v[4] = {w.x, w.y, w.z, w.w};
      for (int j = 0; base + j < total; ++j) out[base + j] = v[j];
    }
  }
}

// Marsaglia-Tsang for gamma(alpha, 1), as philox.marsaglia_tsang: alpha < 1
// is boosted to alpha + 1, then d = a_eff - 1/3, c = 1 / sqrt(9 d).
struct MtShape {
  float d, c;
  bool boost;
};

__device__ __forceinline__ MtShape mt_shape(float a) {
  const bool boost = a < 1.0f;
  const float a_eff = boost ? a + 1.0f : a;
  const float d = a_eff - 1.0f / 3.0f;
  return MtShape{d, 1.0f / sqrtf(9.0f * d), boost};
}

// One round on normal z and uniform u: accepted or not, and the proposal d v.
__device__ __forceinline__ bool mt_accept(const MtShape& s, float z, float u, float& proposal) {
  const float one_cz = 1.0f + s.c * z;
  const float v = one_cz * one_cz * one_cz;
  proposal = s.d * v;
  return (v > 0.0f) && (logf(u) < 0.5f * z * z + s.d - s.d * v + s.d * logf(fmaxf(v, 1e-30f)));
}

// The boost factor of alpha < 1: gamma(alpha) = gamma(alpha + 1) U^(1 / alpha).
__device__ __forceinline__ float mt_boost(float a, uint32_t w) {
  return powf(unit_open_closed(w), 1.0f / fmaxf(a, 1e-12f));
}

// gamma(alpha, 1) by Marsaglia-Tsang, as pallas_prng.py:185-214: six rounds,
// the first accepted one wins, a draw no round accepts keeps d; alpha < 1 is
// boosted as gamma(alpha + 1) * U^(1/alpha).
//
// Grid: the first `walker_ctas` CTAs serve the walkers, eight lanes each
// (four walkers a warp); the other CTAs draw the proposal normals, one
// Philox block a thread. In walker n's group, lane r encrypts block n of
// stream 1 + r: lanes 0-5 run Marsaglia-Tsang round r, lane 6 (stream 7)
// the boost and acceptance uniforms, lane 7 is idle. A ballot over the
// group picks the first accepted round; lane 6 takes its value by a shuffle
// and writes g and u.
__global__ void __launch_bounds__(kThreads)
mutation_draws_kernel(const float* __restrict__ alpha, float* __restrict__ z,
                      float* __restrict__ g, float* __restrict__ u_acc, int64_t n_z,
                      int64_t n_walkers, int walker_ctas, CallArgs args) {
  const Call call = resolve(args);
  if (static_cast<int>(blockIdx.x) >= walker_ctas) {
    const int64_t i =
        static_cast<int64_t>(blockIdx.x - walker_ctas) * kThreads + threadIdx.x;
    if (i < (n_z + 3) / 4) normal_block(z, n_z, i, call);
    return;
  }
  const int64_t n = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanesPerWalker;
  // Groups are whole: 8 | 32, so a group's lanes are all active or all not.
  const unsigned active = __ballot_sync(kFullMask, n < n_walkers);
  if (n >= n_walkers) return;
  const int lane = threadIdx.x & 31;
  const int r = lane & (kLanesPerWalker - 1);  // round, or kMtRounds: boost/accept
  const int first_lane = lane - r;

  const float a = alpha[n];
  const MtShape s = mt_shape(a);
  const uint4 w = philox(static_cast<uint32_t>(n), kStreamGammaRound0 + r, call);  // r = 6: stream 7
  bool ok = false;
  float proposal = 0.0f;
  if (r < kMtRounds) {
    const float zn = sqrtf(-2.0f * logf(unit_open_closed(w.x))) *
                     cosf(kTwoPi * unit_open_closed(w.y));
    ok = mt_accept(s, zn, unit_open_closed(w.z), proposal);
  }
  const unsigned votes = (__ballot_sync(active, ok) >> first_lane) & ((1u << kMtRounds) - 1u);
  const int winner = votes ? __ffs(static_cast<int>(votes)) - 1 : 0;  // the first accepted round
  const float won = __shfl_sync(active, proposal, first_lane + winner);
  if (r == kMtRounds) {
    const float res = votes ? won : s.d;
    g[n] = res * (s.boost ? mt_boost(a, w.x) : 1.0f);
    u_acc[n] = unit_open_closed(w.y);
  }
}

// ---------------------------------------------------------------------------
// hw_gamma: gamma(alpha, 1) for n walkers in one launch.
// ---------------------------------------------------------------------------

// Two lanes a Philox block of four walkers, two walkers a lane: in round r
// lane h of block i's pair encrypts block i of call counter + 2r + h (h = 0
// the normals, h = 1 the uniforms), and one exchange of two words gives lane
// h the normal pair and the uniforms of walkers 4i + 2h and 4i + 2h + 1.
// Each lane stops its walkers at their first accepted round; the warp runs
// a further round while one of its 64 walkers is undecided. Lane 0 of a
// pair encrypts the boost block (call counter + 12) when a walker of the
// warp has alpha < 1.
__global__ void __launch_bounds__(kThreads)
gamma_kernel(const float* __restrict__ alpha, float* __restrict__ g, int64_t n, CallArgs args) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int h = threadIdx.x & 1;
  const int64_t w0 = 2 * t;  // walkers w0, w0 + 1 = 4i + 2h, 4i + 2h + 1
  const bool v0 = w0 < n, v1 = w0 + 1 < n;
  const float a0 = v0 ? alpha[w0] : 1.0f, a1 = v1 ? alpha[w0 + 1] : 1.0f;
  const Call call = resolve(args);
  const uint32_t i = static_cast<uint32_t>(t >> 1);
  const MtShape s0 = mt_shape(a0), s1 = mt_shape(a1);
  float r0 = s0.d, r1 = s1.d;
  bool o0 = v0, o1 = v1;
  for (int r = 0; r < kMtRounds; ++r) {
    if (!__any_sync(kFullMask, o0 || o1)) break;
    const uint4 w = philox(i, kStreamNormal, call_plus(call, 2 * r + h));
    // h = 0 (normals) receives uniforms x, y; h = 1 (uniforms) normals z, w.
    const uint32_t e0 = __shfl_xor_sync(kFullMask, h ? w.x : w.z, 1);
    const uint32_t e1 = __shfl_xor_sync(kFullMask, h ? w.y : w.w, 1);
    const float2 z = box_muller(h ? e0 : w.x, h ? e1 : w.y);
    const uint32_t ua = h ? w.z : e0, ub = h ? w.w : e1;
    float p0, p1;
    const bool k0 = mt_accept(s0, z.x, unit_open_closed(ua), p0);
    const bool k1 = mt_accept(s1, z.y, unit_open_closed(ub), p1);
    if (o0 && k0) {
      r0 = p0;
      o0 = false;
    }
    if (o1 && k1) {
      r1 = p1;
      o1 = false;
    }
  }
  const bool b0 = v0 && s0.boost, b1 = v1 && s1.boost;
  if (__any_sync(kFullMask, b0 || b1)) {
    uint4 wb = make_uint4(0, 0, 0, 0);
    if (h == 0) wb = philox(i, kStreamBits, call_plus(call, kGammaBoostCall));
    const uint32_t e0 = __shfl_xor_sync(kFullMask, wb.z, 1);
    const uint32_t e1 = __shfl_xor_sync(kFullMask, wb.w, 1);
    r0 = r0 * (b0 ? mt_boost(a0, h ? e0 : wb.x) : 1.0f);
    r1 = r1 * (b1 ? mt_boost(a1, h ? e1 : wb.y) : 1.0f);
  }
  if (v0 && v1) {
    reinterpret_cast<float2*>(g)[t] = make_float2(r0, r1);  // 8-byte aligned: g is 16
  } else if (v0) {
    g[w0] = r0;
  }
}


// ---------------------------------------------------------------------------
// Float64: the same draws in double (philox.py's float64 layout)
// ---------------------------------------------------------------------------
// A double takes a pair of words, (0, 1) or (2, 3) of a block: 53 bits,
// u = (k + 1) 2^-53 with k = ((w0 >> 5) << 26) | (w1 >> 6), exact, in
// (0, 1]. So a block gives two uniforms, or two normals by paired
// Box-Muller in double. The gamma draws take MT_ROUNDS_F64 = 16 rounds
// (JAX's float64 gamma has no round cap; a draw no round accepts has
// probability below 1.5e-21 at alpha >= 1, boosted below). These are the
// simple designs: one thread a block for the normals and uniforms (two
// 8-byte outputs, one 16-byte store), one thread a pair of walkers for the
// gamma kernel, running its rounds in series until both accept, and a warp
// a walker for the mutation draws, whose lanes 0-15 run the 16 rounds side
// by side and lane 16 draws the boost and Metropolis uniforms.

constexpr double kTwoPiD = 6.283185307179586;
constexpr double kTwoPowM53 = 1.0 / 9007199254740992.0;  // 2^-53
constexpr int kMtRoundsF64 = 16;                         // philox.MT_ROUNDS_F64
constexpr uint32_t kGammaBoostCallF64 = 2 * kMtRoundsF64;
constexpr uint32_t kStreamBoostAcceptF64 = 1 + 2 * kMtRoundsF64;  // rounds on 1..32
constexpr int kLanesPerWalkerF64 = 32;  // a warp: 16 rounds, boost/accept, 15 idle

__device__ __forceinline__ double unit53(uint32_t wa, uint32_t wb) {
  const uint64_t k = (static_cast<uint64_t>(wa >> 5) << 26) | (wb >> 6);
  return static_cast<double>(k + 1) * kTwoPowM53;
}

__device__ __forceinline__ double2 box_muller_f64(double ua, double ub) {
  const double r = sqrt(-2.0 * log(ua));
  double s, c;
  sincos(kTwoPiD * ub, &s, &c);
  return make_double2(r * c, r * s);
}

// Elements 2i, 2i + 1 of stream 0: normals (kNormal) or uniforms.
template <bool kNormal>
__device__ __forceinline__ void pair_f64(double* __restrict__ out, int64_t total,
                                         const CallArgs& args) {
  const Call call = resolve(args);
  const int64_t n_blocks = (total + 1) / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_blocks;
       i += stride) {
    const uint4 w = philox(static_cast<uint32_t>(i), kStreamNormal, call);  // == kStreamBits
    const double ua = unit53(w.x, w.y), ub = unit53(w.z, w.w);
    const double2 v = kNormal ? box_muller_f64(ua, ub) : make_double2(ua, ub);
    if (2 * i + 2 <= total) {
      reinterpret_cast<double2*>(out)[i] = v;  // 16-byte aligned
    } else {
      out[2 * i] = v.x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
normal_f64_kernel(double* __restrict__ out, int64_t total, CallArgs args) {
  pair_f64<true>(out, total, args);
}

__global__ void __launch_bounds__(kThreads)
uniform_f64_kernel(double* __restrict__ out, int64_t total, CallArgs args) {
  pair_f64<false>(out, total, args);
}

struct MtShapeF64 {
  double d, c;
  bool boost;
};

__device__ __forceinline__ MtShapeF64 mt_shape_f64(double a) {
  const bool boost = a < 1.0;
  const double a_eff = boost ? a + 1.0 : a;
  const double d = a_eff - 1.0 / 3.0;
  return MtShapeF64{d, 1.0 / sqrt(9.0 * d), boost};
}

__device__ __forceinline__ bool mt_accept_f64(const MtShapeF64& s, double z, double u,
                                              double& proposal) {
  const double one_cz = 1.0 + s.c * z;
  const double v = one_cz * one_cz * one_cz;
  proposal = s.d * v;
  return (v > 0.0) && (log(u) < 0.5 * z * z + s.d - s.d * v + s.d * log(fmax(v, 1e-300)));
}

__device__ __forceinline__ double mt_boost_f64(double a, double u) {
  return pow(u, 1.0 / fmax(a, 1e-12));
}

// hw_gamma in double: thread i draws walkers 2i and 2i + 1 from block i of
// calls counter + 2r (normals) and counter + 2r + 1 (uniforms), round r
// while one of the two is undecided, and the boost from block i of call
// counter + 32 where one has alpha < 1.
__global__ void __launch_bounds__(kThreads)
gamma_f64_kernel(const double* __restrict__ alpha, double* __restrict__ g, int64_t n,
                 CallArgs args) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t w0 = 2 * i;
  if (w0 >= n) return;
  const bool v1 = w0 + 1 < n;
  const double a0 = alpha[w0], a1 = v1 ? alpha[w0 + 1] : 1.0;
  const Call call = resolve(args);
  const uint32_t block = static_cast<uint32_t>(i);
  const MtShapeF64 s0 = mt_shape_f64(a0), s1 = mt_shape_f64(a1);
  double r0 = s0.d, r1 = s1.d;
  bool o0 = true, o1 = v1;
  for (int r = 0; r < kMtRoundsF64 && (o0 || o1); ++r) {
    const uint4 wz = philox(block, kStreamNormal, call_plus(call, 2 * r));
    const uint4 wu = philox(block, kStreamBits, call_plus(call, 2 * r + 1));
    const double2 z = box_muller_f64(unit53(wz.x, wz.y), unit53(wz.z, wz.w));
    double p0, p1;
    const bool k0 = mt_accept_f64(s0, z.x, unit53(wu.x, wu.y), p0);
    const bool k1 = mt_accept_f64(s1, z.y, unit53(wu.z, wu.w), p1);
    if (o0 && k0) {
      r0 = p0;
      o0 = false;
    }
    if (o1 && k1) {
      r1 = p1;
      o1 = false;
    }
  }
  const bool b1 = v1 && s1.boost;
  if (s0.boost || b1) {
    const uint4 wb = philox(block, kStreamBits, call_plus(call, kGammaBoostCallF64));
    if (s0.boost) r0 = r0 * mt_boost_f64(a0, unit53(wb.x, wb.y));
    if (b1) r1 = r1 * mt_boost_f64(a1, unit53(wb.z, wb.w));
  }
  if (v1) {
    reinterpret_cast<double2*>(g)[i] = make_double2(r0, r1);  // 16-byte aligned
  } else {
    g[w0] = r0;
  }
}

// All draws of a float64 tpCN step. The first `walker_ctas` CTAs serve the
// walkers, a warp each: lane r < 16 runs round r on streams 1 + 2r (its
// cos-only normal) and 2 + 2r (its acceptance uniform), lane 16 encrypts
// stream 33 (the boost and Metropolis uniforms); a ballot picks the first
// accepted round and lane 16 writes g and u. The other CTAs draw the
// proposal normals, one Philox block (two normals) a thread.
__global__ void __launch_bounds__(kThreads)
mutation_draws_f64_kernel(const double* __restrict__ alpha, double* __restrict__ z,
                          double* __restrict__ g, double* __restrict__ u_acc, int64_t n_z,
                          int64_t n_walkers, int walker_ctas, CallArgs args) {
  const Call call = resolve(args);
  if (static_cast<int>(blockIdx.x) >= walker_ctas) {
    const int64_t i =
        static_cast<int64_t>(blockIdx.x - walker_ctas) * kThreads + threadIdx.x;
    if (i < (n_z + 1) / 2) {
      const uint4 w = philox(static_cast<uint32_t>(i), kStreamNormal, call);
      const double2 v = box_muller_f64(unit53(w.x, w.y), unit53(w.z, w.w));
      if (2 * i + 2 <= n_z) {
        reinterpret_cast<double2*>(z)[i] = v;  // 16-byte aligned
      } else {
        z[2 * i] = v.x;
      }
    }
    return;
  }
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanesPerWalkerF64;
  if (n >= n_walkers) return;  // the whole warp: one walker a warp
  const int r = threadIdx.x & 31;
  const uint32_t walker = static_cast<uint32_t>(n);
  const double a = alpha[n];
  const MtShapeF64 s = mt_shape_f64(a);
  bool ok = false;
  double proposal = 0.0;
  uint4 wb = make_uint4(0, 0, 0, 0);
  if (r < kMtRoundsF64) {
    const uint4 wn = philox(walker, kStreamGammaRound0 + 2 * r, call);
    const uint4 wa = philox(walker, kStreamGammaRound0 + 2 * r + 1, call);
    const double zn = sqrt(-2.0 * log(unit53(wn.x, wn.y))) * cos(kTwoPiD * unit53(wn.z, wn.w));
    ok = mt_accept_f64(s, zn, unit53(wa.x, wa.y), proposal);
  } else if (r == kMtRoundsF64) {
    wb = philox(walker, kStreamBoostAcceptF64, call);
  }
  const unsigned votes = __ballot_sync(kFullMask, ok) & ((1u << kMtRoundsF64) - 1u);
  const int winner = votes ? __ffs(static_cast<int>(votes)) - 1 : 0;  // the first accepted round
  const double won = __shfl_sync(kFullMask, proposal, winner);
  if (r == kMtRoundsF64) {
    const double res = votes ? won : s.d;
    g[n] = res * (s.boost ? mt_boost_f64(a, unit53(wb.x, wb.y)) : 1.0);
    u_acc[n] = unit53(wb.z, wb.w);
  }
}

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

// Launches on `device`, switching to it and back if the calling thread's
// current device is another.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int current = device;
    cudaGetDevice(&current);
    if (current != device) {
      previous_ = current;
      cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }

 private:
  int previous_ = -1;
};

CallArgs make_args(uint32_t k0, uint32_t k1, uint64_t counter, const void* state) {
  return CallArgs{k0, k1, counter, static_cast<const uint64_t*>(state)};
}

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream` of CUDA
// device `device` without synchronising and returns cudaGetLastError().
// The wrapper checks that the block index of the last element fits 32
// bits. `state`: null, and the call index is `counter` and the key (k0,
// k1); or two 64-bit words in device memory, and the call index is
// state[0] + counter and the key state[1] = k0 | k1 << 32, read by the
// kernel (a draws object's call counter, which a CUDA graph replays).

// out: (total,) float32 standard normals.
extern "C" int tempest_normal(void* out, int64_t total, uint32_t k0, uint32_t k1,
                              uint64_t counter, const void* state, int device, void* stream) {
  DeviceGuard guard(device);
  normal_kernel<<<grid_for((total + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), total, make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// out: (total,) 32-bit words (int32 bit patterns on the PyTorch side).
extern "C" int tempest_bits(void* out, int64_t total, uint32_t k0, uint32_t k1, uint64_t counter,
                            int device, void* stream) {
  DeviceGuard guard(device);
  bits_kernel<<<grid_for((total + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), total, make_args(k0, k1, counter, nullptr));
  return static_cast<int>(cudaGetLastError());
}

// out: (total,) float32 uniforms in (0, 1], the bits kernel's words mapped
// in registers (hw_uniform in one launch; the MCMC step's acceptance
// uniforms, `draws.Draws` on its keyed route).
extern "C" int tempest_uniform(void* out, int64_t total, uint32_t k0, uint32_t k1,
                               uint64_t counter, const void* state, int device, void* stream) {
  DeviceGuard guard(device);
  bits_kernel<<<grid_for((total + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), total, make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// alpha: (n,) float32 gamma shapes in, contiguous; out: (n,) float32, 16-byte
// aligned, the gamma(alpha, 1) draws of calls counter .. counter + 12.
extern "C" int tempest_gamma(const void* alpha, void* out, int64_t n, uint32_t k0, uint32_t k1,
                             uint64_t counter, const void* state, int device, void* stream) {
  const int64_t ctas = ((n + 1) / 2 + kThreads - 1) / kThreads;  // a thread per 2 walkers
  if (ctas > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  gamma_kernel<<<static_cast<int>(ctas > 0 ? ctas : 1), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(alpha),
                                                      static_cast<float*>(out), n,
                                                      make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// alpha: (n_walkers,) float32 gamma shapes in; out: (n_z + 2 n_walkers,)
// float32, 16-byte aligned: z, the proposal normals, then g, the gamma
// draws, then u_acc, the uniforms in (0, 1].
extern "C" int tempest_mutation_draws(const void* alpha, void* out, int64_t n_z,
                                      int64_t n_walkers, uint32_t k0, uint32_t k1,
                                      uint64_t counter, const void* state, int device,
                                      void* stream) {
  const int64_t walker_ctas = (kLanesPerWalker * n_walkers + kThreads - 1) / kThreads;
  const int64_t normal_ctas = ((n_z + 3) / 4 + kThreads - 1) / kThreads;
  if (walker_ctas + normal_ctas > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  float* z = static_cast<float*>(out);
  mutation_draws_kernel<<<static_cast<int>(walker_ctas + normal_ctas), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), z, z + n_z, z + n_z + n_walkers, n_z, n_walkers,
      static_cast<int>(walker_ctas), make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}


// The float64 entries: the same arguments, double in and out. A block of
// the normal and uniform kernels gives two elements, so `total` may reach
// 2^33 (the wrapper checks it).

// out: (total,) float64 standard normals.
extern "C" int tempest_normal_f64(void* out, int64_t total, uint32_t k0, uint32_t k1,
                                  uint64_t counter, const void* state, int device,
                                  void* stream) {
  DeviceGuard guard(device);
  normal_f64_kernel<<<grid_for((total + 1) / 2), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), total, make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// out: (total,) float64 uniforms in (0, 1], 53 bits each.
extern "C" int tempest_uniform_f64(void* out, int64_t total, uint32_t k0, uint32_t k1,
                                   uint64_t counter, const void* state, int device,
                                   void* stream) {
  DeviceGuard guard(device);
  uniform_f64_kernel<<<grid_for((total + 1) / 2), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), total, make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// alpha: (n,) float64 gamma shapes in, contiguous; out: (n,) float64,
// 16-byte aligned, the gamma(alpha, 1) draws of calls counter .. counter + 32.
extern "C" int tempest_gamma_f64(const void* alpha, void* out, int64_t n, uint32_t k0,
                                 uint32_t k1, uint64_t counter, const void* state, int device,
                                 void* stream) {
  const int64_t ctas = ((n + 1) / 2 + kThreads - 1) / kThreads;  // a thread per 2 walkers
  if (ctas > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  gamma_f64_kernel<<<static_cast<int>(ctas > 0 ? ctas : 1), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const double*>(alpha),
                                                          static_cast<double*>(out), n,
                                                          make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}

// alpha: (n_walkers,) float64 gamma shapes in; out: (n_z + 2 n_walkers,)
// float64, 16-byte aligned: z, then g, then u_acc.
extern "C" int tempest_mutation_draws_f64(const void* alpha, void* out, int64_t n_z,
                                          int64_t n_walkers, uint32_t k0, uint32_t k1,
                                          uint64_t counter, const void* state, int device,
                                          void* stream) {
  const int64_t walker_ctas = (kLanesPerWalkerF64 * n_walkers + kThreads - 1) / kThreads;
  const int64_t normal_ctas = ((n_z + 1) / 2 + kThreads - 1) / kThreads;
  if (walker_ctas + normal_ctas > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  double* z = static_cast<double*>(out);
  mutation_draws_f64_kernel<<<static_cast<int>(walker_ctas + normal_ctas), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(alpha), z, z + n_z, z + n_z + n_walkers, n_z, n_walkers,
      static_cast<int>(walker_ctas), make_args(k0, k1, counter, state));
  return static_cast<int>(cudaGetLastError());
}
