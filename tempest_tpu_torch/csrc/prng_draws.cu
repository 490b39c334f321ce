// Counter-based draw kernels for Hopper (sm_90a): normals, raw bits, and all
// draws of one tpCN step in one launch.
//
// Replaces the Pallas hardware-PRNG kernels of tempest_tpu/ops/pallas_prng.py:
//   tempest_normal          <- `_normal_kernel` (:83; entry hw_normal)
//   tempest_bits            <- `_bits_kernel` (:108; entries hw_uniform, hw_gamma)
//   tempest_mutation_draws  <- `_mutation_draws_kernel` (:159; entry hw_mutation_draws)
// The TPU kernels seed the TPU's hardware generator. Hopper has none, so every
// word here comes from Philox4x32-10 (Random123), written out by hand with
// __umulhi. The plain PyTorch versions in tempest_tpu_torch/ops/philox.py
// compute the same function with the same counter layout, so kernel and plain
// version agree bit for bit on the words:
//   block i of sub-stream s of call `counter` encrypts (i, s, counter_lo, counter_hi)
//   under the key (k0, k1) and yields 4 words;
//   normals: block i -> elements 4i..4i+3, paired Box-Muller on words (0,1), (2,3);
//   bits: block i -> elements 4i..4i+3, the words themselves;
//   mutation draws: proposal normals as above on stream 0; walker n's
//   Marsaglia-Tsang round r on stream 1+r, words (u1, u2, u_accept), one
//   cos-only normal per round; its boost and Metropolis uniforms from words 0
//   and 1 of stream 7.
// A word maps to (0, 1] as pallas_prng.py:67-74 does: 2 - float(0x3F800000 | w >> 9).
//
// Numerics: precise logf, sqrtf, sincosf, cosf and powf, no --use_fast_math,
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
// touches device memory. Seed words and the call index are launch
// arguments, so no launch reads the device or syncs the host. Any size: no
// 128-lane alignment is needed.
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

struct Call {
  uint32_t k0, k1, ctr_lo, ctr_hi;
};

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
normal_kernel(float* __restrict__ out, int64_t total, Call call) {
  const int64_t n_blocks = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_blocks;
       i += stride) {
    normal_block(out, total, i, call);
  }
}

__global__ void __launch_bounds__(kThreads)
bits_kernel(uint32_t* __restrict__ out, int64_t total, Call call) {
  const int64_t n_blocks = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_blocks;
       i += stride) {
    const uint4 w = philox(static_cast<uint32_t>(i), kStreamBits, call);
    const int64_t base = 4 * i;
    if (base + 4 <= total) {
      reinterpret_cast<uint4*>(out)[i] = w;
    } else {
      const uint32_t v[4] = {w.x, w.y, w.z, w.w};
      for (int j = 0; base + j < total; ++j) out[base + j] = v[j];
    }
  }
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
                      int64_t n_walkers, int walker_ctas, Call call) {
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
  const bool boost = a < 1.0f;
  const float a_eff = boost ? a + 1.0f : a;
  const float d = a_eff - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  const uint4 w = philox(static_cast<uint32_t>(n), kStreamGammaRound0 + r, call);  // r = 6: stream 7
  bool ok = false;
  float proposal = 0.0f;
  if (r < kMtRounds) {
    const float zn = sqrtf(-2.0f * logf(unit_open_closed(w.x))) *
                     cosf(kTwoPi * unit_open_closed(w.y));
    const float one_cz = 1.0f + c * zn;
    const float v = one_cz * one_cz * one_cz;
    ok = (v > 0.0f) && (logf(unit_open_closed(w.z)) <
                        0.5f * zn * zn + d - d * v + d * logf(fmaxf(v, 1e-30f)));
    proposal = d * v;
  }
  const unsigned votes = (__ballot_sync(active, ok) >> first_lane) & ((1u << kMtRounds) - 1u);
  const int winner = votes ? __ffs(static_cast<int>(votes)) - 1 : 0;  // the first accepted round
  const float won = __shfl_sync(active, proposal, first_lane + winner);
  if (r == kMtRounds) {
    const float res = votes ? won : d;
    const float scale = powf(unit_open_closed(w.x), 1.0f / fmaxf(a, 1e-12f));
    g[n] = res * (boost ? scale : 1.0f);
    u_acc[n] = unit_open_closed(w.y);
  }
}

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

inline Call make_call(uint32_t k0, uint32_t k1, uint64_t counter) {
  return Call{k0, k1, static_cast<uint32_t>(counter), static_cast<uint32_t>(counter >> 32)};
}

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream` without
// synchronising and returns cudaGetLastError(). The wrapper checks that
// the block index of the last element fits 32 bits.

// out: (total,) float32 standard normals.
extern "C" int tempest_normal(void* out, int64_t total, uint32_t k0, uint32_t k1,
                              uint64_t counter, void* stream) {
  normal_kernel<<<grid_for((total + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), total, make_call(k0, k1, counter));
  return static_cast<int>(cudaGetLastError());
}

// out: (total,) 32-bit words (int32 bit patterns on the PyTorch side).
extern "C" int tempest_bits(void* out, int64_t total, uint32_t k0, uint32_t k1, uint64_t counter,
                            void* stream) {
  bits_kernel<<<grid_for((total + 3) / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), total, make_call(k0, k1, counter));
  return static_cast<int>(cudaGetLastError());
}

// alpha: (n_walkers,) float32 gamma shapes in; out: (n_z + 2 n_walkers,)
// float32, 16-byte aligned: z, the proposal normals, then g, the gamma
// draws, then u_acc, the uniforms in (0, 1].
extern "C" int tempest_mutation_draws(const void* alpha, void* out, int64_t n_z,
                                      int64_t n_walkers, uint32_t k0, uint32_t k1,
                                      uint64_t counter, void* stream) {
  const int64_t walker_ctas = (kLanesPerWalker * n_walkers + kThreads - 1) / kThreads;
  const int64_t normal_ctas = ((n_z + 3) / 4 + kThreads - 1) / kThreads;
  if (walker_ctas + normal_ctas > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  float* z = static_cast<float*>(out);
  mutation_draws_kernel<<<static_cast<int>(walker_ctas + normal_ctas), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), z, z + n_z, z + n_z + n_walkers, n_z, n_walkers,
      static_cast<int>(walker_ctas), make_call(k0, k1, counter));
  return static_cast<int>(cudaGetLastError());
}
