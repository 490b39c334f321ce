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
// kernel, without the float32 functions, is bound by its bytes). So each
// kernel does no more than it must: a grid-stride loop in
// which every thread encrypts one counter, computes four outputs in
// registers and writes them as one 16-byte store; nothing but the outputs
// touches device memory. The mutation-draws kernel adds per-walker work
// (seven Philox blocks, six rounds of Marsaglia-Tsang) on the same threads.
// Seed words and the call index are launch arguments, so no launch reads
// the device or syncs the host. Any size: no 128-lane alignment is needed.

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
constexpr uint32_t kStreamGammaRound0 = 1, kStreamBoostAccept = 1 + kMtRounds;

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
__global__ void __launch_bounds__(kThreads)
mutation_draws_kernel(const float* __restrict__ alpha, float* __restrict__ z,
                      float* __restrict__ g, float* __restrict__ u_acc, int64_t n_z,
                      int64_t n_walkers, Call call) {
  const int64_t n_blocks = (n_z + 3) / 4;
  const int64_t work = n_blocks > n_walkers ? n_blocks : n_walkers;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < work;
       i += stride) {
    if (i < n_blocks) normal_block(z, n_z, i, call);
    if (i < n_walkers) {
      const uint32_t n = static_cast<uint32_t>(i);
      const float a = alpha[i];
      const bool boost = a < 1.0f;
      const float a_eff = boost ? a + 1.0f : a;
      const float d = a_eff - 1.0f / 3.0f;
      const float c = 1.0f / sqrtf(9.0f * d);
      float res = d;
      bool accepted = false;
#pragma unroll
      for (int r = 0; r < kMtRounds; ++r) {
        const uint4 w = philox(n, kStreamGammaRound0 + r, call);
        const float zn = sqrtf(-2.0f * logf(unit_open_closed(w.x))) *
                         cosf(kTwoPi * unit_open_closed(w.y));
        const float one_cz = 1.0f + c * zn;
        const float v = one_cz * one_cz * one_cz;
        const bool ok = (v > 0.0f) && (logf(unit_open_closed(w.z)) <
                                       0.5f * zn * zn + d - d * v + d * logf(fmaxf(v, 1e-30f)));
        if (ok && !accepted) res = d * v;
        accepted = accepted || ok;
      }
      const uint4 w = philox(n, kStreamBoostAccept, call);
      const float scale = powf(unit_open_closed(w.x), 1.0f / fmaxf(a, 1e-12f));
      g[i] = res * (boost ? scale : 1.0f);
      u_acc[i] = unit_open_closed(w.y);
    }
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

// alpha: (n_walkers,) float32 gamma shapes in; z: (n_z,) proposal normals,
// g: (n_walkers,) gamma draws, u_acc: (n_walkers,) uniforms in (0, 1] out.
extern "C" int tempest_mutation_draws(const void* alpha, void* z, void* g, void* u_acc,
                                      int64_t n_z, int64_t n_walkers, uint32_t k0, uint32_t k1,
                                      uint64_t counter, void* stream) {
  const int64_t n_blocks = (n_z + 3) / 4;
  mutation_draws_kernel<<<grid_for(n_blocks > n_walkers ? n_blocks : n_walkers), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<float*>(z), static_cast<float*>(g),
      static_cast<float*>(u_acc), n_z, n_walkers, make_call(k0, k1, counter));
  return static_cast<int>(cudaGetLastError());
}
