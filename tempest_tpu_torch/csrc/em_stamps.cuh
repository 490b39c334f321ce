// clock64 stamps of the EM kernels' iterations, for the split of one EM
// iteration into its phases (scripts/em_designs.py, chip_smoke.py phase 4d).
//
// Thread 0 of the launch's first CTA adds the SM cycles since its last mark
// to the phase it names; at the loop's end it writes the sums and the
// iteration count to `stamp_out`; thread 0 of every CTA writes when its
// loop starts and ends on the global timer to `stamp_blocks` (the launch's
// waves and its slowest fit). The C entry `tempest_em_stamps` copies both
// to the host. Only a build with EM_STAMPS defined stamps; in any
// other the marks compile to nothing and the entry returns zeros.
//
// Phases: the GMM EM's 0 factorization, 1 E-step, 2 first sums, 3 first
// reduction, 4 scatter sums, 5 second reduction, 6 the rest; the Student-t
// EM's 0 factorization, 1 distances, 2 the stationarity terms of the bound
// test and the multisection, 3 their six reductions, 4 M-step sums, 5 M-step
// reduction, 6 the rest.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace em {

constexpr int kStampPhases = 7;
constexpr int kStampBlocks = 1024;  // CTAs whose start and end are kept

__device__ long long stamp_out[kStampPhases + 1];  // cycles by phase, then iterations
__device__ long long stamp_blocks[2 * kStampBlocks];  // each CTA's loop start and end (ns)

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#ifdef EM_STAMPS
struct Stamps {
  long long last, acc[kStampPhases];
  int iters;
  __device__ bool on() const { return threadIdx.x == 0 && blockIdx.x == 0; }
  __device__ void start() {
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) stamp_blocks[2 * blockIdx.x] = global_ns();
    if (!on()) return;
    for (int i = 0; i < kStampPhases; ++i) acc[i] = 0;
    iters = 0;
    last = clock64();
  }
  __device__ void mark(int phase) {
    if (!on()) return;
    const long long now = clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ void iteration() {
    if (on()) ++iters;
  }
  __device__ void finish() {
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
      stamp_blocks[2 * blockIdx.x + 1] = global_ns();
    }
    if (!on()) return;
    for (int i = 0; i < kStampPhases; ++i) stamp_out[i] = acc[i];
    stamp_out[kStampPhases] = iters;
  }
};
#else
struct Stamps {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void iteration() {}
  __device__ void finish() {}
};
#endif

}  // namespace em

// tempest_em_stamps: the last stamped launch's cycles by phase and its
// iterations, into out[0, kStampPhases + 1), then each of its first
// kStampBlocks CTAs' loop start and end on the global timer (ns), into
// out[kStampPhases + 1, kStampPhases + 1 + 2 kStampBlocks) (zeros without
// EM_STAMPS), and clears the latter for the next launch. Synchronises the
// current device.
extern "C" int tempest_em_stamps(int64_t* out) {
  static long long v[em::kStampPhases + 1 + 2 * em::kStampBlocks];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(v, em::stamp_out, (em::kStampPhases + 1) * sizeof(long long));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(v + em::kStampPhases + 1, em::stamp_blocks,
                               2 * em::kStampBlocks * sizeof(long long));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < em::kStampPhases + 1 + 2 * em::kStampBlocks; ++i) out[i] = v[i];
  static const long long zeros[2 * em::kStampBlocks] = {};
  return static_cast<int>(cudaMemcpyToSymbol(em::stamp_blocks, zeros, sizeof(zeros)));
}
