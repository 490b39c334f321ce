// Clock64 marks of the weighted-median kernel (csrc/weighted_median.cu),
// compiled in only with -DMEDIAN_STAMPS (chip_smoke.py phase 4c builds such a
// copy beside the package's library). Each of the first kStampColumns
// columns records: its chain thread's start, first stage ready, cycles
// waiting for stages and adding them, end, stages and values added; then
// stage 0's gathering warp (lane 0): its entry, its order entries and its
// weights loaded, its arrival. tempest_median_stamps copies them out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kStampColumns = 1024;
constexpr int kStampFields = 11;
__device__ long long g_stamps[kStampColumns][kStampFields];

// clock64 once the registers given have been loaded.
__device__ __forceinline__ long long clock_after(int64_t a, int64_t b) {
  asm volatile("" ::"l"(a), "l"(b));
  return clock64();
}
__device__ __forceinline__ long long clock_after(float a, float b) {
  asm volatile("" ::"f"(a), "f"(b));
  return clock64();
}
__device__ __forceinline__ long long clock_after(double a, double b) {
  asm volatile("" ::"d"(a), "d"(b));
  return clock64();
}

// The stamps of the last launch's first kStampColumns columns, kStampFields
// int64 each, into `out` (synchronous).
extern "C" int tempest_median_stamps(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
