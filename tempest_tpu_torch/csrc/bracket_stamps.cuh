// Clock64 marks of the ESS kernel's bracket mode (csrc/ess_bisect.cu),
// compiled in only with -DBRACKET_STAMPS (chip_smoke.py phase 3b builds such
// a copy beside the package's library). Thread 0 of each CTA of the cluster
// sums the cycles of each phase over the passes: the load, its pass, its
// warp's combine, the CTA's combine (warp 0 waits for every warp), the
// pushes, the wait for the cluster's partials, their combine and the
// decision; then the passes. tempest_bracket_stamps copies them out.

#pragma once

#include <cuda_runtime.h>

constexpr int kBracketStampCtas = 16;  // the cluster's CTAs
constexpr int kBracketStampFields = 8;
__device__ long long g_bracket_stamps[kBracketStampCtas][kBracketStampFields];

// The last bracket launch's stamps, kBracketStampCtas x kBracketStampFields
// int64 (cycles by phase, then the passes), into `out` (synchronous).
extern "C" int tempest_bracket_stamps(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_bracket_stamps, sizeof(g_bracket_stamps)));
}
