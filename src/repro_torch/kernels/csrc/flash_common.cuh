// Shared pieces of the Flash lookup-accumulate kernels (flash_round,
// flash_expand, flash_scan_blocked).
//
// All three score a code against a per-query (M, K) distance table:
// Σ_m table[m, code_m]. The table is 1 KiB at M = K = 16 with int32
// levels, so each block stages its table in shared memory once and every
// thread then does M shared-memory lookups per output.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_flash {

// Copy one (M, K) table (M·K entries) into shared memory; every thread of
// the block takes part, and the block waits until the copy is whole.
template <typename T>
__device__ __forceinline__ void stage_table(T* dst, const T* __restrict__ src,
                                            int mk) {
  for (int i = threadIdx.x; i < mk; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// Threads per block for `slots` outputs: a whole number of warps, at most 256.
inline int threads_for(int slots) {
  if (slots >= 256) return 256;
  return ((slots + 31) / 32) * 32;
}

}  // namespace repro_flash
