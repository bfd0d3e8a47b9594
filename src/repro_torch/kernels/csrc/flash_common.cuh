// Shared pieces of the Flash lookup-accumulate kernels (flash_round,
// flash_expand, flash_scan_blocked, flash_scan).
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

// Σ_m table[m, row[m]] over one code row of M int32 codes, added in m order.
// VEC4 reads the row as 16-byte vector loads (M % 4 == 0 and a 16-byte
// aligned row); otherwise element by element.
template <typename T, bool VEC4>
__device__ __forceinline__ T row_sum(const T* table, const int32_t* __restrict__ row,
                                     int M, int K) {
  T acc = T(0);
  if (VEC4) {
    const int4* v = reinterpret_cast<const int4*>(row);
    for (int i = 0; i < M / 4; ++i) {
      const int4 w = __ldg(v + i);
      const int base = 4 * i * K;
      acc += table[base + w.x];
      acc += table[base + K + w.y];
      acc += table[base + 2 * K + w.z];
      acc += table[base + 3 * K + w.w];
    }
  } else {
    for (int m = 0; m < M; ++m) acc += table[m * K + __ldg(row + m)];
  }
  return acc;
}

// Threads per block for `slots` outputs: a whole number of warps, at most 256.
inline int threads_for(int slots) {
  if (slots >= 256) return 256;
  return ((slots + 31) / 32) * 32;
}

}  // namespace repro_flash
