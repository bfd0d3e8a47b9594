// Shared pieces of the Flash lookup-accumulate kernels (flash_round,
// flash_expand, flash_beam, flash_scan_blocked, flash_scan).
//
// All of them score a code against a per-query (M, K) distance table:
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

// How a mirror slot's M codes are stored: (n, R, M) int32, or packed
// (n, R, ⌈M/2⌉) uint8 (low nibble = even subspace) read as 8-byte words
// (Mp % 8 == 0, an 8-byte aligned start) or, for any M, byte-wise.
enum MirrorLayout { kUnpacked = 0, kPackedWords = 1, kPackedBytes = 2 };

// Σ_m table[m, code_m] over the codes of one mirror slot (neighbor j of
// frontier vertex v is slot v·R + j), added in m order. kPackedWords reads
// a slot's Mp bytes as Mp / 8 8-byte loads and unpacks them in registers;
// kPackedBytes assumes no alignment: a slot is Mp bytes at slot·Mp, read as
// 4-byte words where Mp % 4 == 0 and the slot's start is 4-byte aligned,
// else byte by byte (when M is odd the last byte's high nibble is padding
// and is never added); an unpacked slot is M int32 loads. flash_expand and
// flash_beam both score their slots here, so the two cannot drift.
template <typename T, int LAYOUT>
__device__ __forceinline__ T score_slot(const T* table,
                                        const void* __restrict__ mirror,
                                        int64_t slot, int Mp, int M, int K) {
  T acc = T(0);
  if (LAYOUT == kPackedWords) {
    const uint2* p = reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(mirror) + slot * Mp);
    for (int wd = 0; wd < Mp / 8; ++wd) {
      const uint2 v = __ldg(p + wd);
      // bytes are little-endian: nibble t of a 32-bit word is subspace t
      for (int t = 0; t < 8; ++t) {
        const int m = 16 * wd + t;
        if (m < M) acc += table[m * K + ((v.x >> (4 * t)) & 0xF)];
      }
      for (int t = 0; t < 8; ++t) {
        const int m = 16 * wd + 8 + t;
        if (m < M) acc += table[m * K + ((v.y >> (4 * t)) & 0xF)];
      }
    }
  } else if (LAYOUT == kPackedBytes) {
    const uint8_t* p = static_cast<const uint8_t*>(mirror) + slot * Mp;
    if ((Mp & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
      for (int wd = 0; wd < Mp / 4; ++wd) {
        const uint32_t v = __ldg(pw + wd);
        for (int t = 0; t < 8; ++t) {
          const int m = 8 * wd + t;
          if (m < M) acc += table[m * K + ((v >> (4 * t)) & 0xF)];
        }
      }
    } else {
      for (int b = 0; b < Mp; ++b) {
        const uint32_t v = __ldg(p + b);
        acc += table[(2 * b) * K + (v & 0xF)];
        if (2 * b + 1 < M) acc += table[(2 * b + 1) * K + (v >> 4)];
      }
    }
  } else {
    const int32_t* p = static_cast<const int32_t*>(mirror) + slot * M;
    for (int m = 0; m < M; ++m) acc += table[m * K + __ldg(p + m)];
  }
  return acc;
}

// Threads per block for `slots` outputs: a whole number of warps, at most 256.
inline int threads_for(int slots) {
  if (slots >= 256) return 256;
  return ((slots + 31) / 32) * 32;
}

}  // namespace repro_flash
