// flash_scan_blocked — the access-aware blocked ADT scan, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/flash_scan.py::flash_scan_blocked_pallas (body
// _flash_scan_blocked_kernel), with an optional leading query axis:
//     out[q, g, b] = Σ_m adt[q, m, blocks[q, g, m, b]]
// blocks (Q, G, M, B) int32 in [0, K); adt (Q, M, K) int32 or float32.
// The port's unfused beam step (ops.flash_scan_batch) feeds it the W
// expanded vertices' mirror rows transposed to (Q, W, M, R).
//
// What bounds it on the H100: bytes — M int32 codes read and one sum
// written per output; the table is read once per block.
//
// Design: one block per (query, group of code blocks). The block stages
// adt[q] in shared memory (above 48 KB through allow_smem's opt-in);
// thread (g, b) walks the M subspaces of column b,
// so for each m the threads of a warp read B consecutive int32 codes (one
// coalesced 128-byte line at B = 32) — the subspace-major layout of the
// paper's Figure 5 doing on the card what it does for SIMD registers.

#include "flash_common.cuh"

template <typename T>
__global__ void flash_scan_blocked_kernel(const int32_t* __restrict__ blocks,
                                          const T* __restrict__ adt,
                                          T* __restrict__ out, int G, int M,
                                          int B, int K, int g_per_block,
                                          int n_gblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  const int64_t q = blockIdx.x / n_gblk;
  const int g0 = (blockIdx.x % n_gblk) * g_per_block;
  repro_flash::stage_table(table, adt + q * (int64_t)M * K, M * K);
  const int slots = g_per_block * B;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int g = g0 + s / B;
    const int b = s % B;
    if (g >= G) continue;
    const int64_t blk = q * G + g;
    const int32_t* col = blocks + blk * (int64_t)M * B + b;
    T acc = T(0);
    for (int m = 0; m < M; ++m) acc += table[m * K + __ldg(col + (int64_t)m * B)];
    out[blk * B + b] = acc;
  }
}

template <typename T>
static int launch(const void* blocks, const void* adt, void* out, int Q, int G,
                  int M, int B, int K, cudaStream_t stream) {
  int g_per_block = 256 / B;
  if (g_per_block < 1) g_per_block = 1;
  if (g_per_block > G) g_per_block = G;
  const int n_gblk = (G + g_per_block - 1) / g_per_block;
  const int threads = repro_flash::threads_for(g_per_block * B);
  const size_t smem = (size_t)M * K * sizeof(T);
  const int err = repro_flash::allow_smem(flash_scan_blocked_kernel<T>, smem);
  if (err) return err;
  flash_scan_blocked_kernel<T><<<Q * n_gblk, threads, smem, stream>>>(
      static_cast<const int32_t*>(blocks), static_cast<const T*>(adt),
      static_cast<T*>(out), G, M, B, K, g_per_block, n_gblk);
  return (int)cudaGetLastError();
}

// C entry point (bound with ctypes). Returns cudaGetLastError() after launch.
extern "C" int repro_flash_scan_blocked(const void* blocks, const void* adt,
                                        void* out, int Q, int G, int M, int B,
                                        int K, int is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float>(blocks, adt, out, Q, G, M, B, K, s);
  return launch<int32_t>(blocks, adt, out, Q, G, M, B, K, s);
}
