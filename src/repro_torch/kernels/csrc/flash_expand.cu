// flash_expand — one fused beam-expansion step, written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_expand.py::flash_expand_pallas
// (body _flash_expand_kernel), batched over Q queries as the port's beam
// search runs it:
//     rows[q, w, j] = adjacency[max(nodes[q, w], 0), j]
//     sums[q, w, j] = Σ_m adt[q, m, code_m]
// with the codes of mirror[max(nodes[q, w], 0), j] — packed (n, R, ⌈M/2⌉)
// uint8 (low nibble = even subspace) or unpacked (n, R, M) int32 — and adt
// (Q, M, K) int32 levels or float32.
//
// What bounds it on the H100: bytes, and at search batch sizes latency.
// Per frontier vertex it reads one adjacency row (R·4 = 128 B) and one
// packed code row (R·⌈M/2⌉ = 256 B at R = 32, M = 16), rows that sit at
// random places in device memory; per query the 1 KiB table once.
//
// Design: one block per (query, group of frontier vertices). The block
// stages adt[q] in shared memory (above 48 KB through allow_smem's
// opt-in); thread j of a frontier vertex reads
// adjacency[node, j] and its code row — Mp = 8 bytes at M = 16, one 8-byte
// load — unpacks the nibbles in registers and sums M shared-memory
// lookups (repro_flash::score_slot, shared with flash_beam). The TPU
// kernel gathered through scalar-prefetched BlockSpecs and contracted a
// one-hot on the MXU; here each thread gathers its own row
// and a lookup is one shared-memory load. A packed mirror whose rows are
// whole 8-byte words (⌈M/2⌉ % 8 == 0) is read as such; any other M is read
// byte-wise (4-byte words where they align), the same sums in the same order.

#include "flash_common.cuh"

using repro_flash::kPackedBytes;
using repro_flash::kPackedWords;
using repro_flash::kUnpacked;

template <typename T, int LAYOUT>
__global__ void flash_expand_kernel(const int32_t* __restrict__ nodes,
                                    const int32_t* __restrict__ adj,
                                    const void* __restrict__ mirror,
                                    const T* __restrict__ adt,
                                    int32_t* __restrict__ rows_out,
                                    T* __restrict__ sums_out, int W, int R,
                                    int Mp, int M, int K, int w_per_block,
                                    int n_wblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  const int64_t q = blockIdx.x / n_wblk;
  const int w0 = (blockIdx.x % n_wblk) * w_per_block;
  repro_flash::stage_table(table, adt + q * (int64_t)M * K, M * K);
  const int slots = w_per_block * R;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int w = w0 + s / R;
    const int j = s % R;
    if (w >= W) continue;
    const int64_t out_i = (q * W + w) * (int64_t)R + j;
    const int node = nodes[q * W + w];
    const int64_t slot = (int64_t)(node > 0 ? node : 0) * R + j;
    rows_out[out_i] = adj[slot];
    sums_out[out_i] = repro_flash::score_slot<T, LAYOUT>(table, mirror, slot, Mp, M, K);
  }
}

template <typename T, int LAYOUT>
static int launch(const void* nodes, const void* adj, const void* mirror,
                  const void* adt, void* rows, void* sums, int Q, int W, int R,
                  int Mp, int M, int K, cudaStream_t stream) {
  int w_per_block = 256 / R;
  if (w_per_block < 1) w_per_block = 1;
  if (w_per_block > W) w_per_block = W;
  const int n_wblk = (W + w_per_block - 1) / w_per_block;
  const int threads = repro_flash::threads_for(w_per_block * R);
  const size_t smem = (size_t)M * K * sizeof(T);
  const int err = repro_flash::allow_smem(flash_expand_kernel<T, LAYOUT>, smem);
  if (err) return err;
  flash_expand_kernel<T, LAYOUT><<<Q * n_wblk, threads, smem, stream>>>(
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(adj),
      mirror, static_cast<const T*>(adt), static_cast<int32_t*>(rows),
      static_cast<T*>(sums), W, R, Mp, M, K, w_per_block, n_wblk);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int layout, const void* nodes, const void* adj,
                    const void* mirror, const void* adt, void* rows, void* sums,
                    int Q, int W, int R, int Mp, int M, int K,
                    cudaStream_t s) {
  if (layout == kPackedWords)
    return launch<T, kPackedWords>(nodes, adj, mirror, adt, rows, sums, Q, W,
                                   R, Mp, M, K, s);
  if (layout == kPackedBytes)
    return launch<T, kPackedBytes>(nodes, adj, mirror, adt, rows, sums, Q, W,
                                   R, Mp, M, K, s);
  return launch<T, kUnpacked>(nodes, adj, mirror, adt, rows, sums, Q, W, R, Mp,
                              M, K, s);
}

// C entry point (bound with ctypes). layout: 0 = (n, R, M) int32 mirror,
// 1 = packed uint8 read as 8-byte words (Mp % 8 == 0, 8-byte aligned),
// 2 = packed uint8 read byte-wise (any M, any alignment).
// Returns cudaGetLastError() after launch.
extern "C" int repro_flash_expand(const void* nodes, const void* adj,
                                  const void* mirror, const void* adt,
                                  void* rows, void* sums, int Q, int W, int R,
                                  int Mp, int M, int K, int layout,
                                  int is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return dispatch<float>(layout, nodes, adj, mirror, adt, rows, sums, Q, W,
                           R, Mp, M, K, s);
  return dispatch<int32_t>(layout, nodes, adj, mirror, adt, rows, sums, Q, W,
                           R, Mp, M, K, s);
}
