// flash_round — the bulk refinement-round scan, written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_round.py::flash_round_pallas
// (body _flash_round_kernel):
//     out[b, c] = Σ_m adts[b, m, codes[b, c, m]]
// codes (B, C, M) int32 in [0, K); adts (B, M, K) int32 levels or float32.
//
// What bounds it on the H100: bytes. Each output reads M int32 codes
// (64 B at M = 16) and writes 4 B; the row's table (1 KiB) is read once
// per C outputs. One bulk pass at n = 1M, C = 128, M = 16 moves about
// 8.2 GB of gathered codes, so device-memory bandwidth is the roof; the
// M lookups per output hit shared memory.
//
// Design: one block per row b. The block stages adts[b] in shared memory
// (up to 227 KB: a table above 48 KB takes the opt-in of allow_smem),
// then its threads stride over the C candidates; each thread loads its
// candidate's M codes with 16-byte vector loads (when M % 4 == 0 and the
// pointer is aligned), does M shared-memory lookups and writes one sum.
// The TPU kernel's one-hot compare-select over K has no use here: a
// shared-memory lookup is one instruction.

#include "flash_common.cuh"

template <typename T, bool VEC4>
__global__ void flash_round_kernel(const int32_t* __restrict__ codes,
                                   const T* __restrict__ adts,
                                   T* __restrict__ out, int C, int M, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  const int64_t b = blockIdx.x;
  repro_flash::stage_table(table, adts + b * (int64_t)M * K, M * K);
  const int32_t* row = codes + b * (int64_t)C * M;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    out[b * C + c] = repro_flash::row_sum<T, VEC4>(table, row + (int64_t)c * M, M, K);
}

template <typename T>
static int launch(const void* codes, const void* adts, void* out, int B, int C,
                  int M, int K, int vec4, cudaStream_t stream) {
  const int threads = repro_flash::threads_for(C);
  const size_t smem = (size_t)M * K * sizeof(T);
  const int32_t* c = static_cast<const int32_t*>(codes);
  const T* a = static_cast<const T*>(adts);
  T* o = static_cast<T*>(out);
  auto kernel = vec4 ? flash_round_kernel<T, true> : flash_round_kernel<T, false>;
  const int err = repro_flash::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<B, threads, smem, stream>>>(c, a, o, C, M, K);
  return (int)cudaGetLastError();
}

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int repro_flash_round(const void* codes, const void* adts, void* out,
                                 int B, int C, int M, int K, int is_float,
                                 int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float>(codes, adts, out, B, C, M, K, vec4, s);
  return launch<int32_t>(codes, adts, out, B, C, M, K, vec4, s);
}
