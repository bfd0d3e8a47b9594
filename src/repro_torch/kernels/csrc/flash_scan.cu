// flash_scan — the flat ADT scan over a whole code table, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_scan.py::flash_scan_pallas
// (body _flash_scan_kernel):
//     out[n] = Σ_m adt[m, codes[n, m]]
// codes (N, M) int32 in [0, K); adt (M, K) int32 levels or float32.
// Its one caller is the recsys candidate scorer (score_flash), which scans
// every candidate's codes once per query.
//
// What bounds it on the H100: bytes. At the BERT4Rec catalog (N = 1,048,575,
// M = 16) it reads 67.1 MB of codes and writes 4.2 MB of sums: about
// 0.0213 ms at 3.35 TB/s. Its 16.8M adds take well under 1 µs at 67 TOP/s.
// A 64-request batch launches it 64 times, about 1.36 ms of bytes; a form
// that reads the codes once for all Q tables ((Q, M, K) tables) is later
// work.
//
// Design: the (M, K) table (1 KiB at M = K = 16, at most 227 KB) is staged in
// shared memory once per block. Each thread scores one row per step of a
// grid-stride loop: it reads the row's M codes as 16-byte vector loads when
// M % 4 == 0 and the pointer is aligned (element by element otherwise), does
// M shared-memory lookups and writes one sum. Integer tables give exact
// int32 sums; float tables add in m order, as the plain version does. The
// TPU wrapper's zero-padding of N up to block_n is a TPU layout device: the
// loop bound masks the ragged end instead. Offsets are 64-bit (N·M is 16.8M
// at the full catalog, and more for larger ones).

#include "flash_common.cuh"

template <typename T, bool VEC4>
__global__ void flash_scan_kernel(const int32_t* __restrict__ codes,
                                  const T* __restrict__ adt,
                                  T* __restrict__ out, int64_t N, int M,
                                  int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  repro_flash::stage_table(table, adt, M * K);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride)
    out[n] = repro_flash::row_sum<T, VEC4>(table, codes + n * M, M, K);
}

// Blocks in flight: enough to fill 132 SMs many times over; beyond that the
// grid-stride loop reuses each block's staged table.
static const int64_t kMaxBlocks = 132 * 32;

template <typename T>
static int launch(const void* codes, const void* adt, void* out, int64_t N,
                  int M, int K, int vec4, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (N + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = (size_t)M * K * sizeof(T);
  const int32_t* c = static_cast<const int32_t*>(codes);
  const T* a = static_cast<const T*>(adt);
  T* o = static_cast<T*>(out);
  auto kernel = vec4 ? flash_scan_kernel<T, true> : flash_scan_kernel<T, false>;
  const int err = repro_flash::allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<(int)blocks, threads, smem, stream>>>(c, a, o, N, M, K);
  return (int)cudaGetLastError();
}

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int repro_flash_scan(const void* codes, const void* adt, void* out,
                                long long N, int M, int K, int is_float,
                                int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float>(codes, adt, out, N, M, K, vec4, s);
  return launch<int32_t>(codes, adt, out, N, M, K, vec4, s);
}
