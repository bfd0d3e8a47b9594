// sq_l2 — the quantized-domain scaled L2 of the HNSW-SQ distance, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sq_l2.py::sq_l2_pallas (body
// _sq_l2_kernel):
//     out[n] = Σ_d s2[d] · (db[n, d] − q[d])²
// q (D,) int32 codes, db (N, D) int32 codes, s2 (D,) float32 squared scales
// -> (N,) float32. No path of the system calls it yet (the SQ backend
// computes its distance outside the kernels).
//
// What bounds it on the H100: bytes. At N = 1,048,576, D = 128 it reads
// 537 MB of codes and writes 4.2 MB: about 0.161 ms at 3.35 TB/s; its
// 3·N·D integer and float operations take about 6 µs at 67 TOP/s.
//
// Design: q and s2 are staged in shared memory once per block (D ≤ 4,096:
// at most 32 KiB together). One warp scores one row per step of a
// grid-stride loop: its lanes read the row's codes as consecutive 16-byte
// vector loads when D % 4 == 0 and the pointer is aligned (one 512-byte
// line per instruction at D = 128; element by element otherwise), subtract
// and square in int32, and add s2[d]·diff² with one float multiply-add per
// dimension; a warp shuffle reduction gives the row's sum. The TPU
// wrapper's zero-padding of N and D to its tiles is not needed: the loop
// bounds mask the ragged ends. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

template <bool VEC4>
__global__ void sq_l2_kernel(const int32_t* __restrict__ q,
                             const int32_t* __restrict__ db,
                             const float* __restrict__ s2,
                             float* __restrict__ out, int64_t N, int D,
                             int s2_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* qs = reinterpret_cast<int32_t*>(smem_raw);
  float* ss = reinterpret_cast<float*>(smem_raw + s2_off);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    qs[i] = q[i];
    ss[i] = s2[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t step = (int64_t)gridDim.x * warps;
  for (int64_t n = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); n < N;
       n += step) {
    const int32_t* row = db + n * D;
    float acc = 0.0f;
    if (VEC4) {
      const int4* rv = reinterpret_cast<const int4*>(row);
      const int4* qv = reinterpret_cast<const int4*>(qs);
      const float4* sv = reinterpret_cast<const float4*>(ss);
      for (int j = lane; j < D / 4; j += 32) {
        const int4 w = __ldg(rv + j);
        const int4 c = qv[j];
        const float4 s = sv[j];
        const int e0 = w.x - c.x, e1 = w.y - c.y, e2 = w.z - c.z, e3 = w.w - c.w;
        acc = fmaf(s.x, (float)(e0 * e0), acc);
        acc = fmaf(s.y, (float)(e1 * e1), acc);
        acc = fmaf(s.z, (float)(e2 * e2), acc);
        acc = fmaf(s.w, (float)(e3 * e3), acc);
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const int e = __ldg(row + d) - qs[d];
        acc = fmaf(ss[d], (float)(e * e), acc);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[n] = acc;
  }
}

static const int64_t kMaxBlocks = 132 * 16;

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int repro_sq_l2(const void* q, const void* db, const void* s2,
                           void* out, long long N, int D, int vec4,
                           void* stream) {
  const int threads = 256;  // 8 warps, 8 rows per block per step
  int64_t blocks = (N + 7) / 8;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int s2_off = ((D * 4 + 15) / 16) * 16;
  const size_t smem = (size_t)s2_off + (size_t)D * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(q);
  const int32_t* dp = static_cast<const int32_t*>(db);
  const float* sp = static_cast<const float*>(s2);
  float* op = static_cast<float*>(out);
  if (vec4)
    sq_l2_kernel<true><<<(int)blocks, threads, smem, s>>>(qp, dp, sp, op, N, D, s2_off);
  else
    sq_l2_kernel<false><<<(int)blocks, threads, smem, s>>>(qp, dp, sp, op, N, D, s2_off);
  return (int)cudaGetLastError();
}
