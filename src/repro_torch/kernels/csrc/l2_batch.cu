// l2_batch — tiled pairwise squared-L2 distance matrix, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2_batch.py::l2_batch_pallas (body
// _l2_kernel):
//     out[i, j] = max(‖x_i‖² + ‖y_j‖² − 2·x_i·y_j, 0)
// x (N, D) float32, y (C, D) float32 -> out (N, C) float32, all row-major
// and contiguous. Callers: the streaming segment assignment and routed
// growth (ops.nearest_centroid, C = the segment count) and exact k-NN
// ground truth (graph/knn.exact_knn, C = a data chunk of 8,192 rows).
//
// What bounds it on the H100: 2·N·C·D float32 operations against
// 4·(N·D + C·D + N·C) bytes. At the ground-truth tile (1,000 × 8,192 × 128)
// that is about 31 µs of float32 FMA at 67 TFLOP/s against 11 µs of bytes
// at 3.35 TB/s: operations. At the assignment chunk (65,536 × 64 × 128) it
// is about 16 µs against 15 µs: both about equal. No TF32 and no tensor
// cores: the outputs feed an argmin (routing) and a top-k (ground truth),
// so they must hold to the float32 plain version.
//
// Design: one block of 256 threads per 64 × 64 output tile; each thread
// keeps a 4 × 4 micro-tile of dot products in registers (rows ty + 16·i,
// columns tx + 16·j, so a warp's shared-memory reads are broadcasts or
// consecutive words and its stores cover runs of 16 columns). The x and y
// tiles are staged in shared memory 32 columns of D at a time, transposed
// (k-major, padded to 65 words so the staging stores hit 32 banks), with
// full-float32 FMA. ‖x‖² and ‖y‖² are summed from the same staged tiles
// (two warps each), as _l2_kernel does in-kernel, so each operand is read
// from device memory once per tile. Ragged edges of N, C and D are masked
// at the loads (zeros change neither dot products nor norms) and at the
// stores; nothing is padded in memory — the TPU wrapper's zero-padding to
// 128 lanes is a TPU layout device. Offsets are 64-bit.
//
// At the narrow assignment shape (C = 64) one tile spans all of C, and
// each x tile is read once; a C below 64 wastes the tile's spare columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows (x rows) per block
constexpr int BN = 64;       // output columns (y rows) per block
constexpr int BK = 32;       // D columns staged per step
constexpr int THREADS = 256;
constexpr int PAD = BM + 1;  // k-major staging stride (BM == BN)

__global__ void __launch_bounds__(THREADS)
l2_batch_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int N, int C, int D) {
  __shared__ float xs[BK * PAD];
  __shared__ float ys[BK * PAD];
  __shared__ float x2s[BM];
  __shared__ float y2s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;

  // staging map: lane = column k of the step, warp w = rows w + 8·i
  const int lk = tid % BK;
  const int lr = tid / BK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads 0..63: ‖x_row‖²; threads 64..127: ‖y_row‖²

  for (int k0 = 0; k0 < D; k0 += BK) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < BM / (THREADS / BK); ++i) {
      const int r = lr + i * (THREADS / BK);
      const int64_t gx = row0 + r;
      const int64_t gy = col0 + r;
      xs[lk * PAD + r] = (gx < N && k < D) ? __ldg(x + gx * D + k) : 0.f;
      ys[lk * PAD + r] = (gy < C && k < D) ? __ldg(y + gy * D + k) : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float v = xs[kk * PAD + tid];
        norm = fmaf(v, v, norm);
      }
    } else if (tid < BM + BN) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float v = ys[kk * PAD + tid - BM];
        norm = fmaf(v, v, norm);
      }
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk * PAD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk * PAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) {
    x2s[tid] = norm;
  } else if (tid < BM + BN) {
    y2s[tid - BM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int64_t gr = row0 + r;
    if (gr >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int64_t gc = col0 + c;
      if (gc >= C) continue;
      const float v = (x2s[r] + y2s[c]) - 2.f * acc[i][j];
      out[gr * C + gc] = fmaxf(v, 0.f);
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch. Grid: x over ⌈N/64⌉ row tiles, y over ⌈C/64⌉ column tiles (the
// wrapper keeps the latter within 65,535).
extern "C" int repro_l2_batch(const void* x, const void* y, void* out, int N,
                              int C, int D, void* stream) {
  const dim3 grid((N + BM - 1) / BM, (C + BN - 1) / BN);
  l2_batch_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), N, C, D);
  return (int)cudaGetLastError();
}
