// l2_batch — pairwise squared-L2 distance matrix on Hopper's tensor cores
// at float32 accuracy (3xTF32), fed by TMA. sm_90a.
//
// Replaces the TPU kernel repro/kernels/l2_batch.py::l2_batch_pallas (body
// _l2_kernel):
//     out[i, j] = max(‖x_i‖² + ‖y_j‖² − 2·x_i·y_j, 0)
// x (N, D) float32, y (C, D) float32 -> out (N, C) float32, row-major. The
// wrapper (kernels/ops.py::l2_batch, plan in ops._l2_plan) hands the kernel
// rows whose stride D is a multiple of 4 floats on 16-byte aligned bases,
// copying into a zero-padded (·, ⌈D/4⌉·4) tensor where the caller's is not
// (a counted layout step, ops.launches["l2_batch_pad"]). Callers: streaming
// segment assignment and routed growth (ops.nearest_centroid, C = the
// segment count, 64 on the scale-out path) and exact k-NN ground truth
// (graph/knn.exact_knn, C = a data chunk of 8,192 rows).
//
// The product. The outputs feed an argmin (routing) and a top-k (ground
// truth), so they hold the float32 plain version (allclose, rtol 1e-5, atol
// 1e-5·max(‖x‖² + ‖y‖²)). Plain TF32 keeps 11 bits and would not. Each
// operand is split into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v − hi),
// and three TF32 products hi·hi + hi·lo + lo·hi go into one float32
// accumulator (wgmma m64nNk8 .f32.tf32.tf32). The dropped lo·lo term and the
// rounding of lo cost about 2⁻²² of |x_d·y_d| per term, far inside the
// tolerance. ‖x‖² and ‖y‖² are summed in float32 FMA from the unsplit staged
// values, as _l2_kernel does in-kernel.
//
// What bounds it on the H100 (3 × 2·N·C·D operations at TF32's 495 TFLOP/s
// against each operand read and the output written once at 3.35 TB/s):
//   ground-truth tile 1,000 × 8,192 × 128: 12.7 µs of operations against
//     11.2 µs of bytes (the 32.8 MB output is most of them): operations;
//   assignment chunk 65,536 × 64 × 128: 15.0 µs of bytes against 6.5 µs of
//     operations: bytes (x in, out back).
// Inside a block the three products, the split and the output compete: a
// wgmma reads its shared-memory operand at close to the SM's shared-memory
// rate, splitting in shared memory reads an operand once and writes it twice,
// and direct stores of the output stall the threads that make them. With
// both operands split in shared memory and direct stores, timers on the card
// showed the products, the splits and the stores taking turns in a block
// rather than overlapping (PERF.md). So x is split in registers and the
// output leaves through TMA.
//
// Design. One persistent block per SM walks over output tiles of 128 x rows
// (BM) by BN y rows. Warps 0–7 are two consumer warpgroups, one per 64-row
// half; warp 8 is the producer, whose lane 0 starts every copy: TMA
// (cp.async.bulk.tensor.2d, tensor maps passed as __grid_constant__
// parameters, encoded per call on the host) of 32-column D slices, one
// 128-byte row each in the 128-byte swizzle that wgmma reads, into a ring of
// `stages` buffers with full/empty mbarriers. TMA's zero fill covers the
// ragged N, C and D edges: zeros change neither products nor norms.
//   x is the register operand (A). Each consumer thread loads its fragment of
// a slice straight from the copied tile (rows 16·warp + lane/4 and + 8,
// columns lane % 4 and + 4 of each k8 step, through the swizzle; the loads
// are free of bank conflicts), splits it in registers and adds the squares
// to its two rows' norms (summed over the quad at the tile's end, which
// leaves each thread the norms of exactly the rows its epilogue writes).
//   y is the shared-memory operand (B), K-major as TF32 wgmma requires (x and
// y are row-major with D contiguous: no transpose).
//   A stage goes back to the producer as soon as it has been read, before
// the products run, so the ring's depth does not wait on the MMA. Each slice
// starts 4 k-steps × 3 products; while they run, the consumers wait for the
// next slice's copy and (wide) split its y rows; then they wait for the
// products (wait_group 0) before the next slice overwrites the fragment
// registers.
//   The epilogue computes x2[r] + y2[c] − 2·acc clamped at 0 into an output
// tile in shared memory (128-byte swizzle, 32-column stripes) that one thread
// stores with TMA (cp.async.bulk.tensor, clipped at the ragged edges); the
// consumers start the next tile while the copy drains, where direct stores
// would stall them. An output tensor map needs C % 4 == 0; otherwise each
// thread stores its values.
//
// Two tile shapes, one source; ops._l2_plan picks by C:
//   wide   (C > 64, or y too wide to keep): BN = 128; each slice's y rows
//          are split from the stage into a double buffer (hi and lo in the
//          swizzled layout at the same offsets, one slice ahead of the
//          products) and ‖y‖² summed, then a named barrier of the consumers;
//          3 stages of 32 KB. Bound by operations at the ground-truth shape.
//   narrow (C ≤ 64 and y's split tiles fit beside a ring of ≥ 2 stages):
//          BN = 64; each block loads y once, splits it and sums ‖y‖², keeps
//          both resident, and streams x row tiles through up to 8 stages of
//          16 KB; the two warpgroups meet only at the epilogue. Bound by
//          bytes, so the ring's depth matters more than the MMA rate.
// The host side looks cuTensorMapEncodeTiled up once through the runtime's
// entry-point query, so this library links no -lcuda.
// Offsets into out are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 128;                  // x rows per tile (two 64-row halves)
constexpr int BK = 32;                   // D columns per slice: one 128 B row
constexpr int ROW_B = BK * 4;            // bytes of one staged row
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int X_TILE_B = BM * ROW_B;     // one x slice: 16 KB
constexpr int MAX_SMEM = 232448;         // what one block may have on sm_90

// shared-memory bytes of one launch: 1 KB of alignment slack, the ring of
// copied slices (x, and y unless resident), the split y slices (hi and lo:
// two buffers, or every slice when resident), the output tile, y's norms and
// the barriers. ops._l2_plan mirrors this to pick the stages.
constexpr int smem_bytes(int bn, bool resident, int nk, int stages) {
  return 1024 + stages * (X_TILE_B + (resident ? 0 : bn * ROW_B)) +
         (resident ? nk : 2) * 2 * bn * ROW_B + BM * bn * 4 + 4 * bn + 8 * (2 * stages + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box (32 columns from c0, box rows from r0) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// one TMA box (32 columns from c0, BM rows from r0) from shared memory to out
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(r0)
      : "memory");
}

// the consumer warpgroups' barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1,024 B apart (SBO), leading offset unused by this swizzle
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Split the 4 floats at src into their TF32 high parts (to hi) and low parts
// (to lo); src may be hi. Returns the sum of their squares (unsplit values).
__device__ __forceinline__ float split16(const uint8_t* src, uint8_t* hi, uint8_t* lo) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  float4 h, l;
  h.x = tf32_rna(v.x);
  h.y = tf32_rna(v.y);
  h.z = tf32_rna(v.z);
  h.w = tf32_rna(v.w);
  l.x = tf32_rna(v.x - h.x);
  l.y = tf32_rna(v.y - h.y);
  l.z = tf32_rna(v.z - h.z);
  l.w = tf32_rna(v.w - h.w);
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
  return fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, v.x * v.x)));
}

// sum over the 8 consecutive lanes that hold one staged row
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// Split one copied y slice (BN rows at src) into hi and lo at yh and yh +
// BN rows, adding the squares to this thread's row sums: chunk c = tid + 256·i
// is row c / 8 (its 8 chunks on 8 consecutive lanes).
template <int BN>
__device__ __forceinline__ void split_y(const uint8_t* src, uint8_t* yh,
                                       float (&ny)[BN * 8 / CONSUMERS], int tid) {
#pragma unroll
  for (int i = 0; i < BN * 8 / CONSUMERS; ++i) {
    const int c = tid + CONSUMERS * i;
    ny[i] += split16(src + 16 * c, yh + 16 * c, yh + BN * ROW_B + 16 * c);
  }
}

// sum over the quad (4 consecutive lanes) that holds one fragment row
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// acc += A·Bᵀ for one k8 step: m64n128k8, A tf32 from registers (this thread's
// fragment), B tf32 in shared memory (descriptor)
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc += A·Bᵀ for one k8 step: m64n64k8, A tf32 from registers (this thread's
// fragment), B tf32 in shared memory (descriptor)
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 128) {
    mma_n128(d, a, b);
  } else {
    mma_n64(d, a, b);
  }
}

// pin the accumulator registers at this point of the program: reads after a
// wgmma wait, and writes before the first wgmma, may not move across it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float clamp_l2(float x2, float y2, float xy) {
  return fmaxf((x2 + y2) - 2.f * xy, 0.f);
}

// out rows row0 + [0, 128), columns col0 + [0, BN) from one consumer thread's
// accumulator fragment: d[4j + 2h + e] is row rr + 8h of the tile (rr =
// 64·wg + 16·warp + lane/4), whose ‖x‖² is x2[h], column 8j + 2·(lane % 4) + e.
// With an output tensor map (C % 4 == 0) the tile goes through shared memory
// (ostage: BN/32 stripes of BM rows × 128 B in the 128-byte swizzle) and out
// by TMA, which clips the ragged edges; the consumers go on while it drains.
// Otherwise each thread stores its values.
template <int BN>
__device__ __forceinline__ void epilogue(const float (&d)[BN / 2], const float (&x2)[2],
                                         const float* y2s, uint8_t* ostage,
                                         const CUtensorMap* to, float* __restrict__ out,
                                         int N, int C, int row0, int col0, int rr, int lane,
                                         int tid) {
  const int q = lane % 4;
  if (to != nullptr) {
    // the previous tile's stores have read the staging tile
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    consumers_sync();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cc = 8 * j + 2 * q;
      const float2 y2 = *reinterpret_cast<const float2*>(y2s + cc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h;  // r % 8 == lane / 4
        float2 o;
        o.x = clamp_l2(x2[h], y2.x, d[4 * j + 2 * h]);
        o.y = clamp_l2(x2[h], y2.y, d[4 * j + 2 * h + 1]);
        *reinterpret_cast<float2*>(ostage + (cc / 32) * BM * ROW_B + r * ROW_B +
                                   ((((cc % 32) / 4) ^ (r % 8)) * 16) + (cc % 4) * 4) = o;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < BN / 32; ++p) {
        tma_store(to, ostage + p * BM * ROW_B, col0 + 32 * p, row0);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = static_cast<int64_t>(row0) + rr + 8 * h;
        if (r >= N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = 8 * j + 2 * q + e;
          const int c = col0 + cc;
          if (c < C) out[r * C + c] = clamp_l2(x2[h], y2s[cc], d[4 * j + 2 * h + e]);
        }
      }
    }
  }
}

// BN y rows per tile; RESIDENT: y (C ≤ BN rows) loaded, split and normed once
// per block and kept in shared memory, only x streams (the narrow shape).
template <int BN, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    l2_batch_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap to, float* __restrict__ out, int N, int C,
                    int nk, int stages, int tma_out) {
  constexpr int Y_TILE_B = BN * ROW_B;
  constexpr int STAGE_B = X_TILE_B + (RESIDENT ? 0 : Y_TILE_B);  // one copied slice
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1 KB atoms
  // split y slices, hi then lo: resident, slice k at 2k; else slice it at it % 2
  uint8_t* ysplit = smem + stages * STAGE_B;
  uint8_t* ostage = ysplit + (RESIDENT ? nk : 2) * 2 * Y_TILE_B;  // the output tile
  float* y2s = reinterpret_cast<float*>(ostage + BM * BN * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(y2s + BN);
  uint64_t* empty = full + stages;
  uint64_t* ybar = empty + stages;

  const int tid = threadIdx.x;
  const int m_tiles = (N + BM - 1) / BM;
  const int n_tiles = RESIDENT ? m_tiles : m_tiles * ((C + BN - 1) / BN);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_init(ybar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == CONSUMERS) {
      if (RESIDENT) {
        mbar_expect_tx(ybar, nk * Y_TILE_B);
        for (int k = 0; k < nk; ++k) tma_load(ysplit + k * 2 * Y_TILE_B, &ty, ybar, k * BK, 0);
      }
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int row0 = (t % m_tiles) * BM;
        const int col0 = (t / m_tiles) * BN;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % stages;
          mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE_B;
          mbar_expect_tx(full + s, STAGE_B);
          tma_load(st, &tx, full + s, k * BK, row0);
          if (!RESIDENT) tma_load(st + X_TILE_B, &ty, full + s, k * BK, col0);
        }
      }
    }
    return;
  }

  // ---- consumers: fragments, split, multiply, write ----
  const int wg = tid / 128;  // x rows [64·wg, 64·wg + 64) of each tile
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rr = wg * 64 + warp * 16 + g;  // fragment rows rr and rr + 8; both ≡ g (mod 8)

  if (RESIDENT) {
    mbar_wait(ybar, 0);
    float ny[BN * 8 / CONSUMERS];
#pragma unroll
    for (int i = 0; i < BN * 8 / CONSUMERS; ++i) ny[i] = 0.f;
    for (int k = 0; k < nk; ++k) {
      uint8_t* yh = ysplit + k * 2 * Y_TILE_B;
      split_y<BN>(yh, yh, ny, tid);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / CONSUMERS; ++i) {
      const float v = sum8(ny[i]);
      if (lane % 8 == 0) y2s[(tid + CONSUMERS * i) / 8] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
  }

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = (t % m_tiles) * BM;
    const int col0 = (t / m_tiles) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    float x2[2] = {0.f, 0.f};
    float ny[BN * 8 / CONSUMERS];
#pragma unroll
    for (int i = 0; i < BN * 8 / CONSUMERS; ++i) ny[i] = 0.f;

    // wide: y slice it is split into buffer it % 2 one step ahead, while
    // slice it − 1's products run; that buffer was last read by slice it − 2's
    // products, which both warpgroups waited for before slice it − 1's barrier
    mbar_wait(full + it % stages, (it / stages) & 1);
    if (!RESIDENT) {
      split_y<BN>(smem + (it % stages) * STAGE_B + X_TILE_B, ysplit + (it % 2) * 2 * Y_TILE_B, ny,
                  tid);
    }
    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % stages;
      const uint8_t* st = smem + s * STAGE_B;

      // this thread's x fragment of the slice, split in registers: value v
      // of k-step kk is row rr + 8·(v & 1), column 8·kk + tq + 4·(v >> 1),
      // in 16-byte chunk (2·kk + (v >> 1)) ^ g of its 128-byte row
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      const uint8_t* xrow = st + rr * ROW_B + tq * 4;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float f = *reinterpret_cast<const float*>(
              xrow + (v & 1) * 8 * ROW_B + (((2 * kk + (v >> 1)) ^ g) * 16));
          x2[v & 1] = fmaf(f, f, x2[v & 1]);
          const float h = tf32_rna(f);
          ah[kk][v] = __float_as_uint(h);
          al[kk][v] = __float_as_uint(tf32_rna(f - h));
        }
      }
      if (!RESIDENT) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(empty + s);  // the stage has been read: back to the producer
      if (!RESIDENT) consumers_sync();

      const uint8_t* yh = ysplit + (RESIDENT ? k : it % 2) * 2 * Y_TILE_B;
      const uint64_t bh = desc(yh), bl = desc(yh + Y_TILE_B);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {  // k8 steps: 32 B further along each row
        mma<BN>(acc, ah[kk], bh + 2 * kk);
        mma<BN>(acc, ah[kk], bl + 2 * kk);
        mma<BN>(acc, al[kk], bh + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (k + 1 < nk) {  // the next slice's copy, and (wide) its y split
        const int s1 = (it + 1) % stages;
        mbar_wait(full + s1, ((it + 1) / stages) & 1);
        if (!RESIDENT) {
          split_y<BN>(smem + s1 * STAGE_B + X_TILE_B, ysplit + ((it + 1) % 2) * 2 * Y_TILE_B, ny,
                      tid);
        }
      }
      // the fragment registers are rewritten by the next slice
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(acc);
    }

    x2[0] = sum4(x2[0]);
    x2[1] = sum4(x2[1]);
    if (!RESIDENT) {
      // y2s was last read by the previous tile's epilogue, which every
      // consumer finished before this tile's first barrier
#pragma unroll
      for (int i = 0; i < BN * 8 / CONSUMERS; ++i) {
        const float v = sum8(ny[i]);
        if (lane % 8 == 0) y2s[(tid + CONSUMERS * i) / 8] = v;
      }
      consumers_sync();
    }
    epilogue<BN>(acc, x2, y2s, ostage, tma_out ? &to : nullptr, out, N, C, row0, col0, rr, lane,
                 tid);
  }
  // the staging tile must outlive the last stores' reads of it
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool ok = e == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a (rows, cols) row-major float32 tensor read or written as boxes of 32
// columns × box_rows in the 128-byte swizzle
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool RESIDENT>
int launch(const CUtensorMap& tx, const CUtensorMap& ty, const CUtensorMap& to, int tma_out,
           float* out, int N, int C, int nk, int stages, int grid, cudaStream_t stream) {
  const int smem = smem_bytes(BN, RESIDENT, nk, stages);
  if (smem > MAX_SMEM || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory cap to the block's maximum once per
  // device (bit d of done: device d), not at every call
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(done.load() & bit)) {
    e = cudaFuncSetAttribute(l2_batch_kernel<BN, RESIDENT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    done.fetch_or(bit);
  }
  l2_batch_kernel<BN, RESIDENT><<<grid, THREADS, smem, stream>>>(tx, ty, to, out, N, C, nk, stages,
                                                                  tma_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). x (N, D) and y (C, D) float32 with D a
// multiple of 4 and 16-byte aligned bases; narrow: C ≤ 64 with y resident
// (BN = 64), else BN = 128; stages of the ring and the persistent grid come
// from ops._l2_plan. Returns cudaGetLastError() after the launch, or before
// it a cudaError (refused shared memory, invalid plan), 100000 + the CUresult
// of a tensor map that failed to encode, or 99999 where libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int repro_l2_batch(const void* x, const void* y, void* out, int N, int C, int D,
                              int narrow, int stages, int grid, void* stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return 99999;
  const int bn = narrow ? 64 : 128;
  CUtensorMap tx, ty, to = {};
  CUresult r = encode(fn, &tx, x, N, D, BM);
  if (r == CUDA_SUCCESS) r = encode(fn, &ty, y, C, D, bn);
  // out's rows must be 16-byte multiples for a tensor map (the wrapper
  // allocates out, so its base is aligned)
  const int tma_out = C % 4 == 0;
  if (r == CUDA_SUCCESS && tma_out) r = encode(fn, &to, out, N, C, BM);
  if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  const int nk = (D + BK - 1) / BK;
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return narrow ? launch<64, true>(tx, ty, to, tma_out, o, N, C, nk, stages, grid, s)
                : launch<128, false>(tx, ty, to, tma_out, o, N, C, nk, stages, grid, s);
}
