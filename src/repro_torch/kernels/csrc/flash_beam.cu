// flash_beam — a whole base-layer beam search per query in one launch,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_expand.py::flash_expand_pallas
// (body _flash_expand_kernel) together with the loop that launches it once
// per iteration: the reference's lax.while_loop in
// repro/graph/beam.py::beam_search under vmap, which the port's plain
// version runs as kernels/ref.py::beam_loop. Per query, from a sorted
// initial beam of ef (d, id, expanded) entries and E entry ids:
//     while best_unexp <= d[ef-1] and best_unexp < inf and it < max_iters:
//         expand the W best unexpanded entries (marking them expanded),
//         score their W·R neighbours exactly as flash_expand does,
//         drop empty and visited slots, marking the rest visited row by row,
//         beam = the ef smallest of cat[beam, new], ties to the lower index.
// Outputs: the final beam's d and ids and the loop's n_dists / n_hops.
// Tables are int32 levels (the main path's), so every d is an int32 sum
// converted to float32: there is no NaN and no -0.0, and float `<` orders
// the values as torch.sort does.
//
// What bounds it on the H100: latency, not bytes. An iteration reads W
// adjacency rows and W packed code rows (384 B each at R = 32, M = 16),
// tests W·R bits and merges in shared memory, and the next iteration
// depends on the merge. A 1,000-query search over 500k vertices needs
// about 32 MB (0.01 ms at 3.35 TB/s), and this design zeroes another
// 62.5 MB of visited bitmap; the step-per-launch loop this replaces spent
// about 0.34 ms per iteration on launches.
//
// Design:
// * One block per query, W·R threads rounded up to whole warps (32 at W = 1,
//   128 at W = 4), at most 1,024: above that a thread takes slots tid,
//   tid + 1024, … (W·R = 1,536 at W = 16, R = 96), and every phase below
//   that a thread ran for its one slot runs round by round, a barrier per
//   round. The block runs the loop to the end with the query's own
//   stopping test and no host involvement; at Q = 1,000 every block is
//   resident at once.
// * All state in shared memory for the whole loop: the (M, K) table, the
//   beam in two buffers of ef × (d, id, expanded), the W·R candidate ids
//   and distances and the kept ones sorted — under 7 KB at ef = 256, W = 4.
//   The wrapper (ops.flash_beam) computes the bytes of this layout, raises
//   above what a block may have and passes them in; above 48 KB the entry
//   point raises the kernel's dynamic limit.
// * Visited: one bit per vertex, in the query's row of a (Q, ⌈n/32⌉) int32
//   workspace that the block zeroes (8x fewer bytes than a bool row).
// * Selection (warp 0): the beam is sorted by d, so the W smallest (key,
//   position) pairs, key = inf for expanded entries, are the first W
//   unexpanded finite entries in position order: one ballot per 32
//   positions. A pick with key inf keeps key inf whether marked or not, so
//   only the finite picks are marked; nodes is -1 for the rest.
// * Expansion: thread j of frontier row i reads adjacency[node, j] and
//   scores the slot's code word with repro_flash::score_slot, the function
//   flash_expand calls. The code word's address does not depend on the
//   neighbour id, so both loads are in flight at once.
// * Visited: the reference tests and marks row by row (row i sees the marks
//   of rows < i; inside a row every slot tests before any marks, so a
//   vertex repeated inside one row survives twice). In closed form: a slot
//   survives iff its vertex was unvisited before the iteration and no slot
//   of an earlier row holds it (the first such row's slot survives and
//   marks it). So every slot reads its bitmap word once, all in parallel
//   through L2 (__ldcg: the marks are L2 atomics), keeping d = inf if the
//   bit was set; after a barrier it checks the earlier rows' ids in shared
//   memory, and the survivors mark.
// * Merge by rank, equal to a stable sort of cat[beam, new] cut at ef: a new
//   entry's rank is its stable rank s among the new ones (by (d, slot)) plus
//   #{beam <= d} (binary search); a beam entry at position p goes to
//   p + #{kept new < d} (binary search in the kept new entries, a sorted
//   prefix). Ranks >= ef are dropped; new entries enter unexpanded.
// * Counts: n_dists += the new finite slots, n_hops += the finite picks,
//   both int64.

#include <math_constants.h>

#include "flash_common.cuh"

using repro_flash::kPackedBytes;
using repro_flash::kPackedWords;
using repro_flash::kUnpacked;

namespace {

template <int LAYOUT>
__global__ void __launch_bounds__(1024)
    flash_beam_kernel(const int32_t* __restrict__ adt,
                      const int32_t* __restrict__ adj,
                      const void* __restrict__ mirror,
                      const float* __restrict__ beam_d_in,
                      const int32_t* __restrict__ beam_i_in,
                      const uint8_t* __restrict__ beam_e_in,
                      const int32_t* __restrict__ entries,
                      uint32_t* __restrict__ visited,
                      float* __restrict__ beam_d_out,
                      int32_t* __restrict__ beam_i_out,
                      long long* __restrict__ n_dists_out,
                      long long* __restrict__ n_hops_out, int64_t words, int R,
                      int Mp, int M, int K, int E, int ef, int W,
                      int max_iters) {
  // Dynamic shared memory (ops._beam_smem_bytes counts it): table, 2
  // control words, 2 x ef (d, id), W·R ids, 2 x W·R d, W nodes, then
  // 2 x ef expanded flags.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WR = W * R;
  int32_t* table = reinterpret_cast<int32_t*>(smem_raw);
  int32_t* ctrl = table + M * K;  // [0] picks this iteration, [1] active
  float* d = reinterpret_cast<float*>(ctrl + 2);
  float* d_nx = d + ef;
  int32_t* ids = reinterpret_cast<int32_t*>(d_nx + ef);
  int32_t* ids_nx = ids + ef;
  int32_t* cid = ids_nx + ef;                         // slot ids, -1 = empty
  float* cd = reinterpret_cast<float*>(cid + WR);      // new d, inf = dropped
  float* sd = cd + WR;                                // kept new d, sorted
  int32_t* nodes = reinterpret_cast<int32_t*>(sd + WR);
  uint8_t* ex = reinterpret_cast<uint8_t*>(nodes + W);
  uint8_t* ex_nx = ex + ef;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t q = blockIdx.x;
  uint32_t* vis = visited + q * words;

  for (int i = tid; i < M * K; i += blockDim.x) table[i] = adt[q * M * K + i];
  for (int64_t i = tid; i < words; i += blockDim.x) vis[i] = 0u;
  for (int p = tid; p < ef; p += blockDim.x) {
    d[p] = beam_d_in[q * ef + p];
    ids[p] = beam_i_in[q * ef + p];
    ex[p] = beam_e_in[q * ef + p];
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    const int v = entries[q * E + e];
    if (v >= 0) atomicOr(vis + (v >> 5), 1u << (v & 31));
  }
  __syncthreads();

  const int nthr = blockDim.x;
  const int rounds = (WR + nthr - 1) / nthr;  // slots per thread, at most
  long long nd = 0, nh = 0;
  for (int it = 0; it < max_iters; ++it) {
    // ---- selection and the stopping test (warp 0) ----
    if (tid < 32) {
      int found = 0;
      float best = CUDART_INF_F;
      for (int base = 0; base < ef && found < W; base += 32) {
        const int p = base + lane;
        const bool cand = p < ef && !ex[p] && d[p] < CUDART_INF_F;
        const unsigned mask = __ballot_sync(0xffffffffu, cand);
        if (found == 0 && mask != 0u) best = d[base + __ffs(mask) - 1];
        if (cand) {
          const int rank = found + __popc(mask & ((1u << lane) - 1u));
          if (rank < W) {
            nodes[rank] = ids[p];
            ex[p] = 1;
          }
        }
        found += __popc(mask);
      }
      const int nsel = found < W ? found : W;
      for (int i = nsel + lane; i < W; i += 32) nodes[i] = -1;
      if (lane == 0) {
        ctrl[0] = nsel;
        ctrl[1] = best <= d[ef - 1] && best < CUDART_INF_F;
      }
    }
    __syncthreads();
    if (!ctrl[1]) break;
    nh += ctrl[0];

    // ---- expansion: score this thread's slots, read their bitmap bits ----
    // A slot's new d is inf unless its vertex was unvisited before the
    // iteration (d is an int32 sum otherwise, so finite).
    for (int s = tid; s < WR; s += nthr) {
      const int row = s / R;
      const int node = nodes[row];
      int nbr = -1;
      float dv = CUDART_INF_F;
      if (node >= 0) {
        const int64_t slot = (int64_t)node * R + (s - row * R);
        nbr = __ldg(adj + slot);
        dv = (float)repro_flash::score_slot<int32_t, LAYOUT>(table, mirror,
                                                             slot, Mp, M, K);
      }
      const bool fresh =
          nbr >= 0 && (__ldcg(vis + (nbr >> 5)) & (1u << (nbr & 31))) == 0u;
      cid[s] = nbr;
      cd[s] = fresh ? dv : CUDART_INF_F;
    }
    __syncthreads();  // every bitmap read before any mark; cid whole

    // ---- visited: and in no earlier row; the survivors mark ----
    int n_new = 0;
    for (int rr = 0; rr < rounds; ++rr) {
      const int s = rr * nthr + tid;
      bool ok = s < WR && cd[s] < CUDART_INF_F;
      if (ok) {
        const int nbr = cid[s];
        const int first = (s / R) * R;
        for (int k = 0; k < first; ++k) {
          if (cid[k] == nbr) {
            ok = false;
            break;
          }
        }
        if (ok) atomicOr(vis + (nbr >> 5), 1u << (nbr & 31));
        else cd[s] = CUDART_INF_F;
      }
      n_new += __syncthreads_count(ok);
    }
    nd += n_new;
    if (n_new == 0) continue;  // nothing to merge: the beam stays

    // ---- merge: ranks of the new entries, then of the beam entries ----
    int kept = 0;
    for (int rr = 0; rr < rounds; ++rr) {
      const int s = rr * nthr + tid;
      int rank = ef;
      if (s < WR && cd[s] < CUDART_INF_F) {
        const float dv = cd[s];
        int lo = 0, hi = ef;  // #{beam <= dv}
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (d[mid] <= dv) lo = mid + 1; else hi = mid;
        }
        if (lo < ef) {
          int sr = 0;  // stable rank among the new entries
          for (int k = 0; k < WR; ++k) {
            const float o = cd[k];
            sr += (o < dv) || (o == dv && k < s);
          }
          rank = sr + lo;
          if (rank < ef) {
            sd[sr] = dv;
            d_nx[rank] = dv;
            ids_nx[rank] = cid[s];
            ex_nx[rank] = 0;
          }
        }
      }
      kept += __syncthreads_count(rank < ef);
    }
    if (kept == 0) continue;
    for (int p = tid; p < ef; p += blockDim.x) {
      const float a = d[p];
      int lo = 0, hi = kept;  // #{kept new < a}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sd[mid] < a) lo = mid + 1; else hi = mid;
      }
      const int pos = p + lo;
      if (pos < ef) {
        d_nx[pos] = a;
        ids_nx[pos] = ids[p];
        ex_nx[pos] = ex[p];
      }
    }
    __syncthreads();
    float* tf = d; d = d_nx; d_nx = tf;
    int32_t* ti = ids; ids = ids_nx; ids_nx = ti;
    uint8_t* tb = ex; ex = ex_nx; ex_nx = tb;
  }

  for (int p = tid; p < ef; p += blockDim.x) {
    beam_d_out[q * ef + p] = d[p];
    beam_i_out[q * ef + p] = ids[p];
  }
  if (tid == 0) {
    n_dists_out[q] = nd;
    n_hops_out[q] = nh;
  }
}

template <int LAYOUT>
int launch(const void* adt, const void* adj, const void* mirror,
           const void* beam_d, const void* beam_ids, const void* beam_exp,
           const void* entries, void* visited, void* out_d, void* out_ids,
           void* n_dists, void* n_hops, int Q, int n, int R, int Mp, int M,
           int K, int E, int ef, int W, int max_iters, int smem,
           cudaStream_t stream) {
  const int err = repro_flash::allow_smem(flash_beam_kernel<LAYOUT>, smem);
  if (err) return err;
  int threads = ((W * R + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int64_t words = ((int64_t)n + 31) / 32;
  flash_beam_kernel<LAYOUT><<<Q, threads, smem, stream>>>(
      static_cast<const int32_t*>(adt), static_cast<const int32_t*>(adj),
      mirror, static_cast<const float*>(beam_d),
      static_cast<const int32_t*>(beam_ids),
      static_cast<const uint8_t*>(beam_exp),
      static_cast<const int32_t*>(entries), static_cast<uint32_t*>(visited),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_ids),
      static_cast<long long*>(n_dists), static_cast<long long*>(n_hops),
      words, R, Mp, M, K, E, ef, W, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). adt (Q, M, K) int32; adjacency (n, R)
// int32; mirror (n, R, Mp) uint8 read as 8-byte words (layout 1, Mp % 8 ==
// 0, 8-byte aligned) or byte-wise (layout 2, any M), or (n, R, M) int32
// (layout 0); the sorted initial beam (Q, ef) as f32
// d, int32 ids, bool expanded; entries (Q, E) int32; visited a (Q, ⌈n/32⌉)
// int32 workspace; smem the block's dynamic shared-memory bytes. The
// wrapper checks the shapes and smem against the block limit.
// Writes the final (Q, ef) d and ids and (Q,) int64 n_dists / n_hops of the
// loop. Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_beam(const void* adt, const void* adj,
                                const void* mirror, const void* beam_d,
                                const void* beam_ids, const void* beam_exp,
                                const void* entries, void* visited,
                                void* out_d, void* out_ids, void* n_dists,
                                void* n_hops, int Q, int n, int R, int Mp,
                                int M, int K, int E, int ef, int W,
                                int max_iters, int smem, int layout,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kPackedWords)
    return launch<kPackedWords>(adt, adj, mirror, beam_d, beam_ids, beam_exp,
                                entries, visited, out_d, out_ids, n_dists,
                                n_hops, Q, n, R, Mp, M, K, E, ef, W, max_iters,
                                smem, s);
  if (layout == kPackedBytes)
    return launch<kPackedBytes>(adt, adj, mirror, beam_d, beam_ids, beam_exp,
                                entries, visited, out_d, out_ids, n_dists,
                                n_hops, Q, n, R, Mp, M, K, E, ef, W, max_iters,
                                smem, s);
  return launch<kUnpacked>(adt, adj, mirror, beam_d, beam_ids, beam_exp,
                           entries, visited, out_d, out_ids, n_dists, n_hops,
                           Q, n, R, Mp, M, K, E, ef, W, max_iters, smem, s);
}
