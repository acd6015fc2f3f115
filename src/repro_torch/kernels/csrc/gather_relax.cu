// K11: the semiring relax over work-listed CSR rows-blocks, for Hopper,
// one CTA per rows-block of the union of the batch's work-lists.
//
// Replaces: src/repro/kernels/gather_expand.py, `gather_relax_batched`
// (Pallas body `_relax_batched_kernel` over `_relax_edges`,
// `_relax_scatter_vals` and `_relax_scatter_parents`).
//
// What it computes, per root b and each of its first n_active[b]
// work-list entries blk: for every edge slot e of rows-block blk, the
// owner u (largest u with colstarts[u] <= e) and the neighbour
// v = rows[e]; an edge whose u is in the frontier offers
// cand = vals[u] + unit (+ w(u, v)) to v.
//   phase 0: out[v] = min(out[v], cand)  (out starts as a copy of vals);
//   phase 1: pl[v] = min u over the edges with cand == out[v] < vals[v]
//            (pl starts at P_UNSET).
// Min is order-independent, so both outputs are deterministic and equal
// the reference bitwise: there is no race to restore.
//
// The TPU grid runs phase-major in order, so phase 1 reads finished
// values.  CTAs have no order, so the phases are two launches on one
// stream; phase 1 recomputes each candidate with the same pinned
// operations (relax_common.cuh), which makes `cand == out[v]` exact.
// Phase 0 skips a candidate that does not beat vals[v]: it could not
// lower out[v] below vals[v] and phase 1 would reject it anyway.
//
// What bounds it on this card: bytes, and the latency of dependent
// loads, as in K3: per listed block the rows (coalesced) and the
// colstarts entries its owners span, per edge and root a frontier word,
// vals[u] and vals[v], and an atomic per improving candidate, all read
// twice (once per phase).  The roots of a batch list mostly the same
// blocks, so a walk of each root's own list repeats the rows and the
// owner search of a block for every root that lists it.
//
// Design, as K3's (gather_expand.cu): a 1-D grid of resident CTAs
// strides over the union of the lists; each block's rows are read once
// and its owners put in shared memory once per phase
// (`bfs::owners_by_scan`) for all the roots in its mask, which then run
// the per-root step: the frontier test, `relax::candidate` and
// `relax::relax_at`.  The wrapper hands `vals` and `out` over
// root-interleaved, (v_pad, B), and the frontier (n_words, B), so that
// the B values of one vertex share a sector: vals[v] and the atomics on
// out[v] are random, and on an H100 that layout alone takes the kernel
// from ~28 ms in (B, v_pad) rows to ~11 ms on the largest SCALE-22
// layer.  `pl` stays (B, v_pad).
#include <cuda_runtime.h>

#include "relax_common.cuh"

namespace {

template <bool kFloat>
__global__ void __launch_bounds__(bfs::kThreads) gather_relax_kernel(
    const int* __restrict__ ulist, const int* __restrict__ ucount,
    const unsigned* __restrict__ rmask, const int* __restrict__ rows,
    const int* __restrict__ cs, const unsigned* __restrict__ frontier,
    const int* __restrict__ vals, int* out, int* pl, int n_mask_words,
    int tile, int sub, int n_cs, int v_pad, int n_vertices, int unit,
    int weighted, int phase, int n_batch) {
  extern __shared__ __align__(16) int own[];
  const bfs::UnionItems items{ulist, __ldg(ucount)};
  bfs::sweep_union(
      items, rows, tile, 0, nullptr, [&](int blk, const int* rows_blk) {
        const unsigned* mask =
            rmask + static_cast<long long>(blk) * n_mask_words;
        for (int s0 = 0; s0 < tile; s0 += sub) {
          const int n = min(sub, tile - s0);
          bfs::owners_by_scan(cs, n_cs, blk * tile + s0, n, own);
          for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int u = own[i];
            const int v = __ldg(rows_blk + s0 + i);
            if (u >= n_vertices || v >= n_vertices) continue;
            // root b's word w / value x at w * n_batch + b / x * n_batch + b
            const unsigned* fu =
                frontier + static_cast<long long>(u >> 5) * n_batch;
            const int* vu = vals + static_cast<long long>(u) * n_batch;
            const long long vv = static_cast<long long>(v) * n_batch;
            const unsigned ubit = 1u << (u & 31);
            for (int k = 0; k < n_mask_words; ++k) {
              for (unsigned m = __ldg(mask + k); m; m &= m - 1) {
                const int b = 32 * k + __ffs(m) - 1;
                if (!(__ldg(fu + b) & ubit)) continue;
                const int cand = relax::candidate<kFloat>(
                    __ldg(vu + b), u, v, unit, weighted != 0);
                relax::relax_at(phase, u, cand, vals + vv + b,
                                out + vv + b,
                                pl + static_cast<long long>(b) * v_pad + v);
              }
            }
          }
          if (s0 + sub < tile) __syncthreads();   // own is rewritten
        }
      });
}

}  // namespace

// ulist: (n_blocks,) int32 union list; ucount: (1,) int32; rmask:
// (n_blocks, n_mask_words) 32-bit root masks; rows: (n_blocks * tile,)
// int32; cs: (n_cs,) int32; frontier: root-interleaved (n_words, B)
// 32-bit words; vals, out: root-interleaved (v_pad, B) 32-bit values
// (int32, or float32 bits when is_float); pl: (B, v_pad) int32.  out must hold a copy of vals and
// pl P_UNSET; both are updated in place by the two launches.  Dynamic
// shared memory: `sub` owner slots.  The grid is the CTAs the card
// holds at once (at most max_grid), each striding over the union.
extern "C" int repro_gather_relax(
    const void* ulist, const void* ucount, const void* rmask,
    const void* rows, const void* cs, const void* frontier,
    const void* vals, void* out, void* pl, int n_batch, int n_mask_words,
    int tile, int sub, int n_cs, int v_pad, int n_vertices, int unit,
    int weighted, int is_float, int max_grid, void* stream) {
  if (n_batch == 0 || max_grid <= 0) return 0;
  const size_t smem = static_cast<size_t>(sub) * sizeof(int);
  auto kernel = is_float ? gather_relax_kernel<true>
                         : gather_relax_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int grid = 0;
  const cudaError_t rc = bfs::resident_grid(kernel, smem, max_grid, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int phase = 0; phase < 2; ++phase) {
    kernel<<<grid, bfs::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ulist), static_cast<const int*>(ucount),
        static_cast<const unsigned*>(rmask), static_cast<const int*>(rows),
        static_cast<const int*>(cs), static_cast<const unsigned*>(frontier),
        static_cast<const int*>(vals), static_cast<int*>(out),
        static_cast<int*>(pl), n_mask_words, tile, sub, n_cs, v_pad,
        n_vertices, unit, weighted, phase, n_batch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
