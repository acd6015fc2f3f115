// K11: the semiring relax over work-listed CSR rows-blocks, for Hopper.
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
// loads, as in K3: per active block the rows (coalesced) and the
// colstarts entries its owners span, per edge a frontier word, vals[u]
// and vals[v] (L2-resident for small layers), and an atomic per
// improving candidate, read twice (once per phase).  Design as K3's:
// thread 0 finds the block's owner range once, every thread searches
// only that range; the grid is (CTAs, B) with CTAs striding over the
// work-list, n_active read on the device, no host sync.
#include <cuda_runtime.h>

#include "relax_common.cuh"

namespace {

template <bool kFloat>
__global__ void __launch_bounds__(bfs::kThreads) gather_relax_kernel(
    const int* __restrict__ wl, const int* __restrict__ na,
    const int* __restrict__ rows, const int* __restrict__ cs,
    const unsigned* __restrict__ frontier, const int* __restrict__ vals,
    int* out, int* pl, int n_blocks, int tile, int n_cs, int n_words,
    int v_pad, int n_vertices, int unit, int weighted, int phase) {
  __shared__ int s_lo, s_hi;
  const int b = blockIdx.y;
  const unsigned* fr = frontier + static_cast<long long>(b) * n_words;
  const long long vo = static_cast<long long>(b) * v_pad;
  const int* vb = vals + vo;
  int* ob = out + vo;
  int* pb = pl + vo;
  const bfs::WorkItems items{wl, na, n_blocks, b + 1};
  bfs::sweep(items, b, rows, tile, 0, nullptr,
             [&](int, int blk, const int* rows_blk) {
               const int e0 = blk * tile;
               if (threadIdx.x == 0) {
                 const int lo = bfs::owner_in(cs, 0, n_cs - 1, e0);
                 s_lo = lo;
                 s_hi = bfs::owner_in(cs, lo, n_cs - 1, e0 + tile - 1);
               }
               __syncthreads();
               const int lo = s_lo, hi = s_hi;
               for (int i = threadIdx.x; i < tile; i += blockDim.x) {
                 const int u = bfs::owner_in(cs, lo, hi, e0 + i);
                 const int v = __ldg(rows_blk + i);
                 if (u >= n_vertices || v >= n_vertices) continue;
                 if (!relax::in_frontier(fr, u)) continue;
                 const int cand = relax::candidate<kFloat>(
                     __ldg(vb + u), u, v, unit, weighted != 0);
                 relax::relax_edge(phase, u, v, cand, vb, ob, pb);
               }
             });
}

}  // namespace

// wl: (B, n_blocks) int32; na: (B,) int32; rows: (n_blocks * tile,)
// int32; cs: (n_cs,) int32; frontier: (B, n_words) 32-bit words; vals,
// out: (B, v_pad) 32-bit values (int32, or float32 bits when is_float);
// pl: (B, v_pad) int32.  out must hold a copy of vals and pl P_UNSET;
// both are updated in place by the two launches.
extern "C" int repro_gather_relax(
    const void* wl, const void* na, const void* rows, const void* cs,
    const void* frontier, const void* vals, void* out, void* pl,
    int n_batch, int n_blocks, int tile, int n_cs, int n_words, int v_pad,
    int n_vertices, int unit, int weighted, int is_float, int grid_x,
    void* stream) {
  if (n_batch == 0 || n_blocks == 0 || grid_x <= 0) return 0;
  dim3 grid(grid_x, n_batch);
  for (int phase = 0; phase < 2; ++phase) {
    auto kernel = is_float ? gather_relax_kernel<true>
                           : gather_relax_kernel<false>;
    kernel<<<grid, bfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(wl), static_cast<const int*>(na),
        static_cast<const int*>(rows), static_cast<const int*>(cs),
        static_cast<const unsigned*>(frontier),
        static_cast<const int*>(vals), static_cast<int*>(out),
        static_cast<int*>(pl), n_blocks, tile, n_cs, n_words, v_pad,
        n_vertices, unit, weighted, phase);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}
