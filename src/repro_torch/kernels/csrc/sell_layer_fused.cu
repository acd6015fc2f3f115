// K9: one SELL-C-σ BFS layer of a root batch in ONE cooperative launch,
// for Hopper, walking the union of the roots' work-lists.
//
// Replaces: src/repro/kernels/sell_expand.py, `sell_layer_fused_batched`
// (Pallas body `_sell_layer_batched_kernel`: `_plan_slabs_in_kernel`,
// the `_dma_pipeline` cols stream over `_sell_tile`,
// `_restore_in_kernel`) and, at B = 1, `sell_layer_fused`
// (`_sell_layer_kernel`).
//
// What it computes, per root b: the slab groups holding a row below V
// that is in the planning bitmap (the frontier top-down, the unvisited
// set bottom-up) -> their count n_active[b]; K8's sweep of those groups
// into a zeroed `out` and, in place, P; then restoration, so the
// returned `out` holds every vertex discovered this layer and P is
// non-negative.  The engine ORs `out` into visited.
//
// The TPU kernel plans at grid step 0, sweeps, and restores at the
// last step.  Here four phases (union_phases.cuh) are separated by grid
// barriers of a cooperative launch whose grid is sized from the
// occupancy API, so every CTA is resident:
//   1. frontier and visited copied root-interleaved, (n_words, B), and
//      per contiguous chunk of groups one
//      root-mask word per (group, 32 roots), one warp reading a group's
//      slab_rows once for 32 roots (`bfs::group_roots`), with per-root
//      and "any root" counts per CTA — the union planner's launch 1;
//   2. the ascending union of the listed groups, its count and each
//      root's n_active — its launch 2;
//   3. one CTA per union group for every root of its mask
//      (`bfs::sell_group_union`): each lane reads its row and its 8
//      columns once (from a cp.async ring of cols and slab_rows at
//      depth > 0), and the roots whose owner side passes run inside
//      the neighbour loop, so a random neighbour's words serve them
//      all (K12's loop order); bottom-up a root stops at the row's
//      first frontier neighbour, which P names;
//   4. restoration of P, `out` written back to rows from the
//      interleaved discoveries with the delta ORed in.
//
// What bounds it on this card: bytes, in practice the latency of the
// random neighbour words of phase 3.  Each input once: every slab's row
// ids (the plan), the planning words, the union's cols, one P word per
// discovery, P read and written by restoration ((4 + 4) * B * V_pad
// bytes), `out` written.  The per-root design it replaces read a
// group's cols and slab_rows once per root that listed it, and each
// root fetched a random neighbour's sector again.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "union_phases.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(bfs::kThreads) sell_layer_fused_kernel(
    bfs::SellGraph g, const unsigned* frontier, const unsigned* visited,
    int* p, bfs::UnionBuffers buf, int n_batch, int bottom_up, int depth) {
  extern __shared__ __align__(16) int ring[];
  cg::grid_group grid = cg::this_grid();
  const bool bu = bottom_up != 0;
  const int n_mask_words = (n_batch + 31) >> 5;

  // 1. state, root masks, per-CTA counts
  bfs::stage_state(frontier, visited, buf, n_batch, g.n_words);
  int begin, end;
  bfs::chunk_of_cta(g.n_steps, &begin, &end);
  bfs::union_masks_sell<false>(g, bu ? visited : frontier, bu, n_batch,
                               nullptr, buf.rmask, begin, end);
  bfs::union_counts(buf.rmask, n_mask_words, n_batch, begin, end, buf.cnt);
  grid.sync();
  // 2. the union list, its count, each root's count
  bfs::union_write<true>(buf.rmask, buf.cnt, buf.ulist, buf.ucount, buf.na,
                         g.n_steps, n_batch);
  grid.sync();
  // 3. one CTA per union group for every root of its mask
  bfs::walk_sell(g, buf, p, n_batch, bu, depth, ring);
  grid.sync();
  // 4. restoration
  bfs::restore_union(g, p, buf, n_batch);
}

size_t ring_bytes(int depth, int spp) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * spp *
                         (bfs::kSlabInts + bfs::kSliceC) * sizeof(int)
                   : 0;
}

}  // namespace

// The co-resident grid for `ctas_per_sm` CTAs per SM (fewer if the
// occupancy at this ring is lower).
extern "C" int repro_sell_layer_fused_grid(int depth, int spp,
                                           int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(sell_layer_fused_kernel,
                               ring_bytes(depth, spp), ctas_per_sm, grid);
}

// frontier, visited: (B, n_words) words; p: (B, v_pad) int32, restored
// in place.  out (B, n_words), rmask (n_steps, ceil(B / 32)), ulist
// (n_steps,), ucount (1,), cnt (B + 1, grid) and na (B,) are written;
// fi, vi, oi ((n_words, B) each) are scratch.  `grid` must come from
// repro_sell_layer_fused_grid with the same depth and spp.
extern "C" int repro_sell_layer_fused(
    const void* cols, const void* slab_rows, const void* frontier,
    const void* visited, void* p, void* out, void* rmask, void* ulist,
    void* ucount, void* cnt, void* na, void* fi, void* vi, void* oi,
    int n_batch, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int bottom_up, int depth, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::SellGraph g{static_cast<const int*>(cols),
                   static_cast<const int*>(slab_rows),
                   nullptr,
                   n_steps, spp, n_words, v_pad, n_vertices};
  bfs::UnionBuffers buf{
      static_cast<unsigned*>(out), static_cast<unsigned*>(rmask),
      static_cast<int*>(ulist),    static_cast<int*>(ucount),
      static_cast<int*>(cnt),      static_cast<int*>(na),
      static_cast<unsigned*>(fi),  static_cast<unsigned*>(vi),
      static_cast<unsigned*>(oi)};
  const unsigned* fr = static_cast<const unsigned*>(frontier);
  const unsigned* vis = static_cast<const unsigned*>(visited);
  int* pp = static_cast<int*>(p);
  void* args[] = {&g, &fr, &vis, &pp, &buf, &n_batch, &bottom_up, &depth};
  return bfs::launch_cooperative(sell_layer_fused_kernel, grid,
                                 ring_bytes(depth, spp), stream, args);
}
