// K9: one SELL-C-σ BFS layer of a root batch in ONE cooperative launch,
// for Hopper.
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
// last step.  Here the four phases (plan count, plan write, sweep,
// restore; sell_phases.cuh and fused_phases.cuh) are separated by grid
// barriers of a cooperative launch whose grid is sized from the
// occupancy API, so every CTA is resident.  The plan reads each
// group's slab_rows once for all roots (32 roots per mask word, kept in
// `gmask`); the work-lists and counts are scratch the wrapper
// allocates.
//
// What bounds it on this card: the sweep, as K8 (bytes: the active
// groups' cols and slab_rows per root), plus one pass over slab_rows
// for the plan (n_slabs * 512 B) and one over P for restoration
// ((4 + 4) * B * V_pad bytes).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sell_phases.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(bfs::kThreads) sell_layer_fused_kernel(
    bfs::SellGraph g, const unsigned* frontier, const unsigned* visited,
    int* p, bfs::LayerBuffers buf, unsigned* gmask, int n_batch,
    int bottom_up, int depth) {
  extern __shared__ __align__(16) int ring[];
  cg::grid_group grid = cg::this_grid();
  const unsigned* plan_words = bottom_up ? visited : frontier;
  const long long n_out = static_cast<long long>(n_batch) * g.n_words;
  for (long long i = grid.thread_rank(); i < n_out; i += grid.size())
    buf.out[i] = 0u;
  bfs::sell_plan_count<true>(g, plan_words, bottom_up != 0, n_batch, gmask,
                             buf.cnt);
  grid.sync();
  bfs::sell_plan_write(g, n_batch, gmask, buf);
  grid.sync();
  bfs::sell_gather(g, frontier, visited, p, buf, n_batch, bottom_up != 0,
                   depth, ring);
  grid.sync();
  bfs::restore(g, p, buf.out, n_batch);
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
// in place.  out (B, n_words), wl (B, n_steps), cnt (B, grid), na (B,)
// and gmask (n_steps * ceil(B / 32)) are written.  `grid` must come
// from repro_sell_layer_fused_grid with the same depth and spp.
extern "C" int repro_sell_layer_fused(
    const void* cols, const void* slab_rows, const void* frontier,
    const void* visited, void* p, void* out, void* wl, void* cnt, void* na,
    void* gmask, int n_batch, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int bottom_up, int depth, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::SellGraph g{static_cast<const int*>(cols),
                   static_cast<const int*>(slab_rows),
                   nullptr,
                   n_steps, spp, n_words, v_pad, n_vertices};
  bfs::LayerBuffers buf{static_cast<unsigned*>(out), static_cast<int*>(wl),
                        static_cast<int*>(cnt), static_cast<int*>(na)};
  const unsigned* fr = static_cast<const unsigned*>(frontier);
  const unsigned* vis = static_cast<const unsigned*>(visited);
  int* pp = static_cast<int*>(p);
  unsigned* gm = static_cast<unsigned*>(gmask);
  void* args[] = {&g, &fr, &vis, &pp, &buf, &gm, &n_batch, &bottom_up,
                  &depth};
  return bfs::launch_cooperative(sell_layer_fused_kernel, grid,
                                 ring_bytes(depth, spp), stream, args);
}
