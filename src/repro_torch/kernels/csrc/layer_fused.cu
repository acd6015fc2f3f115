// K5: one BFS layer of a root batch in ONE cooperative launch, for
// Hopper.
//
// Replaces: src/repro/kernels/layer_fused.py, `layer_fused_batched`
// (Pallas body `_layer_batched_kernel`: `_plan_in_kernel`, the
// `_dma_pipeline` gather over `_gather_tile`, `_restore_in_kernel`) and,
// at B = 1, `layer_fused` (`_layer_kernel`).
//
// What it computes, per root b: the rows-blocks covered by the
// adjacency of the active vertices (the frontier top-down, the
// unvisited set bottom-up) -> their count n_active[b]; the gather-expand
// of those blocks (K3's body) into a zeroed `out` and, in place, P; then
// restoration, so the returned `out` already holds every discovered
// vertex and P is non-negative.  The engine ORs `out` into visited.
//
// The TPU kernel runs its grid in order, so it plans at step 0, sweeps
// and restores at the last step.  Here the four phases (plan count,
// plan write, gather, restore; fused_phases.cuh) are separated by
// grid-wide barriers of a cooperative launch, whose grid is sized from
// the occupancy API so that every CTA is resident.  Nothing leaves the
// launch between phases except through device memory: the work-lists
// and counts are scratch the wrapper allocates.
//
// What bounds it on this card: the gather, as K3 (bytes, in practice
// dependent-load latency).  The plan reads two owner ids per block and
// a few bitmap words; restoration reads and writes P once, (4 + 4) *
// B * V_pad bytes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fused_phases.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(bfs::kThreads)
    layer_fused_kernel(bfs::FusedGraph g, const unsigned* frontier,
                       const unsigned* visited, int* p,
                       bfs::LayerBuffers buf, int n_batch, int bottom_up,
                       int depth) {
  extern __shared__ __align__(16) int stage[];
  cg::grid_group grid = cg::this_grid();
  const unsigned* plan_words = bottom_up ? visited : frontier;
  const long long n_out = static_cast<long long>(n_batch) * g.n_words;
  for (long long i = grid.thread_rank(); i < n_out; i += grid.size())
    buf.out[i] = 0u;
  bfs::plan_count(g, plan_words, bottom_up != 0, n_batch, buf.cnt);
  grid.sync();
  bfs::plan_write(g, plan_words, bottom_up != 0, n_batch, buf);
  grid.sync();
  bfs::gather(g, frontier, visited, p, buf, n_batch, bottom_up != 0, false,
              depth, stage);
  grid.sync();
  bfs::restore(g, p, buf.out, n_batch);
}

size_t stage_bytes(int depth, int tile) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int)
                   : 0;
}

}  // namespace

// The co-resident grid for `ctas_per_sm` CTAs per SM (fewer if the
// occupancy of this kernel at that shared memory is lower); 0 CTAs or
// no cooperative launch on the device is an error.
extern "C" int repro_layer_fused_grid(int depth, int tile, int ctas_per_sm,
                                      int* grid) {
  return bfs::cooperative_grid(layer_fused_kernel, stage_bytes(depth, tile),
                               ctas_per_sm, grid);
}

// frontier, visited: (B, n_words) words; p: (B, v_pad) int32, updated in
// place (restored).  out (B, n_words), wl (B, n_blocks), cnt (B, grid)
// and na (B,) are written.  `grid` must come from
// repro_layer_fused_grid with the same depth and tile.
extern "C" int repro_layer_fused(
    const void* rows, const void* cs, const void* blk_lo, const void* blk_hi,
    const void* nz, const void* frontier, const void* visited, void* p,
    void* out, void* wl, void* cnt, void* na, int n_batch, int n_blocks,
    int tile, int n_cs, int n_words, int v_pad, int n_vertices,
    int bottom_up, int depth, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::FusedGraph g{static_cast<const int*>(rows),
                    static_cast<const int*>(cs),
                    static_cast<const int*>(blk_lo),
                    static_cast<const int*>(blk_hi),
                    static_cast<const unsigned*>(nz),
                    nullptr,
                    n_blocks, tile, n_cs, n_words, v_pad, n_vertices};
  bfs::LayerBuffers buf{static_cast<unsigned*>(out), static_cast<int*>(wl),
                        static_cast<int*>(cnt), static_cast<int*>(na)};
  const unsigned* fr = static_cast<const unsigned*>(frontier);
  const unsigned* vis = static_cast<const unsigned*>(visited);
  int* pp = static_cast<int*>(p);
  void* args[] = {&g, &fr, &vis, &pp, &buf, &n_batch, &bottom_up, &depth};
  return bfs::launch_cooperative(layer_fused_kernel, grid,
                                 stage_bytes(depth, tile), stream, args);
}
