// K5: one BFS layer of a root batch in ONE cooperative launch, for
// Hopper, walking the union of the roots' work-lists.
//
// Replaces: src/repro/kernels/layer_fused.py, `layer_fused_batched`
// (Pallas body `_layer_batched_kernel`: `_plan_in_kernel`, the
// `_dma_pipeline` gather over `_gather_tile`, `_restore_in_kernel`) and,
// at B = 1, `layer_fused` (`_layer_kernel`).
//
// What it computes, per root b: the rows-blocks covered by the
// adjacency of the active vertices (the frontier top-down, the
// unvisited set bottom-up) -> their count n_active[b]; the gather-expand
// of those blocks (K3's function) into a zeroed `out` and, in place, P;
// then restoration, so the returned `out` already holds every
// discovered vertex and P is non-negative.  The engine ORs `out` into
// visited.
//
// The TPU kernel runs its grid in order, so it plans at step 0, sweeps
// and restores at the last step.  Here four phases (union_phases.cuh)
// are separated by grid-wide barriers of a cooperative launch, whose
// grid is sized from the occupancy API so that every CTA is resident:
//   1. frontier and visited copied root-interleaved, (n_words, B), so
//      that the B words of one vertex share a sector, and per
//      contiguous chunk of blocks one
//      root-mask word per (block, 32 roots) from `bfs::covered`,
//      evaluated once per (block, root), with per-root and "any root"
//      counts per CTA — the union planner's launch 1;
//   2. the ascending union of the covered blocks, its count and each
//      root's n_active, by a block scan over the counts — its launch 2;
//   3. one CTA per union block for every root of its mask: the block's
//      rows read once (from a cp.async ring at depth > 0), its owners
//      found once by a shared-memory scan of colstarts
//      (`bfs::owners_by_scan`), then K3's racy expand per root
//      (`bfs::expand_roots`, reading the state written in phase 1);
//   4. restoration of P, `out` written back to rows from the
//      interleaved discoveries with the delta ORed in.
// Nothing leaves the launch between phases except through device
// memory: masks, list, counts and the interleaved copies are scratch
// the wrapper allocates.
//
// What bounds it on this card: bytes, in practice the latency of the
// random per-root bitmap loads of phase 3.  Each input once: the owner
// ids and the planning words (phase 1), the union's rows and the
// colstarts entries their owners span, one P word per discovery, P read
// and written by restoration ((4 + 4) * B * V_pad bytes), `out` written;
// the interleaved copies are scratch, not counted.
// The per-root design it replaces fetched a block's rows, and searched
// each slot's owner, once per root that listed it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "union_phases.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(bfs::kThreads)
    layer_fused_kernel(bfs::FusedGraph g, const unsigned* frontier,
                       const unsigned* visited, int* p,
                       bfs::UnionBuffers buf, int n_batch, int bottom_up,
                       int depth, int sub) {
  extern __shared__ __align__(16) int smem[];
  int* own = smem + (depth > 0 ? (depth + 1) * g.tile : 0);
  cg::grid_group grid = cg::this_grid();
  const bool bu = bottom_up != 0;
  const int n_mask_words = (n_batch + 31) >> 5;

  // 1. state, root masks, per-CTA counts
  bfs::stage_state(frontier, visited, buf, n_batch, g.n_words);
  int begin, end;
  bfs::chunk_of_cta(g.n_blocks, &begin, &end);
  bfs::union_masks_csr<false>(g, bu ? visited : frontier, bu, n_batch,
                              nullptr, buf.rmask, begin, end);
  bfs::union_counts(buf.rmask, n_mask_words, n_batch, begin, end, buf.cnt);
  grid.sync();
  // 2. the union list, its count, each root's count
  bfs::union_write<true>(buf.rmask, buf.cnt, buf.ulist, buf.ucount, buf.na,
                         g.n_blocks, n_batch);
  grid.sync();
  // 3. one CTA per union block for every root of its mask
  bfs::walk_csr(g, buf, p, n_batch, bu, depth, sub, smem, own);
  grid.sync();
  // 4. restoration
  bfs::restore_union(g, p, buf, n_batch);
}

// Dynamic shared memory: the rows ring at depth > 0, then `sub` owners.
size_t smem_bytes(int depth, int tile, int sub) {
  const size_t ring =
      depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int) : 0;
  return ring + static_cast<size_t>(sub) * sizeof(int);
}

}  // namespace

// The co-resident grid for `ctas_per_sm` CTAs per SM (fewer if the
// occupancy of this kernel at that shared memory is lower); 0 CTAs or
// no cooperative launch on the device is an error.
extern "C" int repro_layer_fused_grid(int depth, int tile, int sub,
                                      int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(layer_fused_kernel,
                               smem_bytes(depth, tile, sub), ctas_per_sm,
                               grid);
}

// frontier, visited: (B, n_words) words; p: (B, v_pad) int32, updated in
// place (restored).  out (B, n_words), rmask (n_blocks, ceil(B / 32)),
// ulist (n_blocks,), ucount (1,), cnt (B + 1, grid) and na (B,) are
// written; fi, vi, oi ((n_words, B) each) are scratch.  `sub` (<= tile)
// owner slots per scan; `grid` must come from repro_layer_fused_grid
// with the same depth, tile and sub.
extern "C" int repro_layer_fused(
    const void* rows, const void* cs, const void* blk_lo, const void* blk_hi,
    const void* nz, const void* frontier, const void* visited, void* p,
    void* out, void* rmask, void* ulist, void* ucount, void* cnt, void* na,
    void* fi, void* vi, void* oi, int n_batch, int n_blocks, int tile,
    int n_cs, int n_words, int v_pad, int n_vertices, int bottom_up,
    int depth, int sub, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::FusedGraph g{static_cast<const int*>(rows),
                    static_cast<const int*>(cs),
                    static_cast<const int*>(blk_lo),
                    static_cast<const int*>(blk_hi),
                    static_cast<const unsigned*>(nz),
                    nullptr,
                    n_blocks, tile, n_cs, n_words, v_pad, n_vertices};
  bfs::UnionBuffers buf{
      static_cast<unsigned*>(out), static_cast<unsigned*>(rmask),
      static_cast<int*>(ulist),    static_cast<int*>(ucount),
      static_cast<int*>(cnt),      static_cast<int*>(na),
      static_cast<unsigned*>(fi),  static_cast<unsigned*>(vi),
      static_cast<unsigned*>(oi)};
  const unsigned* fr = static_cast<const unsigned*>(frontier);
  const unsigned* vis = static_cast<const unsigned*>(visited);
  int* pp = static_cast<int*>(p);
  void* args[] = {&g, &fr, &vis, &pp, &buf, &n_batch, &bottom_up, &depth,
                  &sub};
  return bfs::launch_cooperative(layer_fused_kernel, grid,
                                 smem_bytes(depth, tile, sub), stream, args);
}
