// K10: a whole multi-root BFS traversal over SELL-C-σ slabs in ONE
// cooperative launch, for Hopper, each layer walking the union of the
// roots' work-lists.
//
// Replaces: src/repro/kernels/traversal_fused.py,
// `sell_traversal_fused_batched` (Pallas body `_sell_traversal_kernel`:
// `_init_state`, `_persistent_layer_loop` with `_layer_counters` and
// `_decide`, `_plan_slabs_in_kernel` and the `_sell_tile_dyn` sweep).
//
// What it computes: K6's in-kernel layer loop (traversal_loop.cuh) whose
// layers are K9's phases (union_phases.cuh): the union of the roots'
// slab-group lists planned in the launch (`union_masks_sell`: one warp
// reads a group's slab_rows once for 32 roots, through L2, since the
// loop rewrites the planning words; `union_write`), one CTA per union
// group for every root of its mask (`walk_sell`: each lane's row and 8
// neighbours read once, the live roots inside the neighbour loop, so a
// random neighbour's words serve them all), and restoration with the
// next layer's counters in one pass.  The Table 1 counters come from
// the padded degree array, SELL having no colstarts.  SELL runs the SIMD
// algorithm only, so every mode is the slab sweep with the accumulating
// `visited | out` test; a scalar-mode layer is the top-down sweep (the
// reference's `_sell_tile_dyn` has no scalar blend).
//
// What bounds it on this card: bytes, in practice the latency of the
// random neighbour words of the walks, as K9; plus per layer one pass
// over slab_rows and the planning words (the plan), over P (restoration,
// where a word has discoveries) and over the degrees (counters).  The
// per-root design it replaces read a group's cols and slab_rows once per
// root that listed it, and each root fetched a random neighbour's sector
// again.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "traversal_loop.cuh"

namespace {

// K9's planning and walk as the loop's layer.
struct SellLayer {
  bfs::SellGraph g;

  __device__ int n_items() const { return g.n_steps; }
  __device__ void masks(const unsigned* words, bool complement, int n_batch,
                        unsigned* rmask, int begin, int end) const {
    bfs::union_masks_sell<false, true>(g, words, complement, n_batch,
                                       nullptr, rmask, begin, end);
  }
  template <bool kTraced>
  __device__ void walk(const bfs::UnionBuffers& buf, int* p, int n_batch,
                       bool bottom_up, bool, int depth, int* ring,
                       unsigned long long*) const {
    bfs::walk_sell(g, buf, p, n_batch, bottom_up, depth, ring);
  }
};

// At least kTraversalCtas resident CTAs per SM, as K6 (traversal_fused.cu).
// kTraced: the phase-traced build of the loop (traversal_loop.cuh).
template <bool kTraced>
__global__ void __launch_bounds__(bfs::kThreads, bfs::kTraversalCtas)
    sell_traversal_fused_kernel(SellLayer layer, bfs::Traversal t,
                                bfs::UnionBuffers buf, bfs::Policy pol) {
  extern __shared__ __align__(16) int ring[];
  bfs::traversal_loop<kTraced>(layer, t, buf, pol, ring);
}

size_t ring_bytes(int depth, int spp) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * spp *
                         (bfs::kSlabInts + bfs::kSliceC) * sizeof(int)
                   : 0;
}

}  // namespace

extern "C" int repro_sell_traversal_fused_grid(int depth, int spp,
                                               int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(sell_traversal_fused_kernel<false>,
                               ring_bytes(depth, spp), ctas_per_sm, grid);
}

// cols (n_steps * spp, 8, 128), slab_rows (n_steps * spp, 128) and deg
// (v_pad,) int32 (deg 16-byte aligned); f0, vis0: (B, n_words) words and
// p0: (B, v_pad) int32 (16-byte aligned), read only.  frontier, visited,
// p, depths (B,), layers (1,), stats (max_layers, 8) are the outputs;
// rmask (n_steps, ceil(B / 32)), ulist (n_steps,), ucount (1,), cnt
// (B + 1, grid), na (B,), fi, vi, oi ((n_words, B) each) and acc
// ((max_layers + 1) * B * 4 uint64) are scratch.  simd_layer:
// (max_layers,) int32 (PaperLiteralLayers).  stamps and waits: the phase
// tracing of traversal_loop.cuh (as K6's): the traced kernel runs where
// either is set.
extern "C" int repro_sell_traversal_fused(
    const void* cols, const void* slab_rows, const void* deg, const void* f0,
    const void* vis0, const void* p0, void* frontier, void* visited, void* p,
    void* rmask, void* ulist, void* ucount, void* cnt, void* na, void* fi,
    void* vi, void* oi, void* acc, void* depths, void* layers, void* stats,
    const void* simd_layer, void* stamps, void* waits, int n_batch,
    int n_steps, int spp, int n_words, int v_pad, int n_vertices, int depth,
    int max_layers, int kind, float alpha, float v_over_beta,
    float threshold, int grid, void* stream) {
  if (n_batch == 0) return 0;
  const bfs::SellGraph g{static_cast<const int*>(cols),
                         static_cast<const int*>(slab_rows),
                         static_cast<const int*>(deg),
                         n_steps, spp, n_words, v_pad, n_vertices};
  bfs::Traversal t{static_cast<const unsigned*>(f0),
                   static_cast<const unsigned*>(vis0),
                   static_cast<const int*>(p0),
                   static_cast<unsigned*>(frontier),
                   static_cast<unsigned*>(visited),
                   static_cast<int*>(p),
                   static_cast<unsigned long long*>(acc),
                   static_cast<int*>(depths),
                   static_cast<int*>(layers),
                   static_cast<int*>(stats),
                   static_cast<long long*>(stamps),
                   static_cast<unsigned long long*>(waits),
                   n_batch, max_layers, depth};
  bfs::UnionBuffers buf{
      nullptr,                     static_cast<unsigned*>(rmask),
      static_cast<int*>(ulist),    static_cast<int*>(ucount),
      static_cast<int*>(cnt),      static_cast<int*>(na),
      static_cast<unsigned*>(fi),  static_cast<unsigned*>(vi),
      static_cast<unsigned*>(oi)};
  bfs::Policy pol{kind, alpha, v_over_beta, threshold,
                  static_cast<const int*>(simd_layer)};
  SellLayer layer{g};
  void* args[] = {&layer, &t, &buf, &pol};
  return bfs::launch_traversal(sell_traversal_fused_kernel<false>,
                               sell_traversal_fused_kernel<true>, t, grid,
                               ring_bytes(depth, spp), stream, args);
}
