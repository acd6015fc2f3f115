// K10: a whole multi-root BFS traversal over SELL-C-σ slabs in ONE
// cooperative launch, for Hopper.
//
// Replaces: src/repro/kernels/traversal_fused.py,
// `sell_traversal_fused_batched` (Pallas body `_sell_traversal_kernel`:
// `_init_state`, `_persistent_layer_loop` with `_layer_counters` and
// `_decide`, `_plan_slabs_in_kernel` and the `_sell_tile_dyn` sweep).
//
// What it computes: K6's in-kernel layer loop (traversal_loop.cuh) with
// the per-root slab phases (sell_phases.cuh) as the layer's sweep: the
// slab plan of the frontier (or, bottom-up, of the unvisited set), the
// slab sweep with the layer's direction, restoration.  The Table 1
// counters come from the padded degree array, SELL having no
// colstarts.  SELL runs the SIMD algorithm only, so every mode is the
// slab sweep with the accumulating `visited | out` test; a scalar-mode
// layer is the top-down sweep (the reference's `_sell_tile_dyn` has no
// scalar blend).
//
// Every read of state rewritten between layers (frontier, visited, P,
// out, the work-lists, counts and root masks) is ld.global.cg.
//
// What bounds it on this card: the sweeps, as K8; plus per layer one
// pass over slab_rows (the plan), over P (restoration) and over the
// bitmaps and degrees (counters).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sell_phases.cuh"
#include "traversal_loop.cuh"

namespace {

// The per-root slab phases as the loop's layer sweep.
struct SellLayer {
  bfs::SellGraph g;
  unsigned* gmask;       // (n_steps, ceil(B / 32)) root masks

  __device__ void plan_count(const unsigned* words, bool complement,
                             int n_batch,
                             const bfs::LayerBuffers& buf) const {
    bfs::sell_plan_count<true>(g, words, complement, n_batch, gmask,
                               buf.cnt);
  }
  __device__ void plan_write(const unsigned*, bool, int n_batch,
                             const bfs::LayerBuffers& buf) const {
    bfs::sell_plan_write(g, n_batch, gmask, buf);
  }
  __device__ void gather(const unsigned* frontier, const unsigned* visited,
                         int* p, const bfs::LayerBuffers& buf, int n_batch,
                         bool bottom_up, bool, int depth, int* ring) const {
    bfs::sell_gather(g, frontier, visited, p, buf, n_batch, bottom_up,
                     depth, ring);
  }
};

__global__ void __launch_bounds__(bfs::kThreads)
    sell_traversal_fused_kernel(SellLayer layer, bfs::Traversal t,
                                bfs::LayerBuffers buf, bfs::Policy pol) {
  extern __shared__ __align__(16) int ring[];
  bfs::traversal_loop(layer, t, buf, pol, ring);
}

size_t ring_bytes(int depth, int spp) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * spp *
                         (bfs::kSlabInts + bfs::kSliceC) * sizeof(int)
                   : 0;
}

}  // namespace

extern "C" int repro_sell_traversal_fused_grid(int depth, int spp,
                                               int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(sell_traversal_fused_kernel,
                               ring_bytes(depth, spp), ctas_per_sm, grid);
}

// cols (n_steps * spp, 8, 128), slab_rows (n_steps * spp, 128) and deg
// (v_pad,) int32; f0, vis0: (B, n_words) words and p0: (B, v_pad)
// int32, read only.  frontier, visited, p, depths (B,), layers (1,),
// stats (max_layers, 8) are the outputs; out (B, n_words), wl
// (B, n_steps), cnt (B, grid), na (B,), gmask (n_steps * ceil(B / 32))
// and acc ((max_layers + 1) * B * 4 uint64) are scratch.  simd_layer:
// (max_layers,) int32 (PaperLiteralLayers).
extern "C" int repro_sell_traversal_fused(
    const void* cols, const void* slab_rows, const void* deg, const void* f0,
    const void* vis0, const void* p0, void* frontier, void* visited, void* p,
    void* out, void* wl, void* cnt, void* na, void* gmask, void* acc,
    void* depths, void* layers, void* stats, const void* simd_layer,
    int n_batch, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int depth, int max_layers, int kind, float alpha,
    float v_over_beta, float threshold, int grid, void* stream) {
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
                   n_batch, max_layers, depth};
  bfs::LayerBuffers buf{static_cast<unsigned*>(out), static_cast<int*>(wl),
                        static_cast<int*>(cnt), static_cast<int*>(na)};
  bfs::Policy pol{kind, alpha, v_over_beta, threshold,
                  static_cast<const int*>(simd_layer)};
  SellLayer layer{g, static_cast<unsigned*>(gmask)};
  void* args[] = {&layer, &t, &buf, &pol};
  return bfs::launch_cooperative(sell_traversal_fused_kernel, grid,
                                 ring_bytes(depth, spp), stream, args);
}
