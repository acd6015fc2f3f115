// K6: a whole multi-root BFS traversal in ONE cooperative launch, for
// Hopper.
//
// Replaces: src/repro/kernels/traversal_fused.py,
// `traversal_fused_batched` (Pallas body `_traversal_kernel`:
// `_init_state`, `_persistent_layer_loop` with `_layer_counters`,
// `_decide` and the `_gather_tile_dyn` sweep).  Its SELL-C-σ twin,
// `sell_traversal_fused_batched`, is K10 (sell_traversal_fused.cu); the
// two share the layer loop of traversal_loop.cuh.
//
// What it computes: the engine's layer loop over a root batch
// (traversal_loop.cuh) with the per-root phases of fused_phases.cuh as
// the layer's sweep: the owner-range plan, the rows-block gather and, at
// the layer's end, restoration; a scalar-mode layer tests the
// pre-layer visited only (`_gather_tile_dyn`).
//
// The TPU kernel keeps the state in VMEM across layers; here it lives in
// device memory (and mostly L2) and the layers' phases are separated by
// grid barriers of a cooperative launch.
//
// What bounds it on this card: the gathers, as K3; plus per layer one
// pass over P (restoration) and over the bitmaps and degrees (counters).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "traversal_loop.cuh"

namespace {

// The per-root phases as the loop's layer sweep.
struct CsrLayer {
  bfs::FusedGraph g;

  __device__ void plan_count(const unsigned* words, bool complement,
                             int n_batch,
                             const bfs::LayerBuffers& buf) const {
    bfs::plan_count(g, words, complement, n_batch, buf.cnt);
  }
  __device__ void plan_write(const unsigned* words, bool complement,
                             int n_batch,
                             const bfs::LayerBuffers& buf) const {
    bfs::plan_write(g, words, complement, n_batch, buf);
  }
  __device__ void gather(const unsigned* frontier, const unsigned* visited,
                         int* p, const bfs::LayerBuffers& buf, int n_batch,
                         bool bottom_up, bool scalar, int depth,
                         int* ring) const {
    bfs::gather(g, frontier, visited, p, buf, n_batch, bottom_up, scalar,
                depth, ring);
  }
};

__global__ void __launch_bounds__(bfs::kThreads)
    traversal_fused_kernel(CsrLayer layer, bfs::Traversal t,
                           bfs::LayerBuffers buf, bfs::Policy pol) {
  extern __shared__ __align__(16) int stage[];
  bfs::traversal_loop(layer, t, buf, pol, stage);
}

size_t stage_bytes(int depth, int tile) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int)
                   : 0;
}

}  // namespace

extern "C" int repro_traversal_fused_grid(int depth, int tile,
                                          int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(traversal_fused_kernel,
                               stage_bytes(depth, tile), ctas_per_sm, grid);
}

// f0, vis0: (B, n_words) words and p0: (B, v_pad) int32, read only.
// frontier, visited, p, depths (B,), layers (1,), stats (max_layers, 8)
// are the outputs; out (B, n_words), wl (B, n_blocks), cnt (B, grid),
// na (B,) and acc ((max_layers + 1) * B * 4 uint64) are scratch.
// simd_layer: (max_layers,) int32 (PaperLiteralLayers only; may be
// null for other kinds).
extern "C" int repro_traversal_fused(
    const void* rows, const void* cs, const void* blk_lo, const void* blk_hi,
    const void* nz, const void* deg, const void* f0, const void* vis0,
    const void* p0, void* frontier, void* visited, void* p, void* out,
    void* wl, void* cnt, void* na, void* acc, void* depths, void* layers,
    void* stats, const void* simd_layer, int n_batch, int n_blocks,
    int tile, int n_cs, int n_words, int v_pad, int n_vertices, int depth,
    int max_layers, int kind, float alpha, float v_over_beta,
    float threshold, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::FusedGraph g{static_cast<const int*>(rows),
                    static_cast<const int*>(cs),
                    static_cast<const int*>(blk_lo),
                    static_cast<const int*>(blk_hi),
                    static_cast<const unsigned*>(nz),
                    static_cast<const int*>(deg),
                    n_blocks, tile, n_cs, n_words, v_pad, n_vertices};
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
  CsrLayer layer{g};
  void* args[] = {&layer, &t, &buf, &pol};
  return bfs::launch_cooperative(traversal_fused_kernel, grid,
                                 stage_bytes(depth, tile), stream, args);
}
