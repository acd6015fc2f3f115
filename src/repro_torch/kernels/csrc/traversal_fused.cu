// K6: a whole multi-root BFS traversal in ONE cooperative launch, for
// Hopper, each layer walking the union of the roots' work-lists.
//
// Replaces: src/repro/kernels/traversal_fused.py,
// `traversal_fused_batched` (Pallas body `_traversal_kernel`:
// `_init_state`, `_persistent_layer_loop` with `_layer_counters`,
// `_decide` and the `_gather_tile_dyn` sweep).  Its SELL-C-σ twin,
// `sell_traversal_fused_batched`, is K10 (sell_traversal_fused.cu); the
// two share the layer loop of traversal_loop.cuh.
//
// What it computes: the engine's layer loop over a root batch
// (traversal_loop.cuh) whose layers are K5's phases (union_phases.cuh):
// the union of the roots' rows-block lists planned in the launch
// (`union_masks_csr` on `covered`, `union_write`), the union's blocks
// walked for every root of their masks, and at the layer's end
// restoration with the next layer's counters in one pass.  Top-down and
// scalar layers walk slot by slot, a CTA per block (`walk_csr`: the
// block's rows read once, from a cp.async ring at depth > 0, its owners
// found once by a shared-memory scan of colstarts, then K3's racy expand
// per root); a scalar-mode layer tests the pre-layer visited only
// (`_gather_tile_dyn`; `expand_roots`' scalar arm).  Bottom-up layers
// walk vertex by vertex, a warp per block (`walk_csr_bottom_up`): each
// vertex whose list starts in the block is scanned by a lane or a group
// of lanes until every root it is unvisited for has its first frontier
// parent, so most of a block's rows are never read.  The two directions
// want opposite shapes (top-down tests every edge of a frontier vertex;
// bottom-up stops early), and the layer's direction, which the kernel
// decides from its counters, picks the walk.
//
// The TPU kernel keeps the state in VMEM across layers; here it lives in
// device memory (and mostly L2), in rows for the planning and
// root-interleaved for the walk, and the phases are separated by grid
// barriers of a cooperative launch whose grid is sized from the
// occupancy API, so every CTA is resident.
//
// What bounds it on this card: bytes, in practice the latency of the
// random per-root bitmap loads of the walks, as K5; plus per layer one
// pass over the planning words, P (restoration, where a word has
// discoveries) and the degrees (counters).  The per-root design it
// replaces fetched a block's rows, and searched each slot's owner, once
// per root that listed it, and read the state through L2 only.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "traversal_loop.cuh"

namespace {

// K5's planning and walks as the loop's layer.
struct CsrLayer {
  bfs::FusedGraph g;
  int sub;               // owner slots per scan

  __device__ int n_items() const { return g.n_blocks; }
  __device__ void masks(const unsigned* words, bool complement, int n_batch,
                        unsigned* rmask, int begin, int end) const {
    bfs::union_masks_csr<false>(g, words, complement, n_batch, nullptr,
                                rmask, begin, end);
  }
  // Top-down and scalar layers walk slot by slot (`walk_csr`);
  // bottom-up ones vertex by vertex with each root's early exit
  // (`walk_csr_bottom_up`), which leaves the ring and the owner slots
  // idle and keeps its warps' records there.
  template <bool kTraced>
  __device__ void walk(const bfs::UnionBuffers& buf, int* p, int n_batch,
                       bool bottom_up, bool scalar, int depth, int* smem,
                       unsigned long long* walked) const {
    const int ring = depth > 0 ? (depth + 1) * g.tile : 0;
    if (bottom_up) {
      bfs::walk_csr_bottom_up<kTraced>(g, buf, p, n_batch, smem, ring + sub,
                                       walked);
      return;
    }
    bfs::walk_csr<true>(g, buf, p, n_batch, false, depth, sub, smem,
                        smem + ring, scalar);
  }
};

// At least kTraversalCtas resident CTAs per SM: ptxas then keeps to 48
// registers and spills some, and the walks gain more from the resident
// warps than they lose to the spill (`tools/sweep_launch_bounds.py`
// times K6 and K10 at each minimum; PERF.md).
// kTraced: the phase-traced build of the loop (traversal_loop.cuh).
template <bool kTraced>
__global__ void __launch_bounds__(bfs::kThreads, bfs::kTraversalCtas)
    traversal_fused_kernel(CsrLayer layer, bfs::Traversal t,
                           bfs::UnionBuffers buf, bfs::Policy pol) {
  extern __shared__ __align__(16) int smem[];
  bfs::traversal_loop<kTraced>(layer, t, buf, pol, smem);
}

// Dynamic shared memory: the rows ring at depth > 0, then `sub` owners
// (K5's).
size_t smem_bytes(int depth, int tile, int sub) {
  const size_t ring =
      depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int) : 0;
  return ring + static_cast<size_t>(sub) * sizeof(int);
}

}  // namespace

extern "C" int repro_traversal_fused_grid(int depth, int tile, int sub,
                                          int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(traversal_fused_kernel<false>,
                               smem_bytes(depth, tile, sub), ctas_per_sm,
                               grid);
}

// f0, vis0: (B, n_words) words and p0: (B, v_pad) int32 (16-byte
// aligned), read only.  frontier, visited, p, depths (B,), layers (1,),
// stats (max_layers, 8) are the outputs; rmask (n_blocks, ceil(B / 32)),
// ulist (n_blocks,), ucount (1,), cnt (B + 1, grid), na (B,), fi, vi, oi
// ((n_words, B) each) and acc ((max_layers + 1) * B * 4 uint64) are
// scratch.  simd_layer: (max_layers,) int32 (PaperLiteralLayers only;
// may be null for other kinds).  stamps ((3 + 4 max_layers) int64),
// waits ((4 (max_layers + 1) + 2) uint64, zeroed) and walked
// ((2 max_layers) uint64, zeroed: each bottom-up layer's neighbour
// entries tested and slots walked) are the tracing of
// traversal_loop.cuh: the traced kernel runs where any is set.
// `grid` must come from repro_traversal_fused_grid with the same depth,
// tile and sub.
extern "C" int repro_traversal_fused(
    const void* rows, const void* cs, const void* blk_lo, const void* blk_hi,
    const void* nz, const void* deg, const void* f0, const void* vis0,
    const void* p0, void* frontier, void* visited, void* p, void* rmask,
    void* ulist, void* ucount, void* cnt, void* na, void* fi, void* vi,
    void* oi, void* acc, void* depths, void* layers, void* stats,
    const void* simd_layer, void* stamps, void* waits, void* walked,
    int n_batch,
    int n_blocks, int tile, int n_cs, int n_words, int v_pad, int n_vertices,
    int depth, int sub, int max_layers, int kind, float alpha,
    float v_over_beta, float threshold, int grid, void* stream) {
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
                   static_cast<long long*>(stamps),
                   static_cast<unsigned long long*>(waits),
                   n_batch, max_layers, depth,
                   static_cast<unsigned long long*>(walked)};
  bfs::UnionBuffers buf{
      nullptr,                     static_cast<unsigned*>(rmask),
      static_cast<int*>(ulist),    static_cast<int*>(ucount),
      static_cast<int*>(cnt),      static_cast<int*>(na),
      static_cast<unsigned*>(fi),  static_cast<unsigned*>(vi),
      static_cast<unsigned*>(oi)};
  bfs::Policy pol{kind, alpha, v_over_beta, threshold,
                  static_cast<const int*>(simd_layer)};
  CsrLayer layer{g, sub};
  void* args[] = {&layer, &t, &buf, &pol};
  return bfs::launch_traversal(traversal_fused_kernel<false>,
                               traversal_fused_kernel<true>, t, grid,
                               smem_bytes(depth, tile, sub), stream, args);
}
