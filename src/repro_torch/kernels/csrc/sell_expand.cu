// K8: the SELL-C-σ slab sweep for Hopper, one CTA per slab group of the
// union of the batch's work-lists.
//
// Replaces: src/repro/kernels/sell_expand.py, `sell_expand_batched`
// (Pallas bodies `_sell_batched_kernel` over `_sell_tile` at
// prefetch_depth = 0 — the BlockSpec arm — and `_sell_dma_batched_kernel`
// + `_sell_dma_pipeline` at prefetch_depth > 0 — the DMA arm) and, at
// B = 1, `sell_expand` (`_sell_kernel`, `_sell_dma_kernel`).
//
// What it computes, per root b and each slab group g its work-list
// holds (slabs g * spp ... g * spp + spp - 1): every lane whose gate
// side is in the frontier and whose discovered side is in neither
// visited nor out, neither being the sentinel V, writes
// P[disc] = gate - |V| and ORs disc's bit into `out`.  Top-down the
// gate is the row and the neighbours are discovered; bottom-up the row
// is discovered, gated on a neighbour, and a root is done with the row
// at its first frontier neighbour.  `out` and P are updated in place;
// restoration (K1) makes the result exact.
//
// The `out` update is the paper's non-atomic read-OR-write, as in K3:
// lanes of one slab share `out` words (bottom-up all 8 columns of a
// lane target the row's word; top-down neighbours collide across
// slabs and CTAs), so bits can be dropped, and every passing lane's P
// mark lets restoration repair them.  After restoration `out`,
// `visited` and the marked set are the reference's exactly; which
// parent survives differs.
//
// What bounds it on this card: bytes, and in practice the latency of
// the random per-root bitmap words.  The bytes bound counts each listed
// group's cols (spp * 4 KB) and slab_rows (spp * 512 B) once, but the
// roots of a batch list mostly the same groups, and a walk of each
// root's own list (this kernel's first port: a (CTAs, B) grid) read a
// group's slabs once per root that lists it, and each root's bitmap
// words lay a row apart, a sector of their own.
//
// The design, K9's walk without its in-launch planning: the union
// planner (plan_union.cu) lists the groups any root lists (`ulist`,
// with `ucount` read here on the device) and a root mask per group
// (`rmask`); a 1-D grid of resident CTAs (`bfs::resident_grid`) strides
// over that union (`bfs::UnionItems`), and per group every lane reads
// its row and 8 neighbours once and runs the roots of the mask inside
// the neighbour loop (`bfs::sweep_sell` over `bfs::sell_group_union`,
// union_phases.cuh, K9's and K10's body), on root-interleaved bitmaps,
// (n_words, B), which the wrapper hands over, so that a random
// neighbour's sector serves every root.  The masks, the list and the
// bitmaps are inputs that the launch never writes: they are read by
// the non-coherent path.  No grid barrier, so no cooperative launch.
//
// Depth > 0 (the DMA arm): each CTA keeps the cols and slab_rows of its
// next `depth` union groups in flight with cp.async into its own
// (depth + 1)-slot ring of shared memory (`bfs::sweep_items`), the TPU
// kernel's make_async_copy pipeline over both arrays.  A ring above
// 48 KB needs the opt-in attribute, set here before the launch.
#include <cuda_runtime.h>

#include "union_phases.cuh"

namespace {

__global__ void __launch_bounds__(bfs::kThreads) sell_expand_kernel(
    const int* __restrict__ ulist, const int* __restrict__ ucount,
    const unsigned* __restrict__ rmask, bfs::SellGraph g,
    const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    int n_batch, int bottom_up, int depth) {
  extern __shared__ __align__(16) int ring[];
  const bfs::UnionItems items{ulist, __ldg(ucount)};
  bfs::sweep_sell<true>(g, items, rmask, frontier, visited, out, p, n_batch,
                        bottom_up != 0, depth, ring);
}

}  // namespace

// ulist: (n_steps,) int32 union of the groups; ucount: (1,) int32;
// rmask: (n_steps, ceil(B / 32)) 32-bit root masks; cols:
// (n_steps * spp, 8, 128) int32; slab_rows: (n_steps * spp, 128) int32;
// frontier, visited, out: root-interleaved (n_words, B) 32-bit words;
// p: (B, v_pad) int32.  out and p are updated in place.  depth > 0 uses
// (depth + 1) * spp * 1152 * 4 bytes of dynamic shared memory per CTA.
// The grid is the CTAs the card holds at once (at most n_steps), each
// striding over the union.
extern "C" int repro_sell_expand(
    const void* ulist, const void* ucount, const void* rmask,
    const void* cols, const void* slab_rows, const void* frontier,
    const void* visited, void* out, void* p, int n_batch, int n_steps,
    int spp, int n_words, int v_pad, int n_vertices, int bottom_up,
    int depth, void* stream) {
  if (n_batch == 0 || n_steps == 0) return 0;
  const size_t smem =
      depth > 0 ? static_cast<size_t>(depth + 1) * spp *
                      (bfs::kSlabInts + bfs::kSliceC) * sizeof(int)
                : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sell_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int grid = 0;
  const cudaError_t rc =
      bfs::resident_grid(sell_expand_kernel, smem, n_steps, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bfs::SellGraph g{static_cast<const int*>(cols),
                         static_cast<const int*>(slab_rows),
                         nullptr,
                         n_steps, spp, n_words, v_pad, n_vertices};
  sell_expand_kernel<<<grid, bfs::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ulist), static_cast<const int*>(ucount),
      static_cast<const unsigned*>(rmask), g,
      static_cast<const unsigned*>(frontier),
      static_cast<const unsigned*>(visited), static_cast<unsigned*>(out),
      static_cast<int*>(p), n_batch, bottom_up, depth);
  return static_cast<int>(cudaGetLastError());
}
