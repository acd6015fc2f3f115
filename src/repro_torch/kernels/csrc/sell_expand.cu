// K8: the SELL-C-σ slab sweep over work-listed slab groups, for Hopper.
//
// Replaces: src/repro/kernels/sell_expand.py, `sell_expand_batched`
// (Pallas bodies `_sell_batched_kernel` over `_sell_tile` at
// prefetch_depth = 0 — the BlockSpec arm — and `_sell_dma_batched_kernel`
// + `_sell_dma_pipeline` at prefetch_depth > 0 — the DMA arm) and, at
// B = 1, `sell_expand` (`_sell_kernel`, `_sell_dma_kernel`).
//
// What it computes, per root b and each of its first n_active[b]
// work-list groups g = wl[b, t] (slabs g * spp ... g * spp + spp - 1):
// every lane whose gate side is in the frontier and whose discovered
// side is in neither visited nor out, neither being the sentinel V,
// writes P[disc] = gate - |V| and ORs disc's bit into `out`.  Top-down
// the gate is the row and the neighbours are discovered; bottom-up the
// row is discovered, gated on a neighbour (sell_phases.cuh:
// sell_group).  `out` and P are updated in place; restoration (K1)
// makes the result exact.
//
// The `out` update is the paper's non-atomic read-OR-write, as in K3:
// lanes of one slab share `out` words (bottom-up all 8 columns of a
// lane target the row's word; top-down neighbours collide across
// slabs and CTAs), so bits can be dropped, and every passing lane's P
// mark lets restoration repair them.  After restoration `out`,
// `visited` and the marked set are the reference's exactly; which
// parent survives differs.
//
// What bounds it on this card: bytes.  An active group moves its cols
// (spp * 4 KB) and slab_rows (spp * 512 B), coalesced: a warp's 32
// lanes read 128 contiguous bytes per column.  Per lane one frontier
// word, and per passing column a visited and an out word (bitmaps are
// 0.5 MB per root, L2-resident), plus 4 bytes of P per discovery.  The
// grid is (CTAs, B); CTAs stride over each root's work-list, reading
// n_active on the device, so a root with an empty list costs one load.
//
// Depth > 0 (the DMA arm): each CTA keeps the cols and slab_rows of
// its next `depth` groups in flight with cp.async into its own
// (depth + 1)-slot ring of shared memory (`bfs::sweep_items`), the
// TPU kernel's make_async_copy pipeline over both arrays.  Only
// entries below n_active are copied.  A ring above 48 KB needs the
// opt-in attribute, set here before the launch.
#include <cuda_runtime.h>

#include "sell_phases.cuh"

namespace {

__global__ void __launch_bounds__(bfs::kThreads) sell_expand_kernel(
    const int* __restrict__ wl, const int* __restrict__ na,
    bfs::SellGraph g, const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    int bottom_up, int depth) {
  extern __shared__ __align__(16) int ring[];
  const int b = blockIdx.y;
  const bfs::WorkItems items{wl, na, g.n_steps, b + 1};
  bfs::sell_sweep(g, items, b, frontier, visited, out, p, bottom_up != 0,
                  depth, ring);
}

}  // namespace

// wl: (B, n_steps) int32; na: (B,) int32; cols: (n_steps * spp, 8, 128)
// int32; slab_rows: (n_steps * spp, 128) int32; frontier, visited, out:
// (B, n_words) 32-bit words; p: (B, v_pad) int32.  out and p are
// updated in place.  depth > 0 uses (depth + 1) * spp * 1152 * 4 bytes
// of dynamic shared memory per CTA.
extern "C" int repro_sell_expand(
    const void* wl, const void* na, const void* cols, const void* slab_rows,
    const void* frontier, const void* visited, void* out, void* p,
    int n_batch, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int bottom_up, int depth, int grid_x, void* stream) {
  if (n_batch == 0 || n_steps == 0 || grid_x <= 0) return 0;
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
  const bfs::SellGraph g{static_cast<const int*>(cols),
                         static_cast<const int*>(slab_rows),
                         nullptr,
                         n_steps, spp, n_words, v_pad, n_vertices};
  dim3 grid(grid_x, n_batch);
  sell_expand_kernel<<<grid, bfs::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wl), static_cast<const int*>(na), g,
      static_cast<const unsigned*>(frontier),
      static_cast<const unsigned*>(visited), static_cast<unsigned*>(out),
      static_cast<int*>(p), bottom_up, depth);
  return static_cast<int>(cudaGetLastError());
}
