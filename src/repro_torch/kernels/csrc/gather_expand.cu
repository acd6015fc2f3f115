// K3 and K4: fused work-listed CSR gather + racy expand for Hopper.
//
// Replaces: src/repro/kernels/gather_expand.py, `gather_expand_batched`
// (Pallas bodies `_gather_batched_kernel` at prefetch_depth = 0 — K3 —
// and `_gather_dma_batched_kernel` + `_dma_pipeline` at
// prefetch_depth > 0 — K4) and, at B = 1, `gather_expand`
// (`_gather_kernel`, `_gather_dma_kernel`).
//
// What it computes, per root b and each of its first n_active[b]
// work-list entries blk = wl[b, t]: for every edge slot
// e in [blk * tile, (blk + 1) * tile) of the tile-padded `rows`, the
// owner u (largest u with colstarts[u] <= e) and the neighbour
// v = rows[e].  Top-down gates on "u in frontier" and discovers v;
// bottom-up swaps the roles (the planner listed the blocks of the
// unvisited vertices' adjacency).  A discovered vertex c with gate
// vertex g gets P[c] = g - |V| and its bit ORed into `out`.  `out` and
// P are updated in place.
//
// The `out` update is the paper's non-atomic read-OR-write (§3.3.2,
// Fig. 6): the word read for the "already discovered" test is ORed with
// the bit and stored back with a plain store, so two lanes that hit one
// word can drop each other's bits.  The restoration kernel (K1) repairs
// that from the negative P marks: every lane that passes the mask
// writes its P mark, and a stored word only ever holds marked bits.
// The reference's "tile t+1 observes tile t" order has no counterpart
// here (CTAs run in no order), so more vertices are discovered twice
// and the surviving parent differs; after restoration `out`, `visited`
// and the set of marked vertices are the reference's exactly.
//
// What bounds it on this card: bytes, and in practice the latency of
// dependent loads.  Each active block moves tile * 4 bytes of `rows`
// (coalesced), the colstarts entries its owners span, and one 4-byte
// bitmap word gather per edge for the gate, the visited and the out
// test; plus 4 bytes of P per discovery.  colstarts (16.8 MB at
// SCALE 22) and the bitmaps (0.5 MB per root) stay in the 50 MB L2.
// Design against the latency: thread 0 of the CTA finds the block's
// first and last owner by a binary search over all of colstarts, once
// per block; every thread then searches only that narrow owner range,
// ~log2(tile / mean degree) dependent loads instead of ~23.  The grid
// is (CTAs, B) with CTAs striding over the work-list, and n_active is
// read on the device, so no host sync is needed and a root with an
// empty work-list costs one load.
//
// K4 (depth > 0) is the same body fed from shared memory: each CTA
// keeps the rows of its next `depth` blocks in flight with cp.async
// into its own (depth + 1)-stage ring (`bfs::sweep`), the TPU kernel's
// make_async_copy pipeline.  Only entries below n_active are copied:
// the reference's clamped work-list tail, which it copies and skips,
// is never visited.  A ring above 48 KB needs the opt-in attribute,
// set here before the launch.
#include <cuda_runtime.h>

#include "bfs_common.cuh"

namespace {

__global__ void __launch_bounds__(bfs::kThreads) gather_expand_kernel(
    const int* __restrict__ wl, const int* __restrict__ na,
    const int* __restrict__ rows, const int* __restrict__ cs,
    const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    int n_blocks, int tile, int n_cs, int n_words, int v_pad,
    int n_vertices, int bottom_up, int depth) {
  extern __shared__ __align__(16) int stage[];
  __shared__ int s_lo, s_hi;
  const int b = blockIdx.y;
  const unsigned* fr = frontier + static_cast<long long>(b) * n_words;
  const unsigned* vis = visited + static_cast<long long>(b) * n_words;
  unsigned* ob = out + static_cast<long long>(b) * n_words;
  int* pb = p + static_cast<long long>(b) * v_pad;
  const bfs::WorkItems items{wl, na, n_blocks, b + 1};
  bfs::sweep(items, b, rows, tile, depth, stage,
             [&](int, int blk, const int* rows_blk) {
               const int e0 = blk * tile;
               if (threadIdx.x == 0) {
                 const int lo = bfs::owner_in(cs, 0, n_cs - 1, e0);
                 s_lo = lo;
                 s_hi = bfs::owner_in(cs, lo, n_cs - 1, e0 + tile - 1);
               }
               __syncthreads();
               bfs::expand_block<false>(rows_blk, cs, e0, tile, s_lo, s_hi,
                                        fr, vis, ob, pb, n_vertices,
                                        bottom_up != 0, false);
             });
}

}  // namespace

// wl: (B, n_blocks) int32; na: (B,) int32; rows: (n_blocks * tile,)
// int32; cs: (n_cs,) int32; frontier, visited, out: (B, n_words)
// 32-bit words; p: (B, v_pad) int32.  out and p are updated in place.
// depth = 0 is K3; depth > 0 is K4 with (depth + 1) * tile * 4 bytes
// of dynamic shared memory per CTA.
extern "C" int repro_gather_expand(
    const void* wl, const void* na, const void* rows, const void* cs,
    const void* frontier, const void* visited, void* out, void* p,
    int n_batch, int n_blocks, int tile, int n_cs, int n_words, int v_pad,
    int n_vertices, int bottom_up, int depth, int grid_x, void* stream) {
  if (n_batch == 0 || n_blocks == 0 || grid_x <= 0) return 0;
  const size_t smem =
      depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gather_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  dim3 grid(grid_x, n_batch);
  gather_expand_kernel<<<grid, bfs::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wl), static_cast<const int*>(na),
      static_cast<const int*>(rows), static_cast<const int*>(cs),
      static_cast<const unsigned*>(frontier),
      static_cast<const unsigned*>(visited), static_cast<unsigned*>(out),
      static_cast<int*>(p), n_blocks, tile, n_cs, n_words, v_pad,
      n_vertices, bottom_up, depth);
  return static_cast<int>(cudaGetLastError());
}
