// K3 and K4: fused work-listed CSR gather + racy expand for Hopper, one
// CTA per rows-block of the union of the batch's work-lists.
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
// dependent loads.  The bytes bound counts each listed block's rows and
// colstarts once, but the roots of a batch list mostly the same blocks
// (849,920 listed pairs over 130,536 blocks on the largest SCALE-22
// layer at 8 roots), and a kernel that walks each root's list reads a
// block's rows, and searches its slots' owners, once per root that
// lists it.
//
// The design: the union planner (plan_union.cu) builds the union of the
// lists (`ulist`, the blocks any root lists, with `ucount` read here on
// the device) and a root mask per block (`rmask`, bit b of word b / 32
// set when root b lists it); a 1-D grid strides over the union, so each block's rows
// are read once and its owners found once for all its roots
// (`bfs::owners_by_scan`: one warp-parallel search per end of the
// block, then every owner put in shared memory by a coalesced scan of
// colstarts and a prefix max, instead of ~5 dependent loads per slot
// and root).  Per slot the roots of the mask run the per-root body
// (`bfs::expand_roots`).  The wrapper hands the bitmaps over
// root-interleaved, (n_words, B): the B words of one vertex then share a
// 32-byte sector instead of lying B rows apart.  The grid is the CTAs
// the card holds at once (`bfs::resident_grid`, the occupancy API's
// count for this kernel); more only queue and stretch the tail, since a
// block's work grows with its mask's popcount.
//
// K4 (depth > 0) is the same body fed from shared memory: each CTA
// keeps the rows of its next `depth` union blocks in flight with
// cp.async into its own (depth + 1)-stage ring (`bfs::sweep_union` over
// `bfs::sweep_items`), the TPU kernel's make_async_copy pipeline.  The
// owners of `sub` slots at a time sit after the ring; a block longer
// than `sub` is scanned in pieces.  Above 48 KB of dynamic shared memory
// the opt-in attribute is set here before the launch.
#include <cuda_runtime.h>

#include "bfs_common.cuh"

namespace {

__global__ void __launch_bounds__(bfs::kThreads) gather_expand_kernel(
    const int* __restrict__ ulist, const int* __restrict__ ucount,
    const unsigned* __restrict__ rmask, const int* __restrict__ rows,
    const int* __restrict__ cs, const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    int n_mask_words, int tile, int sub, int n_cs, int v_pad,
    int n_vertices, int bottom_up, int depth, int n_batch) {
  extern __shared__ __align__(16) int smem[];
  int* own = smem + (depth > 0 ? (depth + 1) * tile : 0);
  const bfs::UnionItems items{ulist, __ldg(ucount)};
  bfs::sweep_union(
      items, rows, tile, depth, smem, [&](int blk, const int* rows_blk) {
        const unsigned* mask =
            rmask + static_cast<long long>(blk) * n_mask_words;
        for (int s0 = 0; s0 < tile; s0 += sub) {
          const int n = min(sub, tile - s0);
          bfs::owners_by_scan(cs, n_cs, blk * tile + s0, n, own);
          bfs::expand_roots(rows_blk + s0, own, n, mask, n_mask_words,
                            frontier, visited, out, p, n_batch, v_pad,
                            n_vertices, bottom_up != 0);
          if (s0 + sub < tile) __syncthreads();   // own is rewritten
        }
      });
}

}  // namespace

// ulist: (n_blocks,) int32 union list; ucount: (1,) int32; rmask:
// (n_blocks, n_mask_words) 32-bit root masks; rows: (n_blocks * tile,)
// int32; cs: (n_cs,) int32; frontier, visited, out: root-interleaved
// (n_words, B) 32-bit words; p: (B, v_pad) int32.  out and p are updated in place.  Dynamic shared
// memory: the ring ((depth + 1) * tile ints at depth > 0) and `sub`
// owner slots.  The grid is the CTAs the card holds at once (at most
// max_grid), each striding over the union.
extern "C" int repro_gather_expand(
    const void* ulist, const void* ucount, const void* rmask,
    const void* rows, const void* cs, const void* frontier,
    const void* visited, void* out, void* p, int n_batch, int n_mask_words,
    int tile, int sub, int n_cs, int v_pad, int n_vertices, int bottom_up,
    int depth, int max_grid, void* stream) {
  if (n_batch == 0 || max_grid <= 0) return 0;
  const size_t ring =
      depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int) : 0;
  const size_t smem = ring + static_cast<size_t>(sub) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gather_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int grid = 0;
  const cudaError_t rc =
      bfs::resident_grid(gather_expand_kernel, smem, max_grid, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  gather_expand_kernel<<<grid, bfs::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ulist), static_cast<const int*>(ucount),
      static_cast<const unsigned*>(rmask), static_cast<const int*>(rows),
      static_cast<const int*>(cs), static_cast<const unsigned*>(frontier),
      static_cast<const unsigned*>(visited), static_cast<unsigned*>(out),
      static_cast<int*>(p), n_mask_words, tile, sub, n_cs, v_pad,
      n_vertices, bottom_up, depth, n_batch);
  return static_cast<int>(cudaGetLastError());
}
