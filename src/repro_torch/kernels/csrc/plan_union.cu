// The union planner (not a TPU kernel): each layer's plan of the items
// that the work-listed kernels walk, for Hopper, in two launches.
//
// What it replaces: the planning that the reference runs in jnp around
// its Pallas calls (src/repro/core/engine.py, `plan_active_tiles_batched`
// over K2's vertex queue, `mark_blocks_from_queue`, `compact_worklist`;
// src/repro/kernels/sell_expand.py's slab membership), which the port
// ran as K2 + dozens of plain-torch launches and then folded into the
// union of the lists (`gather_expand.union_worklist`) before every K3,
// K4, K11 and K12 launch.
//
// What it computes, for a batch of B roots and n_items items (CSR
// rows-blocks, or SELL slab groups of `spp` slabs):
//   rmask: (n_items, ceil(B / 32)) words, bit b % 32 of word b / 32 set
//          when root b lists the item: `dense[b]`, or
//          CSR:  some vertex in the item's owner range [blk_lo, blk_hi]
//                is active for b and has degree > 0 (K5's
//                `bfs::covered`, fused_phases.cuh),
//          SELL: one of the group's lanes owns a row below V that is
//                active for b (K9's `bfs::group_roots`, sell_phases.cuh);
//          "active" is the planning bitmap's bit, or its complement;
//   ulist: the items any root lists, ascending, then zeros;
//   ucount: their number; na: (B,) each root's count.
// Exactly `union_worklist` of the per-root lists (and their counts).
//
// Ascending order is a count, then a write.  Launch 1 gives each CTA a
// contiguous chunk of items: it writes the chunk's masks and counts,
// per root and for "any root", into cnt ((B + 1, grid) ints).  Launch 2,
// on the same grid, sums the counts of the CTAs before it, ranks its
// chunk's listed items by a block scan and writes them at that offset,
// zeroes the list's tail, and CTA 0 sums each root's count.  No host
// sync, no atomics on the outputs: the result is deterministic.  The
// device code of both launches lives in union_phases.cuh, where K5 and
// K9 run it in-kernel between grid barriers.
//
// What bounds it on this card: bytes.  CSR: blk_lo and blk_hi (8 bytes
// an item), the planning words of each root over the owner ranges and
// the degree words, the masks written and read back, the list.  SELL:
// every group's slab_rows (512 bytes a slab) and one planning word per
// row and root, read by one warp per group.  A few MB at SCALE 22,
// microseconds against the tens of milliseconds of launches it replaces.
#include <cuda_runtime.h>

#include "union_phases.cuh"

namespace {

// The dense roots' mask words, in shared memory (n_mask_words words).
__device__ void dense_words(const unsigned char* __restrict__ dense,
                            int n_batch, int n_mask_words, unsigned* s) {
  for (int k = threadIdx.x; k < n_mask_words; k += blockDim.x) s[k] = 0;
  __syncthreads();
  if (dense)
    for (int b = threadIdx.x; b < n_batch; b += blockDim.x)
      if (dense[b]) atomicOr(s + (b >> 5), 1u << (b & 31));
  __syncthreads();
}

// Launch 1, CSR arm: one thread per rows-block of the chunk.
__global__ void __launch_bounds__(bfs::kThreads) plan_masks_csr(
    const unsigned* __restrict__ words,
    const unsigned char* __restrict__ dense, const int* __restrict__ blk_lo,
    const int* __restrict__ blk_hi, const unsigned* __restrict__ nz,
    unsigned* rmask, int* cnt, int n_batch, int n_words, int n_blocks,
    int n_vertices, int complement) {
  extern __shared__ unsigned s_dense[];
  const int n_mask_words = (n_batch + 31) >> 5;
  dense_words(dense, n_batch, n_mask_words, s_dense);
  bfs::FusedGraph g{};
  g.blk_lo = blk_lo;
  g.blk_hi = blk_hi;
  g.nz = nz;
  g.n_blocks = n_blocks;
  g.n_words = n_words;
  g.n_vertices = n_vertices;
  int begin, end;
  bfs::chunk_of_cta(n_blocks, &begin, &end);
  bfs::union_masks_csr<true>(g, words, complement != 0, n_batch, s_dense,
                             rmask, begin, end);
  bfs::union_counts(rmask, n_mask_words, n_batch, begin, end, cnt);
}

// Launch 1, SELL arm: one warp per slab group of the chunk, reading the
// group's slab_rows once for 32 roots at a time.
__global__ void __launch_bounds__(bfs::kThreads) plan_masks_sell(
    const unsigned* __restrict__ words,
    const unsigned char* __restrict__ dense,
    const int* __restrict__ slab_rows, unsigned* rmask, int* cnt,
    int n_batch, int n_words, int n_steps, int spp, int n_vertices,
    int complement) {
  extern __shared__ unsigned s_dense[];
  const int n_mask_words = (n_batch + 31) >> 5;
  dense_words(dense, n_batch, n_mask_words, s_dense);
  bfs::SellGraph g{};
  g.slab_rows = slab_rows;
  g.n_steps = n_steps;
  g.spp = spp;
  g.n_words = n_words;
  g.n_vertices = n_vertices;
  int begin, end;
  bfs::chunk_of_cta(n_steps, &begin, &end);
  bfs::union_masks_sell<true>(g, words, complement != 0, n_batch, s_dense,
                              rmask, begin, end);
  bfs::union_counts(rmask, n_mask_words, n_batch, begin, end, cnt);
}

// Launch 2 (both arms): the ascending union list, its count, the tail's
// zeros and each root's count.
__global__ void __launch_bounds__(bfs::kThreads) plan_write(
    const unsigned* __restrict__ rmask, const int* __restrict__ cnt,
    int* ulist, int* ucount, int* na, int n_items, int n_batch) {
  bfs::union_write<false>(rmask, cnt, ulist, ucount, na, n_items, n_batch);
}

int launch_write(const void* rmask, void* cnt, void* ulist, void* ucount,
                 void* na, int n_items, int n_batch, int grid,
                 cudaStream_t stream) {
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  plan_write<<<grid, bfs::kThreads, 0, stream>>>(
      static_cast<const unsigned*>(rmask), static_cast<const int*>(cnt),
      static_cast<int*>(ulist), static_cast<int*>(ucount),
      static_cast<int*>(na), n_items, n_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// CSR arm.  words: (B, n_words) planning bitmaps (complemented when
// complement != 0); dense: (B,) bytes or null; blk_lo, blk_hi:
// (n_blocks,) int32 owner ranges; nz: (n_words,) degree > 0 words.
// Outputs: rmask (n_blocks, ceil(B / 32)) words, ulist (n_blocks,),
// ucount (1,), na (B,) int32; cnt: (B + 1, grid) int32 scratch.  Both
// launches run `grid` CTAs (1 <= grid <= n_blocks).
extern "C" int repro_plan_union_csr(
    const void* words, const void* dense, const void* blk_lo,
    const void* blk_hi, const void* nz, void* rmask, void* cnt, void* ulist,
    void* ucount, void* na, int n_batch, int n_words, int n_blocks,
    int n_vertices, int complement, int grid, void* stream) {
  if (n_batch == 0 || n_blocks == 0 || grid <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(unsigned) * ((n_batch + 31) >> 5);
  plan_masks_csr<<<grid, bfs::kThreads, smem, s>>>(
      static_cast<const unsigned*>(words),
      static_cast<const unsigned char*>(dense),
      static_cast<const int*>(blk_lo), static_cast<const int*>(blk_hi),
      static_cast<const unsigned*>(nz), static_cast<unsigned*>(rmask),
      static_cast<int*>(cnt), n_batch, n_words, n_blocks, n_vertices,
      complement);
  return launch_write(rmask, cnt, ulist, ucount, na, n_blocks, n_batch,
                      grid, s);
}

// SELL arm.  slab_rows: (n_steps * spp, 128) int32; the rest as in the
// CSR arm, with n_steps slab groups for items.
extern "C" int repro_plan_union_sell(
    const void* words, const void* dense, const void* slab_rows,
    void* rmask, void* cnt, void* ulist, void* ucount, void* na,
    int n_batch, int n_words, int n_steps, int spp, int n_vertices,
    int complement, int grid, void* stream) {
  if (n_batch == 0 || n_steps == 0 || grid <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(unsigned) * ((n_batch + 31) >> 5);
  plan_masks_sell<<<grid, bfs::kThreads, smem, s>>>(
      static_cast<const unsigned*>(words),
      static_cast<const unsigned char*>(dense),
      static_cast<const int*>(slab_rows), static_cast<unsigned*>(rmask),
      static_cast<int*>(cnt), n_batch, n_words, n_steps, spp, n_vertices,
      complement);
  return launch_write(rmask, cnt, ulist, ucount, na, n_steps, n_batch,
                      grid, s);
}
