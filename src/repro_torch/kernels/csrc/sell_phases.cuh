// The SELL-C-σ layout on the device, the slab sweep over each root's
// work-list (K8, sell_expand.cu) and the planning test of a slab group
// (`group_roots`), which the planner (plan_union.cu) and the one-launch
// kernels K9 (sell_layer_fused.cu) and K10 (sell_traversal_fused.cu)
// take from here to plan the union of the lists (union_phases.cuh);
// they walk that union with `sell_group_union`.
//
// Layout (formats/sell.py): a slab is an (8, 128) int32 block;
// cols[slab][q][lane] is neighbour q of the virtual row in `lane`
// (sentinel V pads), slab_rows[slab][lane] the vertex owning that row.
// A work-list item is a group of `spp` consecutive slabs.
//
// * sell_group: one root's sweep of one group, one thread per lane
//   (thread i: slab i >> 7, lane i & 127), W_QUANT column loads each,
//   coalesced across the lanes of a warp.  Top-down gates on the row
//   being in the frontier and discovers each neighbour; bottom-up
//   discovers the row, gated on a neighbour in the frontier, and stops
//   at the row's first discovery.  The `out` update is the paper's
//   non-atomic read-OR-write (§3.3.2): bits can be dropped, every
//   passing lane writes its negative P mark, and restoration repairs
//   `out` from those marks.  Sentinel rows and neighbours (== V) never
//   index P or a bitmap.
// * sell_sweep: K8's walk over its share of the work-lists
//   (`bfs::sweep_items`), each group's cols and slab_rows staged
//   together in one ring slot at depth > 0; a group that r roots list
//   is read r times.
// * group_roots: slab group `grp` is active for root b iff one of its
//   lanes owns a row below V that is a member of the planning bitmap
//   (the frontier, or the unvisited set bottom-up: the reference's
//   `_plan_slabs_in_kernel`).  One warp reads a group's slab_rows once
//   and tests them against up to 32 roots' bitmaps, giving one
//   root-mask word per (group, 32 roots).
#pragma once

#include <cuda_runtime.h>

#include "fused_phases.cuh"

namespace bfs {

constexpr int kSliceC = 128;                  // lanes (rows) per slab
constexpr int kWQuant = 8;                    // columns per slab
constexpr int kSlabInts = kWQuant * kSliceC;  // one slab's cols

struct SellGraph {
  const int* cols;       // (n_steps * spp, 8, 128) neighbour ids
  const int* slab_rows;  // (n_steps * spp, 128) owning vertex ids
  const int* deg;        // (v_pad,) degrees, 0 on padding (K10 only)
  int n_steps, spp, n_words, v_pad, n_vertices;
};

__device__ __forceinline__ bool in_bitmap(const unsigned* words, int v) {
  return (load_word<false>(words + (v >> 5)) >> (v & 31)) & 1u;
}

// One slab group's sweep for one root.  cols_g / rows_g point at the
// group's cols and slab_rows, in device or shared memory.
__device__ __forceinline__ void sell_group(const int* cols_g,
                                           const int* rows_g, int spp,
                                           const unsigned* fr,
                                           const unsigned* vis,
                                           unsigned* ob, int* pb,
                                           int n_vertices, bool bottom_up) {
  const int n_lanes = spp * kSliceC;
  for (int i = threadIdx.x; i < n_lanes; i += blockDim.x) {
    const int row = rows_g[i];
    if (row >= n_vertices) continue;                  // sentinel row
    const int* c = cols_g + (i >> 7) * kSlabInts + (i & (kSliceC - 1));
    if (!bottom_up) {
      if (!in_bitmap(fr, row)) continue;
      for (int q = 0; q < kWQuant; ++q) {
        const int nbr = c[q * kSliceC];
        if (nbr >= n_vertices) continue;              // sentinel column
        const int w = nbr >> 5;
        const unsigned bit = 1u << (nbr & 31);
        const unsigned ow = load_word<false>(ob + w);   // racy read
        if ((load_word<false>(vis + w) | ow) & bit) continue;
        pb[nbr] = row - n_vertices;                   // negative mark
        ob[w] = ow | bit;                             // racy write
      }
    } else {
      const int w = row >> 5;
      const unsigned bit = 1u << (row & 31);
      if (load_word<false>(vis + w) & bit) continue;
      for (int q = 0; q < kWQuant; ++q) {
        const int nbr = c[q * kSliceC];
        if (nbr >= n_vertices || !in_bitmap(fr, nbr)) continue;
        const unsigned ow = load_word<false>(ob + w);
        if (!(ow & bit)) {
          pb[row] = nbr - n_vertices;
          ob[w] = ow | bit;
        }
        break;                  // the row is discovered: stop scanning
      }
    }
  }
}

// A CTA's walk over its share of the work-lists of roots [b0, b_end):
// K8 at depth 0 reads the slabs from device memory, at depth > 0 from
// the ring, `ring` being (depth + 1) * spp * 1152 ints of shared memory.
__device__ __forceinline__ void sell_sweep(const SellGraph& g,
                                           const WorkItems& items, int b0,
                                           const unsigned* frontier,
                                           const unsigned* visited,
                                           unsigned* out, int* p,
                                           bool bottom_up, int depth,
                                           int* ring) {
  const int cols_ints = g.spp * kSlabInts, rows_ints = g.spp * kSliceC;
  sweep_items(
      items, b0, depth, cols_ints + rows_ints, ring,
      [&](int* dst, int grp) {
        stage_block(dst, g.cols + static_cast<long long>(grp) * cols_ints,
                    cols_ints);
        stage_block(dst + cols_ints,
                    g.slab_rows + static_cast<long long>(grp) * rows_ints,
                    rows_ints);
      },
      [&](int b, int grp, const int* slot) {
        const int* cols_g =
            slot ? slot : g.cols + static_cast<long long>(grp) * cols_ints;
        const int* rows_g =
            slot ? slot + cols_ints
                 : g.slab_rows + static_cast<long long>(grp) * rows_ints;
        const long long wo = static_cast<long long>(b) * g.n_words;
        sell_group(cols_g, rows_g, g.spp, frontier + wo,
                              visited + wo, out + wo,
                              p + static_cast<long long>(b) * g.v_pad,
                              g.n_vertices, bottom_up);
      });
}

// Root mask of group `grp` over roots [b0, b0 + nb), nb <= 32: bit k set
// iff a lane's row is a member of root b0 + k's planning bitmap.  Every
// lane of the calling warp must call it.
template <bool kCoherent>
__device__ __forceinline__ unsigned group_roots(const SellGraph& g,
                                                const unsigned* words,
                                                bool complement, int b0,
                                                int nb, int grp) {
  const int n_lanes = g.spp * kSliceC;
  const int* rows = g.slab_rows + static_cast<long long>(grp) * n_lanes;
  unsigned m = 0;
  for (int i = threadIdx.x & 31; i < n_lanes; i += 32) {
    const int r = __ldg(rows + i);
    if (r >= g.n_vertices) continue;
    const unsigned bit = 1u << (r & 31);
    for (int k = 0; k < nb; ++k) {
      unsigned a = load_word<kCoherent>(
          words + static_cast<long long>(b0 + k) * g.n_words + (r >> 5));
      if (complement) a = ~a;
      if (a & bit) m |= 1u << k;
    }
  }
  return __reduce_or_sync(0xffffffffu, m);
}

}  // namespace bfs
