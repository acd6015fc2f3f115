// The SELL-C-σ layout on the device and the planning test of a slab
// group (`group_roots`), which the planner (plan_union.cu) and the
// one-launch kernels K9 (sell_layer_fused.cu) and K10
// (sell_traversal_fused.cu) take from here to plan the union of the
// lists (union_phases.cuh); K8 (sell_expand.cu), K9 and K10 walk that
// union with `sell_group_union` (union_phases.cuh).
//
// Layout (formats/sell.py): a slab is an (8, 128) int32 block;
// cols[slab][q][lane] is neighbour q of the virtual row in `lane`
// (sentinel V pads), slab_rows[slab][lane] the vertex owning that row.
// A work-list item is a group of `spp` consecutive slabs.
//
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
