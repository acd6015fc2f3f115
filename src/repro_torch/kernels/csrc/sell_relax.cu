// K12: the semiring relax over SELL-C-σ slab groups, for Hopper, one CTA
// per slab group of the union of the batch's work-lists.
//
// Replaces: src/repro/kernels/sell_expand.py, `sell_relax_batched`
// (Pallas body `_sell_relax_batched_kernel` over `_sell_relax_edges`
// and gather_expand.py's `_relax_scatter_vals` /
// `_relax_scatter_parents`).
//
// What it computes: K11's function (gather_relax.cu) with the edges of
// the listed slab groups: lane i of slab s is the virtual row owned by
// src = slab_rows[s][i], and its neighbours are cols[s][q][i], q < 8
// (sentinel V pads both).  Phase 0 folds cand = vals[src] + unit
// (+ w(src, nbr)) into out[nbr] by atomicMin; phase 1, the second
// launch, takes pl[nbr] = min src over the edges whose candidate equals
// the finished out[nbr] and beat vals[nbr].  Deterministic, bitwise the
// reference's (relax_common.cuh pins the float arithmetic).
//
// What bounds it on this card: bytes, and the latency of the random
// per-root accesses.  An active group moves its cols (spp * 4 KB) and
// slab_rows (spp * 512 B) once per phase, coalesced; per lane and root
// a frontier word and vals[src]; per real column and root vals[nbr]
// and an atomic where the candidate improves.  The roots of a batch
// list mostly the same groups, so a walk of each root's own list (the
// first port: a (CTAs, B) grid) reads a group's slabs once per root
// that lists it, and each root's vals[nbr] and atomic is a sector of
// its own.
//
// Design, as K11's: a 1-D grid of resident CTAs (`bfs::resident_grid`)
// strides over the planner's union of groups (`bfs::UnionItems`); per
// group every lane reads its row and its 8 columns once, tests its row
// against the frontier of each root in the group's mask (`rmask`), and
// then, neighbour by neighbour, runs `relax::candidate` and
// `relax::relax_at` for those roots.  The wrapper hands `vals`, `out`
// and the frontier over root-interleaved, (v_pad, B) and (n_words, B),
// so that the B values of one vertex share a sector; `pl` stays
// (B, v_pad).  The loop order matters: a lane's 8 neighbours are 8
// random vertices, and with the roots outside the neighbours each root
// fetched the 8 sectors again (on an H100 that order ran the largest
// SCALE-22 layer no faster than the per-root walk, ~17 ms); with the
// roots inside, a neighbour's sector serves them all.
#include <cuda_runtime.h>

#include "relax_common.cuh"
#include "sell_phases.cuh"

namespace {

template <bool kFloat>
__global__ void __launch_bounds__(bfs::kThreads) sell_relax_kernel(
    const int* __restrict__ ulist, const int* __restrict__ ucount,
    const unsigned* __restrict__ rmask, const int* __restrict__ cols,
    const int* __restrict__ slab_rows, const unsigned* __restrict__ frontier,
    const int* __restrict__ vals, int* out, int* pl, int n_mask_words,
    int spp, int v_pad, int n_vertices, int unit, int weighted, int phase,
    int n_batch) {
  const int cols_ints = spp * bfs::kSlabInts, n_lanes = spp * bfs::kSliceC;
  const bfs::UnionItems items{ulist, __ldg(ucount)};
  bfs::sweep_items(
      items, 0, 0, nullptr, [](int*, int) {},
      [&](int grp, const int*) {
        const unsigned* mask =
            rmask + static_cast<long long>(grp) * n_mask_words;
        const int* cols_g = cols + static_cast<long long>(grp) * cols_ints;
        const int* rows_g = slab_rows + static_cast<long long>(grp) * n_lanes;
        for (int i = threadIdx.x; i < n_lanes; i += blockDim.x) {
          const int src = __ldg(rows_g + i);
          if (src >= n_vertices) continue;            // sentinel row
          const int* c = cols_g + (i >> 7) * bfs::kSlabInts +
                         (i & (bfs::kSliceC - 1));
          int nbr[bfs::kWQuant];
#pragma unroll
          for (int q = 0; q < bfs::kWQuant; ++q)
            nbr[q] = __ldg(c + q * bfs::kSliceC);
          // root b's word w / value x at w * n_batch + b / x * n_batch + b
          const unsigned* fu =
              frontier + static_cast<long long>(src >> 5) * n_batch;
          const int* vu = vals + static_cast<long long>(src) * n_batch;
          const unsigned ubit = 1u << (src & 31);
          for (int k = 0; k < n_mask_words; ++k) {
            // the roots of the mask whose frontier holds src
            unsigned live = 0;
            for (unsigned m = __ldg(mask + k); m; m &= m - 1) {
              const int j = __ffs(m) - 1;
              if (__ldg(fu + 32 * k + j) & ubit) live |= 1u << j;
            }
            // neighbour-major: a neighbour's B values share a sector
#pragma unroll
            for (int q = 0; q < bfs::kWQuant; ++q) {
              if (nbr[q] >= n_vertices) continue;     // sentinel column
              const long long vn = static_cast<long long>(nbr[q]) * n_batch;
              for (unsigned m = live; m; m &= m - 1) {
                const int b = 32 * k + __ffs(m) - 1;
                const int cand = relax::candidate<kFloat>(
                    __ldg(vu + b), src, nbr[q], unit, weighted != 0);
                relax::relax_at(
                    phase, src, cand, vals + vn + b, out + vn + b,
                    pl + static_cast<long long>(b) * v_pad + nbr[q]);
              }
            }
          }
        }
      });
}

}  // namespace

// ulist: (n_steps,) int32 union of the groups; ucount: (1,) int32;
// rmask: (n_steps, n_mask_words) 32-bit root masks; cols:
// (n_steps * spp, 8, 128) int32; slab_rows: (n_steps * spp, 128) int32;
// frontier: root-interleaved (n_words, B) 32-bit words; vals, out:
// root-interleaved (v_pad, B) 32-bit values (float32 bits when
// is_float); pl: (B, v_pad) int32.  out must hold a copy of vals and pl
// P_UNSET; both are updated in place by the two launches.  The grid is
// the CTAs the card holds at once (at most max_grid), each striding over
// the union.
extern "C" int repro_sell_relax(
    const void* ulist, const void* ucount, const void* rmask,
    const void* cols, const void* slab_rows, const void* frontier,
    const void* vals, void* out, void* pl, int n_batch, int n_mask_words,
    int spp, int v_pad, int n_vertices, int unit, int weighted,
    int is_float, int max_grid, void* stream) {
  if (n_batch == 0 || max_grid <= 0) return 0;
  auto kernel = is_float ? sell_relax_kernel<true>
                         : sell_relax_kernel<false>;
  int grid = 0;
  const cudaError_t rc = bfs::resident_grid(kernel, 0, max_grid, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int phase = 0; phase < 2; ++phase) {
    kernel<<<grid, bfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ulist), static_cast<const int*>(ucount),
        static_cast<const unsigned*>(rmask), static_cast<const int*>(cols),
        static_cast<const int*>(slab_rows),
        static_cast<const unsigned*>(frontier),
        static_cast<const int*>(vals), static_cast<int*>(out),
        static_cast<int*>(pl), n_mask_words, spp, v_pad, n_vertices, unit,
        weighted, phase, n_batch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
