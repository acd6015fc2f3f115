// K12: the semiring relax over work-listed SELL-C-σ slab groups, for
// Hopper.
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
// What bounds it on this card: bytes.  An active group moves its cols
// (spp * 4 KB) and slab_rows (spp * 512 B) once per phase, coalesced:
// one thread per lane, the 8 column loads of a warp each 128
// contiguous bytes.  Per lane one frontier word and vals[src]; per real
// column vals[nbr] and an atomic where the candidate improves.  The
// grid is (CTAs, B), CTAs striding over each root's list, n_active read
// on the device.
#include <cuda_runtime.h>

#include "relax_common.cuh"
#include "sell_phases.cuh"

namespace {

template <bool kFloat>
__global__ void __launch_bounds__(bfs::kThreads) sell_relax_kernel(
    const int* __restrict__ wl, const int* __restrict__ na,
    const int* __restrict__ cols, const int* __restrict__ slab_rows,
    const unsigned* __restrict__ frontier, const int* __restrict__ vals,
    int* out, int* pl, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int unit, int weighted, int phase) {
  const int b = blockIdx.y;
  const unsigned* fr = frontier + static_cast<long long>(b) * n_words;
  const long long vo = static_cast<long long>(b) * v_pad;
  const int* vb = vals + vo;
  int* ob = out + vo;
  int* pb = pl + vo;
  const int cols_ints = spp * bfs::kSlabInts, n_lanes = spp * bfs::kSliceC;
  const bfs::WorkItems items{wl, na, n_steps, b + 1};
  bfs::sweep_items(
      items, b, 0, 0, nullptr, [](int*, int) {},
      [&](int, int grp, const int*) {
        const int* cols_g = cols + static_cast<long long>(grp) * cols_ints;
        const int* rows_g = slab_rows + static_cast<long long>(grp) * n_lanes;
        for (int i = threadIdx.x; i < n_lanes; i += blockDim.x) {
          const int src = __ldg(rows_g + i);
          if (src >= n_vertices || !relax::in_frontier(fr, src)) continue;
          const int val_u = __ldg(vb + src);
          const int* c = cols_g + (i >> 7) * bfs::kSlabInts +
                         (i & (bfs::kSliceC - 1));
          for (int q = 0; q < bfs::kWQuant; ++q) {
            const int nbr = __ldg(c + q * bfs::kSliceC);
            if (nbr >= n_vertices) continue;
            const int cand = relax::candidate<kFloat>(val_u, src, nbr, unit,
                                                      weighted != 0);
            relax::relax_edge(phase, src, nbr, cand, vb, ob, pb);
          }
        }
      });
}

}  // namespace

// wl: (B, n_steps) int32; na: (B,) int32; cols: (n_steps * spp, 8, 128)
// int32; slab_rows: (n_steps * spp, 128) int32; frontier: (B, n_words)
// words; vals, out: (B, v_pad) 32-bit values (float32 bits when
// is_float); pl: (B, v_pad) int32.  out must hold a copy of vals and pl
// P_UNSET; both are updated in place by the two launches.
extern "C" int repro_sell_relax(
    const void* wl, const void* na, const void* cols, const void* slab_rows,
    const void* frontier, const void* vals, void* out, void* pl,
    int n_batch, int n_steps, int spp, int n_words, int v_pad,
    int n_vertices, int unit, int weighted, int is_float, int grid_x,
    void* stream) {
  if (n_batch == 0 || n_steps == 0 || grid_x <= 0) return 0;
  dim3 grid(grid_x, n_batch);
  for (int phase = 0; phase < 2; ++phase) {
    auto kernel = is_float ? sell_relax_kernel<true>
                           : sell_relax_kernel<false>;
    kernel<<<grid, bfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(wl), static_cast<const int*>(na),
        static_cast<const int*>(cols), static_cast<const int*>(slab_rows),
        static_cast<const unsigned*>(frontier),
        static_cast<const int*>(vals), static_cast<int*>(out),
        static_cast<int*>(pl), n_steps, spp, n_words, v_pad, n_vertices,
        unit, weighted, phase);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}
