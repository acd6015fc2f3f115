// The pieces of the cooperative CSR kernels that are not a phase of
// their own: the loop constants of the CSR graph (`FusedGraph`), the
// rows-block plan's test, a CTA's chunk of items, the grid's warps, and
// the host side of a cooperative launch (the co-resident grid).  The
// phases themselves — planning the union of the batch's lists, the walk
// with one CTA per item for every root, restoration — are in
// union_phases.cuh, shared by the planner, K5, K6, K9 and K10.
//
// * plan: rows-block blk is covered iff some vertex whose adjacency
//   intersects it is active and has degree > 0.  Those vertices are
//   exactly the ids in [blk_lo[blk], blk_hi[blk]] (the owners of the
//   block's first and last slot, loop constants built once per plan)
//   that have degree > 0, so the test (`covered`) is an OR over a few
//   words of `active & nz`.  That is the reference's difference-scatter
//   plan (`layer_fused._plan_in_kernel`) without the scatter.  The
//   planning words are read through L2 (ld.global.cg): K6 rewrites them
//   between layers.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bfs_common.cuh"

namespace bfs {

struct FusedGraph {
  const int* rows;       // (n_blocks * tile,) tile-padded adjacency
  const int* cs;         // (n_cs,) colstarts, n_cs = V + 1
  const int* blk_lo;     // (n_blocks,) owner of each block's first slot
  const int* blk_hi;     // (n_blocks,) owner of its last slot
  const unsigned* nz;    // (n_words,) bit v set iff deg(v) > 0
  const int* deg;        // (v_pad,) degrees, 0 on padding
  int n_blocks, tile, n_cs, n_words, v_pad, n_vertices;
};

__device__ __forceinline__ bool covered(const FusedGraph& g,
                                        const unsigned* act,
                                        bool complement, int blk) {
  const int lo = __ldg(g.blk_lo + blk);
  const int hi = min(__ldg(g.blk_hi + blk), g.n_vertices - 1);
  if (lo > hi) return false;
  const int w0 = lo >> 5, w1 = hi >> 5;
  for (int w = w0; w <= w1; ++w) {
    unsigned a = __ldcg(act + w);
    if (complement) a = ~a;
    unsigned m = a & __ldg(g.nz + w);
    if (w == w0) m &= ~0u << (lo & 31);
    if (w == w1) m &= ~0u >> (31 - (hi & 31));
    if (m) return true;
  }
  return false;
}

__device__ __forceinline__ void chunk_of_cta(int n_blocks, int* begin,
                                             int* end) {
  const int chunk = (n_blocks + gridDim.x - 1) / gridDim.x;
  *begin = min(n_blocks, static_cast<int>(blockIdx.x) * chunk);
  *end = min(n_blocks, *begin + chunk);
}

// This thread's warp and the grid's warp count.
__device__ __forceinline__ long long grid_warp() {
  return static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
         (threadIdx.x >> 5);
}
__device__ __forceinline__ long long grid_warps() {
  return static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
}

// ---------------------------------------------------------------------------
// Host side: the co-resident grid and the cooperative launch
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB needs the opt-in attribute.
template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// min(occupancy, ctas_per_sm) CTAs on every SM: a grid whose CTAs are
// all resident at once, as a grid barrier needs.
template <class Kernel>
int cooperative_grid(Kernel kernel, size_t smem, int ctas_per_sm,
                     int* grid) {
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int set = set_smem(kernel, smem);
  if (set) return set;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                     smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (occ == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid = (occ < ctas_per_sm ? occ : ctas_per_sm) * sms;
  return 0;
}

template <class Kernel>
int launch_cooperative(Kernel kernel, int grid, size_t smem, void* stream,
                       void** args) {
  const int set = set_smem(kernel, smem);
  if (set) return set;
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bfs
