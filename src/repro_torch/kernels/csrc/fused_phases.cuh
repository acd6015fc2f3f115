// The grid-wide phases of one BFS layer that walk each root's own
// work-list, run by the whole-traversal kernel (K6, traversal_fused.cu,
// through traversal_loop.cuh).  Every function here is called by every
// thread of every CTA of a cooperative launch, between grid barriers:
//
//   plan_count  | plan_write  | gather  | restore_update (K6)
//
// * plan: rows-block blk is covered iff some vertex whose adjacency
//   intersects it is active and has degree > 0.  Those vertices are
//   exactly the ids in [blk_lo[blk], blk_hi[blk]] (the owners of the
//   block's first and last slot, loop constants built once per plan)
//   that have degree > 0, so the test (`covered`) is an OR over a few
//   words of `active & nz`.  That is the reference's difference-scatter
//   plan (`layer_fused._plan_in_kernel`) without the scatter.  Each CTA
//   counts the covered blocks of its contiguous chunk; after a barrier
//   each CTA sums the counts of the CTAs before it and writes its
//   chunk's block ids there, so the work-list is ascending, as the
//   reference's.  n_active[b] is its length.
// * gather: the CTAs stride over every root's work-list (`bfs::sweep`),
//   so a block that r roots list is read, and its owners searched, r
//   times.
// * restore (`restore_word`, traversal_loop.cuh's `restore_update`): one
//   warp per 32 vertices; a ballot of the negative P marks is the delta
//   word, ORed into `out`.
//
// The whole-layer kernels K5 and K9 no longer walk per root: they plan
// the union of the lists with the same `covered` (and K9's
// `group_roots`) and walk it with one CTA per item for every root
// (union_phases.cuh), which K6's loop could adopt the same way.  Also
// here: the host side of a cooperative launch (the co-resident grid).
//
// State that CTAs rewrite inside the launch (bitmaps, P, work-lists,
// counts) is read with ld.global.cg, never the non-coherent path.
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

// The per-layer work buffers.
struct LayerBuffers {
  unsigned* out;   // (B, n_words) racy discoveries of the layer
  int* wl;         // (B, n_blocks) work-lists
  int* cnt;        // (B, gridDim.x) covered blocks per CTA chunk
  int* na;         // (B,) work-list lengths
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

// Phase 1: covered blocks per (root, CTA chunk) -> cnt.  `words` are the
// planning bitmaps (frontier, or visited with complement = true).
__device__ inline void plan_count(const FusedGraph& g, const unsigned* words,
                                  bool complement, int n_batch, int* cnt) {
  int begin, end;
  chunk_of_cta(g.n_blocks, &begin, &end);
  for (int b = 0; b < n_batch; ++b) {
    const unsigned* act = words + static_cast<long long>(b) * g.n_words;
    long long c[1] = {0};
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x)
      c[0] += covered(g, act, complement, i);
    block_sum(c);
    if (threadIdx.x == 0) cnt[b * gridDim.x + blockIdx.x] = int(c[0]);
  }
}

// Phase 2: ascending work-lists and their lengths.
__device__ inline void plan_write(const FusedGraph& g, const unsigned* words,
                                  bool complement, int n_batch,
                                  const LayerBuffers& buf) {
  int begin, end;
  chunk_of_cta(g.n_blocks, &begin, &end);
  for (int b = 0; b < n_batch; ++b) {
    const unsigned* act = words + static_cast<long long>(b) * g.n_words;
    long long s[2] = {0, 0};       // CTAs before this one, all CTAs
    for (int c = threadIdx.x; c < static_cast<int>(gridDim.x);
         c += blockDim.x) {
      const int v = __ldcg(buf.cnt + b * gridDim.x + c);
      s[1] += v;
      if (c < static_cast<int>(blockIdx.x)) s[0] += v;
    }
    block_sum(s);
    if (blockIdx.x == 0 && threadIdx.x == 0) buf.na[b] = int(s[1]);
    int* wl_b = buf.wl + static_cast<long long>(b) * g.n_blocks;
    int off = int(s[0]);
    for (int base = begin; base < end; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const bool f = i < end && covered(g, act, complement, i);
      int total;
      const int r = block_rank(f, &total);
      if (f) wl_b[off + r] = i;
      off += total;
    }
  }
}

// Phase 3: gather-expand every root's listed blocks into buf.out and P.
__device__ inline void gather(const FusedGraph& g, const unsigned* frontier,
                              const unsigned* visited, int* p,
                              const LayerBuffers& buf, int n_batch,
                              bool bottom_up, bool scalar, int depth,
                              int* stage) {
  const WorkItems items{buf.wl, buf.na, g.n_blocks, n_batch};
  sweep(items, 0, g.rows, g.tile, depth, stage,
        [&](int b, int blk, const int* rows_blk) {
          const long long wo = static_cast<long long>(b) * g.n_words;
          expand_block<true>(rows_blk, g.cs, blk * g.tile, g.tile,
                             __ldg(g.blk_lo + blk), __ldg(g.blk_hi + blk),
                             frontier + wo, visited + wo, buf.out + wo,
                             p + static_cast<long long>(b) * g.v_pad,
                             g.n_vertices, bottom_up, scalar);
        });
}

// This thread's warp and the grid's warp count.
__device__ __forceinline__ long long grid_warp() {
  return static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
         (threadIdx.x >> 5);
}
__device__ __forceinline__ long long grid_warps() {
  return static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
}

// Restore one word's 32 P entries (lane k: vertex 32 w + k) and return
// the delta word: the marked vertices.
__device__ __forceinline__ unsigned restore_word(int* p_word, int lane,
                                                 int n_vertices) {
  const int v = __ldcg(p_word + lane);
  const bool marked = v < 0;
  if (marked) p_word[lane] = v + n_vertices;
  return __ballot_sync(0xffffffffu, marked);
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
