// Device helpers shared by the gather-expand kernels (K3, K4) and the
// fused layer and traversal kernels (K5, K6).
//
// * `owner_in`: the edge -> owning vertex binary search over colstarts;
// * `expand_block`: the racy gather-expand body over one rows-block;
// * `sweep_items` / `sweep`: a CTA's walk over its share of the
//   work-lists, with `depth` items in flight into a (depth + 1)-stage
//   ring of shared memory (`cp.async`), or read straight from device
//   memory at depth 0 (the SELL kernels stage slabs through the same
//   walk);
// * block-wide sums and an exclusive scan of one flag per thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bfs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Largest u in [lo, hi] with cs[u] <= e, given cs[lo] <= e.
__device__ __forceinline__ int owner_in(const int* __restrict__ cs, int lo,
                                        int hi, int e) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (__ldg(cs + mid) <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A load of a word that another CTA of the same launch may write.
// kCoherent (K5, K6: state rewritten between grid barriers) reads
// through L2 only (ld.global.cg); never the non-coherent path.
template <bool kCoherent>
__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  if constexpr (kCoherent) return __ldcg(p);
  return *p;
}

// The gather-expand body over one rows-block [e0, e0 + tile): owner u
// of each slot by a search in [lo, hi], neighbour v from `rows_blk`.
// Top-down gates on u in the frontier and discovers v; bottom-up swaps
// the roles.  The undiscovered test is `visited | out` (the out word is
// read racily and written back with the new bit, paper §3.3.2), or the
// pre-layer `visited` alone for a scalar-mode layer of K6.  Every lane
// that passes writes its negative P mark, which restoration turns into
// the repaired bitmap.
template <bool kCoherent>
__device__ __forceinline__ void expand_block(
    const int* rows_blk, const int* __restrict__ cs, int e0, int tile,
    int lo, int hi, const unsigned* fr, const unsigned* vis, unsigned* ob,
    int* pb, int n_vertices, bool bottom_up, bool scalar) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int e = e0 + i;
    const int u = owner_in(cs, lo, hi, e);
    const int v = rows_blk[i];
    if (u >= n_vertices || v >= n_vertices) continue;  // sentinel tail
    const int gate = bottom_up ? v : u;
    const int cand = bottom_up ? u : v;
    if (!((load_word<kCoherent>(fr + (gate >> 5)) >> (gate & 31)) & 1u))
      continue;
    const int w = cand >> 5;
    const unsigned bit = 1u << (cand & 31);
    const unsigned ow = load_word<kCoherent>(ob + w);      // racy read
    const unsigned seen = load_word<kCoherent>(vis + w) | (scalar ? 0u : ow);
    if (seen & bit) continue;
    pb[cand] = gate - n_vertices;                           // negative mark
    ob[w] = ow | bit;                                       // racy write
  }
}

// ---------------------------------------------------------------------------
// cp.async: the counterpart of the TPU kernels' make_async_copy.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `n` committed groups are still in flight.  The
// count must be an immediate, so depths past 15 wait for all groups
// (correct, with less overlap).
__device__ __forceinline__ void cp_async_wait_prior(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    case 15: cp_async_wait<15>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// The whole CTA copies one rows-block into a stage: 16-byte copies when
// source and tile allow, else 4-byte ones.
__device__ __forceinline__ void stage_block(int* dst, const int* src,
                                            int tile) {
  if ((tile & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x * 4; i < tile; i += blockDim.x * 4)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

// ---------------------------------------------------------------------------
// A CTA's share of the work-lists
// ---------------------------------------------------------------------------

// Roots [b, b_end) in turn; within root b the work-list entries
// t = blockIdx.x, blockIdx.x + gridDim.x, ... below na[b].  The lists
// and counts may have been written earlier in the same launch, so they
// are read through L2.
struct WorkItems {
  const int* wl;
  const int* na;
  int n_blocks;
  int b_end;

  struct Cursor {
    int b, t;
  };

  __device__ void settle(Cursor& c) const {
    while (c.b < b_end && c.t >= __ldcg(na + c.b)) {
      ++c.b;
      c.t = blockIdx.x;
    }
  }
  __device__ Cursor first(int b0) const {
    Cursor c{b0, static_cast<int>(blockIdx.x)};
    settle(c);
    return c;
  }
  __device__ void next(Cursor& c) const {
    c.t += gridDim.x;
    settle(c);
  }
  __device__ bool valid(const Cursor& c) const { return c.b < b_end; }
  __device__ int blk(const Cursor& c) const {
    return __ldcg(wl + static_cast<long long>(c.b) * n_blocks + c.t);
  }
};

// Walk the CTA's items, calling body(b, blk, slot) for each.  depth == 0
// passes slot = nullptr (the body reads device memory); depth > 0 keeps
// `depth` items' copies in flight into ring slot (k % (depth + 1)) while
// item k computes on the slot that has landed (the reference's
// `_dma_pipeline`: warm-up of `depth` copies, then one ahead per step).
// stage(dst, blk) issues item blk's cp.async copies into a slot of
// `slot_ints` ints; `ring` is (depth + 1) * slot_ints ints of dynamic
// shared memory.
template <class Stage, class Body>
__device__ __forceinline__ void sweep_items(const WorkItems& items, int b0,
                                            int depth, int slot_ints,
                                            int* ring, Stage stage,
                                            Body body) {
  WorkItems::Cursor cur = items.first(b0);
  if (depth == 0) {
    for (; items.valid(cur); items.next(cur)) {
      body(cur.b, items.blk(cur), static_cast<const int*>(nullptr));
      __syncthreads();
    }
    return;
  }
  const int n_stage = depth + 1;
  WorkItems::Cursor ahead = cur;
  int k_ahead = 0;
  for (int j = 0; j < depth; ++j, ++k_ahead) {
    if (items.valid(ahead)) {
      stage(ring + (k_ahead % n_stage) * slot_ints, items.blk(ahead));
      items.next(ahead);
    }
    cp_async_commit();
  }
  for (int k = 0; items.valid(cur); ++k, items.next(cur)) {
    if (items.valid(ahead)) {
      stage(ring + (k_ahead % n_stage) * slot_ints, items.blk(ahead));
      items.next(ahead);
    }
    cp_async_commit();
    ++k_ahead;
    cp_async_wait_prior(depth);      // item k's group has landed
    __syncthreads();                 // ... for every thread's copies
    body(cur.b, items.blk(cur),
         static_cast<const int*>(ring + (k % n_stage) * slot_ints));
    __syncthreads();                 // slot k is refilled next step
  }
  cp_async_wait<0>();
}

// The rows-block walk of the CSR kernels: body(b, blk, rows_of_blk),
// with the block's rows staged in shared memory at depth > 0.
template <class Body>
__device__ void sweep(const WorkItems& items, int b0, const int* rows,
                      int tile, int depth, int* stage, Body body) {
  sweep_items(
      items, b0, depth, tile, stage,
      [&](int* dst, int blk) {
        stage_block(dst, rows + static_cast<long long>(blk) * tile, tile);
      },
      [&](int b, int blk, const int* slot) {
        body(b, blk,
             slot ? slot : rows + static_cast<long long>(blk) * tile);
      });
}

// ---------------------------------------------------------------------------
// Block-wide reductions (every thread of the CTA must call them)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void block_sum(long long (&v)[N]) {
  __shared__ long long s_part[kWarps][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if (lane == 0) s_part[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_part[w][k];
    v[k] = t;
  }
  __syncthreads();
}

// Exclusive rank of `flag` among the CTA's threads (thread order), and
// the CTA's total.
__device__ __forceinline__ int block_rank(bool flag, int* total) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += (w < warp) ? s_warp[w] : 0;
    all += s_warp[w];
  }
  __syncthreads();
  *total = all;
  return before + __popc(m & ((1u << lane) - 1u));
}

}  // namespace bfs
