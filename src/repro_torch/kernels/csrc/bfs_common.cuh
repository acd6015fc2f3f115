// Device helpers shared by the CSR and SELL kernels.  The CSR gather
// body lives here: `owners_by_scan` + `expand_roots`, one CTA per
// rows-block of the union of the batch's work-lists, serving every root
// whose bit is set in the block's root mask, the owners of a block put
// in shared memory by one scan.  K3 and K4 (gather_expand.cu) walk a
// union the planner built (`sweep_union`), K11 (gather_relax.cu) the
// same with its own per-root step (relax_common.cuh); K5 and K6 walk a
// union they plan in their own launch (union_phases.cuh, `walk_csr`).
//
// Also here: `sweep_items`, the walk with `depth` items in flight into
// a (depth + 1)-stage ring of shared memory (`cp.async`), or read
// straight from device memory at depth 0, which the SELL kernels (K8,
// K9, K10 and K12, over the union) use with their own stage; block-wide
// sums and an exclusive scan of one flag per thread.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <stdint.h>

namespace bfs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A load of a planning word that another CTA of the same launch may
// write: `group_roots` reads by a plain load, or with kCoherent through
// L2 only (ld.global.cg) where the planning words are rewritten in the
// launch (K10).  Never the non-coherent path.
template <bool kCoherent>
__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  if constexpr (kCoherent) return __ldcg(p);
  return *p;
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

// Walk the CTA's items of a list (`UnionItems` or `LaunchUnionItems`:
// entries t = blockIdx.x, blockIdx.x + gridDim.x, ... below its count),
// calling body(blk, slot) for each.  depth == 0 passes slot = nullptr
// (the body reads device memory); depth > 0 keeps
// `depth` items' copies in flight into ring slot (k % (depth + 1)) while
// item k computes on the slot that has landed (the reference's
// `_dma_pipeline`: warm-up of `depth` copies, then one ahead per step).
// stage(dst, blk) issues item blk's cp.async copies into a slot of
// `slot_ints` ints; `ring` is (depth + 1) * slot_ints ints of dynamic
// shared memory.
template <class Items, class Stage, class Body>
__device__ __forceinline__ void sweep_items(const Items& items, int depth,
                                            int slot_ints, int* ring,
                                            Stage stage, Body body) {
  int t = blockIdx.x;
  if (depth == 0) {
    for (; t < items.count; t += gridDim.x) {
      body(items.blk(t), static_cast<const int*>(nullptr));
      __syncthreads();
    }
    return;
  }
  const int n_stage = depth + 1;
  int ahead = t;
  int k_ahead = 0;
  for (int j = 0; j < depth; ++j, ++k_ahead) {
    if (ahead < items.count) {
      stage(ring + (k_ahead % n_stage) * slot_ints, items.blk(ahead));
      ahead += gridDim.x;
    }
    cp_async_commit();
  }
  for (int k = 0; t < items.count; ++k, t += gridDim.x) {
    if (ahead < items.count) {
      stage(ring + (k_ahead % n_stage) * slot_ints, items.blk(ahead));
      ahead += gridDim.x;
    }
    cp_async_commit();
    ++k_ahead;
    cp_async_wait_prior(depth);      // item k's group has landed
    __syncthreads();                 // ... for every thread's copies
    body(items.blk(t),
         static_cast<const int*>(ring + (k % n_stage) * slot_ints));
    __syncthreads();                 // slot k is refilled next step
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The union body (K3, K4, K11): one CTA per listed block for all roots
// ---------------------------------------------------------------------------

// The union of the batch's work-lists, `count` entries (read on the
// device by the kernel from the union's count), by the non-coherent
// path: the list is an input of the launch.
struct UnionItems {
  const int* ulist;
  int count;

  __device__ int blk(int t) const { return __ldg(ulist + t); }
};

// The grid of a kernel that strides over a list: as many CTAs of
// kThreads as the card holds at once at `smem` bytes of dynamic shared
// memory (more would wait for a free slot and stretch the tail), at
// most max_grid.  The occupancy query runs once per (kernel, smem,
// device); later launches read the cache.
template <class Kernel>
__host__ cudaError_t resident_grid(Kernel kernel, size_t smem, int max_grid,
                                   int* grid) {
  struct Entry {
    const void* fn;
    size_t smem;
    int dev, full;
  };
  static Entry cache[32];
  static int n_cached = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int full = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_cached && !full; ++i)
      if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev)
        full = cache[i].full;
  }
  if (!full) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
    if (rc != cudaSuccess) return rc;
    full = per_sm * sms > 0 ? per_sm * sms : 1;
    std::lock_guard<std::mutex> lock(mu);
    if (n_cached < 32) cache[n_cached++] = Entry{fn, smem, dev, full};
  }
  *grid = full < max_grid ? full : max_grid;
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

// The union walk: body(blk, rows_of_blk), rows staged at depth > 0.
template <class Body>
__device__ void sweep_union(const UnionItems& items, const int* rows,
                            int tile, int depth, int* stage, Body body) {
  sweep_items(
      items, depth, tile, stage,
      [&](int* dst, int blk) {
        stage_block(dst, rows + static_cast<long long>(blk) * tile, tile);
      },
      [&](int blk, const int* slot) {
        body(blk, slot ? slot : rows + static_cast<long long>(blk) * tile);
      });
}

// Largest u in [0, n_cs - 1] with cs[u] <= e (cs[0] == 0 <= e), by the
// calling warp: each round probes 32 evenly spaced entries of the
// remaining range at once, so ~log32(n_cs) dependent loads (5 at
// SCALE 22) instead of log2(n_cs) (23).  Every lane returns the answer.
__device__ __forceinline__ int owner_by_warp(const int* __restrict__ cs,
                                             int n_cs, int e) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n_cs - 1;              // the answer is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + (lane + 1) * step;
    const bool ok = probe <= hi && __ldg(cs + probe) <= e;
    lo += __popc(__ballot_sync(0xffffffffu, ok)) * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// In place: a[i] = max(a[0..i]) over n shared ints, each thread scanning
// a run of consecutive entries (every thread of the CTA must call it).
__device__ __forceinline__ void block_prefix_max(int* a, int n) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, n);
  int run = -1;
  for (int i = i0; i < i1; ++i) run = max(run, a[i]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run = max(run, up);
  }
  if (lane == 31) s_warp[warp] = run;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
  for (int i = i0; i < i1; ++i) {
    before = max(before, a[i]);
    a[i] = before;
  }
  __syncthreads();
}

// own[i] = the owner of edge slot e0 + i (largest u with cs[u] <= e0 + i)
// for i < n, with no dependent global load per slot: warps 0 and 1 find
// the owners lo and hi of the first and last slot; every u in (lo, hi]
// lands on slot cs[u] - e0 (cs[u] > e0 there, so never slot 0) by a
// shared atomicMax (zero-degree vertices share a colstarts value, and
// the owner is the largest); slot 0 takes lo; a prefix max fills the
// rest.  The colstarts reads over (lo, hi] are coalesced, however long
// the range (runs of isolated vertices).  Past the last edge the owner
// is n_cs - 1 (== V), the sentinel tail.  Every thread must call it.
__device__ __forceinline__ void owners_by_scan(const int* __restrict__ cs,
                                               int n_cs, int e0, int n,
                                               int* own) {
  __shared__ int s_range[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int r = owner_by_warp(cs, n_cs, warp == 0 ? e0 : e0 + n - 1);
    if ((threadIdx.x & 31) == 0) s_range[warp] = r;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) own[i] = -1;
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  if (threadIdx.x == 0) own[0] = lo;
  for (int u = lo + 1 + threadIdx.x; u <= hi; u += blockDim.x)
    atomicMax(own + (__ldg(cs + u) - e0), u);
  __syncthreads();
  block_prefix_max(own, n);
}

// A word of the state a union walk reads and no CTA writes during it:
// kReadOnly, state the launch never writes (K3's inputs), by the
// non-coherent path; else state an earlier phase of the same launch
// wrote before a grid barrier (K5's, K6's, K9's and K10's masks, list
// and interleaved bitmaps) by a plain load, which may hit L1 and which
// the barrier orders after those writes: the grid barrier's acquire
// (`ld.acquire.gpu`) invalidates the SM's L1 (`CCTL.IVALL` in the
// SASS), so a line an earlier layer of K6 or K10 cached there is not
// read again.  The launch writes that state, so nvcc keeps the plain
// load off the non-coherent path (ld.global, LDG.E); `__ldca` would
// give a strong SM-scope load (LDG.E.STRONG.SM), which ran K9 2.2
// times slower.
template <bool kReadOnly>
__device__ __forceinline__ unsigned ld_walk(const unsigned* p) {
  if constexpr (kReadOnly) return __ldg(p);
  return *p;
}

// The racy gather-expand over n slots of one block for every root whose
// bit is set in `mask` (n_mask_words words): slot i has owner own[i] and
// neighbour rows_sub[i].  Per root: the gate's frontier bit, the
// `visited | out` test, the negative P mark and the racy out word write
// (paper §3.3.2); with kScalarArm (K6), a `scalar` layer tests the
// pre-layer visited alone (the reference's `_gather_tile_dyn`).  The
// bitmaps are root-interleaved, (n_words, B): root b's word w is at
// w * n_batch + b, so the B words of one vertex share a sector.  The
// owner side of each test goes first (the gate top-down, the candidate
// bottom-up): it is the same word for a run of slots, so a root it
// rules out costs no load of the random side.  P stays (B, v_pad).
// mask, fr and vis are read by `ld_walk<kReadOnly>` (K3: read-only
// inputs; K5, K6: written in the launch before its walk).
template <bool kReadOnly = true, bool kScalarArm = false>
__device__ __forceinline__ void expand_roots(
    const int* rows_sub, const int* own, int n,
    const unsigned* __restrict__ mask, int n_mask_words,
    const unsigned* __restrict__ fr, const unsigned* __restrict__ vis,
    unsigned* out, int* p, long long n_batch, long long v_pad,
    int n_vertices, bool bottom_up, bool scalar = false) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int u = own[i];
    const int v = rows_sub[i];
    if (u >= n_vertices || v >= n_vertices) continue;   // sentinel tail
    const int gate = bottom_up ? v : u;
    const int cand = bottom_up ? u : v;
    const unsigned* fg = fr + (gate >> 5) * n_batch;
    const unsigned* vc = vis + (cand >> 5) * n_batch;
    unsigned* oc = out + (cand >> 5) * n_batch;
    const unsigned gbit = 1u << (gate & 31), cbit = 1u << (cand & 31);
    for (int k = 0; k < n_mask_words; ++k) {
      for (unsigned m = ld_walk<kReadOnly>(mask + k); m; m &= m - 1) {
        const int b = 32 * k + __ffs(m) - 1;
        if (!bottom_up && !(ld_walk<kReadOnly>(fg + b) & gbit)) continue;
        const unsigned ow = oc[b];                         // racy read
        const unsigned seen = kScalarArm && scalar ? 0u : ow;
        if ((ld_walk<kReadOnly>(vc + b) | seen) & cbit) continue;
        if (bottom_up && !(ld_walk<kReadOnly>(fg + b) & gbit)) continue;
        p[b * v_pad + cand] = gate - n_vertices;           // negative mark
        oc[b] = ow | cbit;                                 // racy write
      }
    }
  }
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
