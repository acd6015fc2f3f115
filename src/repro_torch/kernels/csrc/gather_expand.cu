// K3: fused work-listed CSR gather + racy expand for Hopper.
//
// Replaces: src/repro/kernels/gather_expand.py, `gather_expand_batched`
// with prefetch_depth = 0 (Pallas body `_gather_batched_kernel` ->
// `_gather_tile` -> `_owner_search` + frontier_expand.`_expand_tile`)
// and, at B = 1, `gather_expand` (`_gather_kernel`).
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
// dependent loads.  Each active block moves tile * 4 bytes of `rows`
// (coalesced), the colstarts entries its owners span, and one 4-byte
// bitmap word gather per edge for the gate, the visited and the out
// test; plus 4 bytes of P per discovery.  colstarts (16.8 MB at
// SCALE 22) and the bitmaps (0.5 MB per root) stay in the 50 MB L2.
// Design against the latency: thread 0 of the CTA finds the block's
// first and last owner by a binary search over all of colstarts, once
// per block; every thread then searches only that narrow owner range,
// ~log2(tile / mean degree) dependent loads instead of ~23.  The grid
// is (CTAs, B) with CTAs striding over the work-list, and n_active is
// read on the device, so no host sync is needed and a root with an
// empty work-list costs one load.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Largest u in [lo, hi] with cs[u] <= e, given cs[lo] <= e.
__device__ __forceinline__ int owner_in(const int* __restrict__ cs, int lo,
                                        int hi, int e) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (cs[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void gather_expand_kernel(
    const int* __restrict__ wl, const int* __restrict__ na,
    const int* __restrict__ rows, const int* __restrict__ cs,
    const unsigned* __restrict__ frontier,
    const unsigned* __restrict__ visited, unsigned* out, int* p,
    int n_blocks, int tile, int n_cs, int n_words, int v_pad,
    int n_vertices, int bottom_up) {
  const int b = blockIdx.y;
  const int n_act = na[b];
  const int* wl_b = wl + (long long)b * n_blocks;
  const unsigned* fr = frontier + (long long)b * n_words;
  const unsigned* vis = visited + (long long)b * n_words;
  unsigned* ob = out + (long long)b * n_words;
  int* pb = p + (long long)b * v_pad;
  __shared__ int s_lo, s_hi;

  for (int t = blockIdx.x; t < n_act; t += gridDim.x) {
    const int e0 = wl_b[t] * tile;
    if (threadIdx.x == 0) {
      const int lo = owner_in(cs, 0, n_cs - 1, e0);
      s_lo = lo;
      s_hi = owner_in(cs, lo, n_cs - 1, e0 + tile - 1);
    }
    __syncthreads();
    const int lo = s_lo, hi = s_hi;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int e = e0 + i;
      const int u = owner_in(cs, lo, hi, e);
      const int v = rows[e];
      if (u >= n_vertices || v >= n_vertices) continue;  // sentinel tail
      const int gate = bottom_up ? v : u;
      const int cand = bottom_up ? u : v;
      if (!((fr[gate >> 5] >> (gate & 31)) & 1u)) continue;
      const int w = cand >> 5;
      const unsigned bit = 1u << (cand & 31);
      const unsigned ow = ob[w];                     // racy read
      if ((vis[w] | ow) & bit) continue;
      pb[cand] = gate - n_vertices;                   // negative mark
      ob[w] = ow | bit;                               // racy write
    }
    __syncthreads();           // s_lo / s_hi are rewritten next block
  }
}

}  // namespace

// wl: (B, n_blocks) int32; na: (B,) int32; rows: (n_blocks * tile,)
// int32; cs: (n_cs,) int32; frontier, visited, out: (B, n_words)
// 32-bit words; p: (B, v_pad) int32.  out and p are updated in place.
extern "C" int repro_gather_expand(
    const void* wl, const void* na, const void* rows, const void* cs,
    const void* frontier, const void* visited, void* out, void* p,
    int n_batch, int n_blocks, int tile, int n_cs, int n_words, int v_pad,
    int n_vertices, int bottom_up, int grid_x, void* stream) {
  if (n_batch == 0 || n_blocks == 0 || grid_x <= 0) return 0;
  dim3 grid(grid_x, n_batch);
  gather_expand_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)wl, (const int*)na, (const int*)rows, (const int*)cs,
      (const unsigned*)frontier, (const unsigned*)visited, (unsigned*)out,
      (int*)p, n_blocks, tile, n_cs, n_words, v_pad, n_vertices,
      bottom_up);
  return (int)cudaGetLastError();
}
