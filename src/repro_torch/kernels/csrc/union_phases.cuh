// The union of a batch's work-lists, planned and walked on the card,
// shared by the union planner (plan_union.cu, two launches), the
// one-launch layer kernels K5 (layer_fused.cu, CSR rows-blocks) and K9
// (sell_layer_fused.cu, SELL-C-σ slab groups), the whole-traversal
// kernels K6 (traversal_fused.cu) and K10 (sell_traversal_fused.cu),
// which run the same phases in every layer of their loop
// (traversal_loop.cuh), so that the planner and the kernels cannot
// drift apart, and K8 (sell_expand.cu), which walks the planner's union
// with K9's body.
//
// Planning, in a CTA's contiguous chunk of items (`chunk_of_cta`):
//
// * union_masks_csr / union_masks_sell: one root-mask word per (item,
//   32 roots), bit j of word k set when root 32 k + j lists the item:
//   CSR, `covered` (an active vertex of degree > 0 in the block's owner
//   range, fused_phases.cuh); SELL, `group_roots` (one warp reads a
//   group's slab_rows once for 32 roots, sell_phases.cuh; through L2
//   where the launch rewrites the planning words, K10).
// * union_counts: the chunk's listed items per root and for "any root"
//   (row B of `cnt`).
// * union_write, after a grid barrier (K5, K6, K9, K10) or in a second
//   launch (the planner): each CTA sums the "any root" counts of the
//   CTAs before it and writes its chunk's listed items there, ranked by
//   a block scan, so the list is ascending; the tail is zeroed and CTA 0
//   sums each root's count.  No atomics on the outputs: deterministic.
//
// The walk: a CTA per union item for every root of its mask, over
// `sweep_items` (a cp.async ring at depth > 0).
//
// * walk_csr (K5, K6): per slot of a rows-block, with its owner from
//   the block's shared-memory owner scan (`owners_by_scan`), K3's
//   `expand_roots` for each root of the mask (bfs_common.cuh).
// * walk_csr_bottom_up (K6's bottom-up layers): per vertex whose list
//   starts in a listed rows-block (or piece of a long list), a group of
//   lanes scans its neighbours until each pending root has its first
//   frontier parent (the per-root break).
// * sweep_sell over sell_group_union (K8 over the planner's list,
//   `walk_sell` for K9 and K10 over the list of their launch): per lane
//   of a slab group, its row and 8 neighbours read once; the roots of
//   the mask whose owner side passes (the row in the frontier top-down,
//   the row unvisited bottom-up) run inside the neighbour loop, so a
//   random neighbour's word serves every root.  Bottom-up, a root is
//   done with the row at its first frontier neighbour, whose id P takes
//   (the per-root break).
//
// The walk's per-root state is root-interleaved, (n_words, B) (root b's
// word w at w * B + b: the B words of one vertex share a sector).  K5
// and K9 copy frontier and visited from their (B, n_words) rows into
// scratch in their first phase and copy the discoveries back to rows in
// the restore phase (`stage_state`, `restore_union`); K6 and K10 keep
// both layouts across their layers (traversal_loop.cuh); K8's wrapper
// hands it interleaved copies.  Loads: the planning phases read what
// other CTAs wrote in the same phase or the one before through L2 only
// (ld.global.cg); the walk reads the state that no CTA writes during it
// (the masks, the list and the interleaved copies, written before its
// grid barrier) with loads that may hit L1 (`ld_walk<false>`, which the
// barrier orders; K8, whose launch never writes them, by the
// non-coherent path, `ld_walk<true>`), so that the B roots of one
// vertex's sector miss once; and the racy `out` as K3 does, with plain
// loads: a stale word only costs a duplicate mark, which restoration
// absorbs.
#pragma once

#include <cuda_runtime.h>

#include "sell_phases.cuh"

namespace bfs {

// A load of data the calling kernel may have written earlier in the same
// launch (kCoherent: ld.global.cg) or never writes (the non-coherent
// path).
template <bool kCoherent, class T>
__device__ __forceinline__ T ld_state(const T* p) {
  if constexpr (kCoherent) return __ldcg(p);
  return __ldg(p);
}

// ---------------------------------------------------------------------------
// Planning
// ---------------------------------------------------------------------------

// Root masks of the CSR rows-blocks [begin, end), one thread per block.
// `words`: (B, n_words) planning bitmaps (complemented when
// `complement`); kSeeded: every block starts from the n_mask_words
// words of m0 (the planner's dense roots, in shared memory), else from
// none (m0 unused).
template <bool kSeeded>
__device__ __forceinline__ void union_masks_csr(
    const FusedGraph& g, const unsigned* __restrict__ words,
    bool complement, int n_batch, const unsigned* __restrict__ m0,
    unsigned* rmask, int begin, int end) {
  const int n_mask_words = (n_batch + 31) >> 5;
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    for (int k = 0; k < n_mask_words; ++k) {
      unsigned m = kSeeded ? m0[k] : 0u;
      const int nb = min(32, n_batch - 32 * k);
      for (int j = 0; j < nb; ++j) {
        if ((m >> j) & 1u) continue;
        const unsigned* act =
            words + static_cast<long long>(32 * k + j) * g.n_words;
        if (covered(g, act, complement, i)) m |= 1u << j;
      }
      rmask[static_cast<long long>(i) * n_mask_words + k] = m;
    }
  }
}

// Root masks of the slab groups [begin, end), one warp per group;
// kCoherent reads the planning words through L2 (K10 rewrites them
// between layers), else by a plain load.
template <bool kSeeded, bool kCoherent = false>
__device__ __forceinline__ void union_masks_sell(
    const SellGraph& g, const unsigned* __restrict__ words,
    bool complement, int n_batch, const unsigned* __restrict__ m0,
    unsigned* rmask, int begin, int end) {
  const int n_mask_words = (n_batch + 31) >> 5;
  for (int grp = begin + (threadIdx.x >> 5); grp < end; grp += kWarps) {
    for (int k = 0; k < n_mask_words; ++k) {
      const int b0 = 32 * k, nb = min(32, n_batch - b0);
      const unsigned m = (kSeeded ? m0[k] : 0u) |
                         group_roots<kCoherent>(g, words, complement, b0,
                                                nb, grp);
      if ((threadIdx.x & 31) == 0)
        rmask[static_cast<long long>(grp) * n_mask_words + k] = m;
    }
  }
}

// The chunk's counts from the masks this CTA just wrote: cnt[b * grid +
// cta] for each root b, cnt[B * grid + cta] for the items any root
// lists.
__device__ __forceinline__ void union_counts(const unsigned* rmask,
                                             int n_mask_words, int n_batch,
                                             int begin, int end, int* cnt) {
  __syncthreads();                  // this CTA's masks are visible to it
  for (int b = 0; b <= n_batch; ++b) {
    long long s[1] = {0};
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const unsigned* m = rmask + static_cast<long long>(i) * n_mask_words;
      if (b < n_batch) {
        s[0] += (__ldcg(m + (b >> 5)) >> (b & 31)) & 1u;
      } else {
        unsigned any = 0;
        for (int k = 0; k < n_mask_words; ++k) any |= __ldcg(m + k);
        s[0] += any != 0;
      }
    }
    block_sum(s);
    if (threadIdx.x == 0) cnt[b * gridDim.x + blockIdx.x] = int(s[0]);
  }
}

// The ascending union list, its count, the tail's zeros and each root's
// count, on the grid that wrote `cnt` (kCoherent: in the same launch).
template <bool kCoherent>
__device__ __forceinline__ void union_write(
    const unsigned* __restrict__ rmask, const int* __restrict__ cnt,
    int* ulist, int* ucount, int* na, int n_items, int n_batch) {
  const int n_mask_words = (n_batch + 31) >> 5;
  const int grid = gridDim.x;
  if (blockIdx.x == 0) {            // each root's count, a warp per root
    const int lane = threadIdx.x & 31;
    for (int b = threadIdx.x >> 5; b < n_batch; b += kWarps) {
      int s = 0;
      for (int c = lane; c < grid; c += 32)
        s += ld_state<kCoherent>(cnt + b * grid + c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) na[b] = s;
    }
  }
  long long s[2] = {0, 0};          // CTAs before this one, all CTAs
  for (int c = threadIdx.x; c < grid; c += blockDim.x) {
    const int v = ld_state<kCoherent>(cnt + n_batch * grid + c);
    s[1] += v;
    if (c < static_cast<int>(blockIdx.x)) s[0] += v;
  }
  block_sum(s);
  const int total = int(s[1]);
  if (blockIdx.x == 0 && threadIdx.x == 0) *ucount = total;
  int begin, end;
  chunk_of_cta(n_items, &begin, &end);
  int off = int(s[0]);
  for (int base = begin; base < end; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool listed = false;
    if (i < end)
      for (int k = 0; k < n_mask_words; ++k)
        listed |= ld_state<kCoherent>(
                      rmask + static_cast<long long>(i) * n_mask_words +
                      k) != 0;
    int chunk_total;
    const int r = block_rank(listed, &chunk_total);
    if (listed) ulist[off + r] = i;
    off += chunk_total;
  }
  for (int q = begin + threadIdx.x; q < end; q += blockDim.x)
    if (q >= total) ulist[q] = 0;
}

// ---------------------------------------------------------------------------
// The walk of the union (K5, K6, K9, K10)
// ---------------------------------------------------------------------------

// The scratch of a walk of the union planned in the launch.
struct UnionBuffers {
  unsigned* out;    // (B, n_words): K5's, K9's discoveries, repaired
  unsigned* rmask;  // (n_items, ceil(B / 32)) root masks
  int* ulist;       // (n_items,) the union, ascending, then zeros
  int* ucount;      // (1,) its length
  int* cnt;         // (B + 1, gridDim.x) per-CTA counts
  int* na;          // (B,) each root's count
  unsigned* fi;     // (n_words, B) interleaved frontier, visited and
  unsigned* vi;     // racy discoveries
  unsigned* oi;
};

// `UnionItems` over a list written earlier in the same launch, before a
// grid barrier.
struct LaunchUnionItems {
  const int* ulist;
  int count;

  __device__ int blk(int t) const { return ulist[t]; }
};

// The first phase's state: frontier and visited copied from (B, n_words)
// to (n_words, B), the interleaved discoveries zeroed.
__device__ __forceinline__ void stage_state(const unsigned* frontier,
                                            const unsigned* visited,
                                            const UnionBuffers& buf,
                                            int n_batch, int n_words) {
  const int stride = gridDim.x * blockDim.x;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < n_words;
       w += stride) {
    for (int b = 0; b < n_batch; ++b) {
      const long long r = static_cast<long long>(b) * n_words + w;
      const long long i = static_cast<long long>(w) * n_batch + b;
      buf.fi[i] = __ldg(frontier + r);
      buf.vi[i] = __ldg(visited + r);
      buf.oi[i] = 0u;
    }
  }
}

// K8's, K9's and K10's body over one slab group for every root of
// `mask`.  cols_g / rows_g point at the group's cols and slab_rows, in
// device or shared memory; mask, fr and vis are read by
// `ld_walk<kReadOnly>` (K8: inputs of the launch; K9, K10: written in
// the launch before its walk), and the bitmaps are root-interleaved as
// in `expand_roots`.  Sentinel rows and columns (== V) never index P or
// a bitmap.
template <bool kReadOnly = false>
__device__ __forceinline__ void sell_group_union(
    const int* cols_g, const int* rows_g, int spp, const unsigned* mask,
    int n_mask_words, const unsigned* fr, const unsigned* vis,
    unsigned* out, int* p, long long n_batch, long long v_pad,
    int n_vertices, bool bottom_up) {
  const int n_lanes = spp * kSliceC;
  for (int i = threadIdx.x; i < n_lanes; i += blockDim.x) {
    const int row = rows_g[i];
    if (row >= n_vertices) continue;                  // sentinel row
    const int* c = cols_g + (i >> 7) * kSlabInts + (i & (kSliceC - 1));
    const long long rw = (row >> 5) * n_batch;
    const unsigned rbit = 1u << (row & 31);
    int nbr[kWQuant];
    bool loaded = false;
    for (int k = 0; k < n_mask_words; ++k) {
      // the roots of the mask whose owner side passes: the row in the
      // frontier top-down, the row unvisited bottom-up
      unsigned live = 0;
      for (unsigned m = ld_walk<kReadOnly>(mask + k); m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const long long ri = rw + 32 * k + j;
        const bool pass = bottom_up
                              ? !(ld_walk<kReadOnly>(vis + ri) & rbit)
                              : (ld_walk<kReadOnly>(fr + ri) & rbit) != 0;
        if (pass) live |= 1u << j;
      }
      if (!live) continue;
      if (!loaded) {
#pragma unroll
        for (int q = 0; q < kWQuant; ++q) nbr[q] = c[q * kSliceC];
        loaded = true;
      }
      // neighbour-major: a neighbour's words serve every live root
#pragma unroll
      for (int q = 0; q < kWQuant; ++q) {
        const int nb = nbr[q];
        if (nb >= n_vertices || !live) continue;      // sentinel column
        const long long nw = (nb >> 5) * n_batch;
        const unsigned nbit = 1u << (nb & 31);
        for (unsigned m = live; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int b = 32 * k + j;
          if (!bottom_up) {
            const unsigned ow = out[nw + b];              // racy read
            if ((ld_walk<kReadOnly>(vis + nw + b) | ow) & nbit) continue;
            p[b * v_pad + nb] = row - n_vertices;         // negative mark
            out[nw + b] = ow | nbit;                      // racy write
          } else {
            if (!(ld_walk<kReadOnly>(fr + nw + b) & nbit)) continue;
            const unsigned ow = out[rw + b];
            if (!(ow & rbit)) {
              p[b * v_pad + row] = nb - n_vertices;
              out[rw + b] = ow | rbit;
            }
            live &= ~(1u << j);  // root b's row is discovered: stop
          }
        }
      }
    }
  }
}

// K5's and K6's walk: one CTA per block of the union written earlier
// in the launch, for every root of its mask.  `smem`: the rows ring at
// depth > 0 ((depth + 1) * tile ints), then `own`, `sub` owner slots
// (the caller points `own` there; K5 does so at its start, as before
// its walk moved here, which keeps its SASS).  kScalarArm: a `scalar`
// layer tests the pre-layer visited alone (K6).
template <bool kScalarArm = false>
__device__ __forceinline__ void walk_csr(const FusedGraph& g,
                                         const UnionBuffers& buf, int* p,
                                         int n_batch, bool bottom_up,
                                         int depth, int sub, int* smem,
                                         int* own, bool scalar = false) {
  const int n_mask_words = (n_batch + 31) >> 5;
  const LaunchUnionItems items{buf.ulist, __ldcg(buf.ucount)};
  sweep_items(
      items, depth, g.tile, smem,
      [&](int* dst, int blk) {
        stage_block(dst, g.rows + static_cast<long long>(blk) * g.tile,
                    g.tile);
      },
      [&](int blk, const int* slot) {
        const int* rows_blk =
            slot ? slot : g.rows + static_cast<long long>(blk) * g.tile;
        const unsigned* mask =
            buf.rmask + static_cast<long long>(blk) * n_mask_words;
        for (int s0 = 0; s0 < g.tile; s0 += sub) {
          const int n = min(sub, g.tile - s0);
          owners_by_scan(g.cs, g.n_cs, blk * g.tile + s0, n, own);
          expand_roots<false, kScalarArm>(
              rows_blk + s0, own, n, mask, n_mask_words, buf.fi, buf.vi,
              buf.oi, p, n_batch, g.v_pad, g.n_vertices, bottom_up, scalar);
          if (s0 + sub < g.tile) __syncthreads();   // own is rewritten
        }
      });
}

// K6's bottom-up walk, vertex-major: each root of a vertex stops at the
// vertex's first frontier neighbour (Beamer's early exit), which the
// slot walk above cannot do, since the slots of one vertex test the
// racy `out` in lockstep.  The planning is K5's, unchanged.
//
// Units.  A listed rows-block hands out the vertices whose first slot
// lies in it, each scanned over its whole list (which may run past the
// block's end), and, of a vertex of degree above kBuPiece, the pieces
// of kBuPiece slots that start in it (from the vertex's first slot), so
// that a hub's list is spread over groups and warps and no group holds
// the grid at the barrier.  Every listed block's owner range holds each
// vertex it has slots of (`covered`), so an unvisited vertex of degree
// > 0 is listed for its roots in every block its list spans: each slot
// is scanned once.  A unit keeps the roots of the block's mask for
// which the vertex is unvisited (the pieces of a long list also drop
// those another piece has already found).
//
// Work.  Each warp takes its own listed blocks (no CTA barrier in the
// walk, so a long unit holds one warp, not the CTA): its lanes read the
// owner range a vertex each, up to 32 at a time.  A lane scans a list
// of at most kBuShort neighbours alone, its ids loaded at once, testing
// them in order until no root is pending (most vertices of a skewed
// graph have such lists, and a group would leave most of its lanes
// idle on them); the other units' counts, first slots and pending roots
// go to the warp's slice of shared memory, and its groups of kBuLanes
// lanes take them in turn.
//
// Scan.  A group tests kBuLanes neighbours a step: each lane loads its
// neighbour's words of the pending roots (one sector of the
// interleaved state at B <= 8, two 16-byte loads), a prefix OR over
// the group gives each root found to its first lane in list order,
// which writes the negative P mark and the root's `out` bit
// (`atomicOr`, so every mark has its bit, as `update_state`'s
// restoration needs), and the group drops the roots found; the unit
// ends when no root is pending or its list is done.  The next step's
// neighbour ids are loaded a step ahead, and a unit's first ones are
// prefetched into L2 when the unit is found.
//
// walked (kTraced only, may be null): [0] += the neighbour entries
// tested, [1] += the slots of the listed blocks walked (padding left
// out), the walk's examined share.
constexpr int kBuLanes = 8;
constexpr int kBuPiece = 128;
constexpr int kBuShort = 4;

// Bit `bit` of each word at[j] for the roots j of `want` (j < nb), as a
// root set; vec4 (B a multiple of 4, the state 16-byte aligned) reads 8
// roots' words by two 16-byte loads at once.
__device__ __forceinline__ unsigned root_bits(const unsigned* at,
                                              unsigned want, int nb,
                                              bool vec4, int bit) {
  unsigned got = 0u;
  if (vec4) {
    for (int j0 = 0; j0 < nb; j0 += 8) {
      const unsigned w8 = (want >> j0) & 0xffu;
      if (!w8) continue;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), c = a;
      if (w8 & 0xfu) a = *reinterpret_cast<const uint4*>(at + j0);
      if (w8 >> 4) c = *reinterpret_cast<const uint4*>(at + j0 + 4);
      const unsigned m = ((a.x >> bit) & 1u) | ((a.y >> bit) & 1u) << 1 |
                         ((a.z >> bit) & 1u) << 2 | ((a.w >> bit) & 1u) << 3 |
                         ((c.x >> bit) & 1u) << 4 | ((c.y >> bit) & 1u) << 5 |
                         ((c.z >> bit) & 1u) << 6 | ((c.w >> bit) & 1u) << 7;
      got |= m << j0;
    }
    return got & want;
  }
  for (unsigned m = want; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    got |= ((ld_walk<false>(at + j) >> bit) & 1u) << j;
  }
  return got;
}

// K6's bottom-up walk over the union written earlier in the launch, a
// warp per listed block; `smem` (`n_ints` ints, K6's dynamic shared
// memory, whose ring and owner slots the walk does not use) holds each
// warp's records of up to 32 vertices (4 ints each).
template <bool kTraced>
__device__ __forceinline__ void walk_csr_bottom_up(
    const FusedGraph& g, const UnionBuffers& buf, int* p, int n_batch,
    int* smem, int n_ints, unsigned long long* walked) {
  const int n_mask_words = (n_batch + 31) >> 5;
  const long long B = n_batch;
  const int count = __ldcg(buf.ucount);
  const int n_edges = __ldg(g.cs + g.n_cs - 1);
  const bool vec4 =
      (n_batch & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(buf.fi) |
        reinterpret_cast<uintptr_t>(buf.vi) |
        reinterpret_cast<uintptr_t>(buf.oi)) & 15) == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & (kBuLanes - 1), grp = lane / kBuLanes;
  const unsigned gmask = (0xffffffffu >> (32 - kBuLanes))
                         << (lane & ~(kBuLanes - 1));
  // this warp's records: vertex, first unit's slot, pending roots and
  // the exclusive prefix of the unit counts
  const int chunk = min(32, n_ints / (4 * kWarps));
  int* rec_u = smem + warp * 4 * chunk;
  int* rec_s = rec_u + chunk;
  unsigned* rec_p = reinterpret_cast<unsigned*>(rec_s + chunk);
  int* rec_off = rec_s + 2 * chunk;
  unsigned long long examined = 0, slots = 0;
  for (int t = blockIdx.x * kWarps + warp; t < count;
       t += gridDim.x * kWarps) {
    const int blk = buf.ulist[t];
    const int b0 = blk * g.tile, b1 = b0 + g.tile;
    const int lo = __ldg(g.blk_lo + blk);
    const int hi = min(__ldg(g.blk_hi + blk), g.n_vertices - 1);
    if constexpr (kTraced)
      if (lane == 0) slots += max(0, min(g.tile, n_edges - b0));
    for (int k = 0; k < n_mask_words; ++k) {
      const unsigned mask = ld_walk<false>(
          buf.rmask + static_cast<long long>(blk) * n_mask_words + k);
      if (!mask) continue;
      const int nb = min(32, n_batch - 32 * k);
      for (int u0 = lo; u0 <= hi; u0 += chunk) {
        // a lane per vertex: its units that start in the block
        const int u = u0 + lane;
        int n = 0, s = 0;
        unsigned pending = 0u;
        if (lane < chunk && u <= hi) {
          const int c0 = __ldg(g.cs + u), c1 = __ldg(g.cs + u + 1);
          const int d = c1 - c0;
          s = c0;
          if (d > kBuPiece && s < b0)
            s += (b0 - c0 + kBuPiece - 1) / kBuPiece * kBuPiece;
          if (d > 0 && s >= b0 && s < b1 && s < c1) {
            const long long uw = (u >> 5) * B + 32 * k;
            pending = mask & ~root_bits(buf.vi + uw, mask, nb, vec4, u & 31);
            if (pending && d > kBuPiece)
              pending &= ~root_bits(buf.oi + uw, pending, nb, vec4, u & 31);
            if (pending && d <= kBuShort) {
              // a short list: this lane scans it alone, its ids first
              int nbr[kBuShort];
#pragma unroll
              for (int j = 0; j < kBuShort; ++j)
                nbr[j] = j < d ? __ldg(g.rows + c0 + j) : -1;
#pragma unroll
              for (int j = 0; j < kBuShort; ++j) {
                if (nbr[j] < 0 || !pending) continue;
                const int v = nbr[j];
                const unsigned hit = root_bits(
                    buf.fi + (v >> 5) * B + 32 * k, pending, nb, vec4,
                    v & 31);
                if constexpr (kTraced) ++examined;
                for (unsigned m = hit; m; m &= m - 1) {
                  const int r = __ffs(m) - 1;
                  p[static_cast<long long>(32 * k + r) * g.v_pad + u] =
                      v - g.n_vertices;
                  atomicOr(buf.oi + uw + r, 1u << (u & 31));
                }
                pending &= ~hit;
              }
            } else if (pending) {
              n = d > kBuPiece
                      ? (min(b1, c1) - s + kBuPiece - 1) / kBuPiece
                      : 1;
              asm volatile("prefetch.global.L2 [%0];" ::"l"(g.rows + s));
            }
          }
        }
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        if (!total) continue;
        if (lane < chunk) {
          rec_u[lane] = u;
          rec_s[lane] = s;
          rec_p[lane] = pending;
          rec_off[lane] = incl - n;
        }
        __syncwarp();
        for (int i = grp; i < total; i += 32 / kBuLanes) {
          // the record that holds unit i: the last whose offset <= i
          int r = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (r + step < chunk && rec_off[r + step] <= i) r += step;
          const int uu = rec_u[r];
          int e0 = rec_s[r] + (i - rec_off[r]) * kBuPiece;
          unsigned left = rec_p[r];
          const int end = min(e0 + kBuPiece, __ldg(g.cs + uu + 1));
          const long long uw = (uu >> 5) * B + 32 * k;
          const unsigned ubit = 1u << (uu & 31);
          int v_next = e0 + q < end ? __ldg(g.rows + e0 + q) : -1;
          for (; left && e0 < end; e0 += kBuLanes) {
            const int v = v_next;
            v_next = e0 + kBuLanes + q < end
                         ? __ldg(g.rows + e0 + kBuLanes + q)
                         : -1;
            unsigned hit = 0u;
            if (v >= 0) {
              hit = root_bits(buf.fi + (v >> 5) * B + 32 * k, left, nb,
                              vec4, v & 31);
              if constexpr (kTraced) ++examined;
            }
            // the roots found by a lane before this one, and by any
            unsigned incl_hit = hit;
#pragma unroll
            for (int o = 1; o < kBuLanes; o <<= 1) {
              const unsigned y =
                  __shfl_up_sync(gmask, incl_hit, o, kBuLanes);
              if (q >= o) incl_hit |= y;
            }
            unsigned before = __shfl_up_sync(gmask, incl_hit, 1, kBuLanes);
            if (q == 0) before = 0u;
            const unsigned all =
                __shfl_sync(gmask, incl_hit, kBuLanes - 1, kBuLanes);
            for (unsigned m = hit & ~before; m; m &= m - 1) {
              const int j = __ffs(m) - 1;
              p[static_cast<long long>(32 * k + j) * g.v_pad + uu] =
                  v - g.n_vertices;
              atomicOr(buf.oi + uw + j, ubit);
            }
            left &= ~all;
          }
        }
        __syncwarp();                   // the records are rewritten
      }
    }
  }
  if constexpr (kTraced) {
    if (walked != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        examined += __shfl_down_sync(0xffffffffu, examined, o);
        slots += __shfl_down_sync(0xffffffffu, slots, o);
      }
      if (lane == 0) {
        if (examined) atomicAdd(walked, examined);
        if (slots) atomicAdd(walked + 1, slots);
      }
    }
  }
}

// The SELL walk: one CTA per slab group of `items` (the planner's union,
// `UnionItems`, for K8; the one written earlier in the launch,
// `LaunchUnionItems`, for K9 and K10), for every root of its mask, on
// root-interleaved bitmaps; `ring` holds (depth + 1) slots of a group's
// cols and slab_rows at depth > 0.
template <bool kReadOnly, class Items>
__device__ __forceinline__ void sweep_sell(const SellGraph& g,
                                           const Items& items,
                                           const unsigned* rmask,
                                           const unsigned* fi,
                                           const unsigned* vi, unsigned* oi,
                                           int* p, int n_batch,
                                           bool bottom_up, int depth,
                                           int* ring) {
  const int n_mask_words = (n_batch + 31) >> 5;
  const int cols_ints = g.spp * kSlabInts;
  const int rows_ints = g.spp * kSliceC;
  sweep_items(
      items, depth, cols_ints + rows_ints, ring,
      [&](int* dst, int grp) {
        stage_block(dst, g.cols + static_cast<long long>(grp) * cols_ints,
                    cols_ints);
        stage_block(dst + cols_ints,
                    g.slab_rows + static_cast<long long>(grp) * rows_ints,
                    rows_ints);
      },
      [&](int grp, const int* slot) {
        const int* cols_g =
            slot ? slot : g.cols + static_cast<long long>(grp) * cols_ints;
        const int* rows_g =
            slot ? slot + cols_ints
                 : g.slab_rows + static_cast<long long>(grp) * rows_ints;
        sell_group_union<kReadOnly>(
            cols_g, rows_g, g.spp,
            rmask + static_cast<long long>(grp) * n_mask_words,
            n_mask_words, fi, vi, oi, p, n_batch, g.v_pad, g.n_vertices,
            bottom_up);
      });
}

// K9's and K10's walk: `sweep_sell` over the union written earlier in
// the launch.
__device__ __forceinline__ void walk_sell(const SellGraph& g,
                                          const UnionBuffers& buf, int* p,
                                          int n_batch, bool bottom_up,
                                          int depth, int* ring) {
  const LaunchUnionItems items{buf.ulist, __ldcg(buf.ucount)};
  sweep_sell<false>(g, items, buf.rmask, buf.fi, buf.vi, buf.oi, p, n_batch,
                    bottom_up, depth, ring);
}

// The last phase: restore P and write `out` (rows) from the interleaved
// discoveries with the delta ORed in.  A
// warp restores 4 words (128 P entries) of a root per step, 4 entries a
// lane by one 16-byte load, so that each warp keeps 512 bytes in
// flight; the 8 lanes of a word OR their 4-bit pieces of its delta
// together.  G has n_words, v_pad and n_vertices (v_pad = 32 n_words).
template <class G>
__device__ __forceinline__ void restore_union(const G& g, int* p,
                                              const UnionBuffers& buf,
                                              int n_batch) {
  const int lane = threadIdx.x & 31;
  const int piece = lane & 7;           // the lane's 4 entries of its word
  const long long n_steps = (g.n_words + 3) / 4;
  for (int b = 0; b < n_batch; ++b) {
    int* pb = p + static_cast<long long>(b) * g.v_pad;
    const long long ob = static_cast<long long>(b) * g.n_words;
    for (long long s = grid_warp(); s < n_steps; s += grid_warps()) {
      const long long w = 4 * s + (lane >> 3);
      const bool live = w < g.n_words;
      int4* at = reinterpret_cast<int4*>(pb + w * 32 + 4 * piece);
      int4 v = live ? __ldcg(at) : make_int4(0, 0, 0, 0);
      const unsigned m = (v.x < 0) | (v.y < 0) << 1 | (v.z < 0) << 2 |
                         (v.w < 0) << 3;
      if (m) {
        if (v.x < 0) v.x += g.n_vertices;
        if (v.y < 0) v.y += g.n_vertices;
        if (v.z < 0) v.z += g.n_vertices;
        if (v.w < 0) v.w += g.n_vertices;
        *at = v;
      }
      unsigned delta = m << (4 * piece);
      delta |= __shfl_xor_sync(0xffffffffu, delta, 1);
      delta |= __shfl_xor_sync(0xffffffffu, delta, 2);
      delta |= __shfl_xor_sync(0xffffffffu, delta, 4);
      if (piece == 0 && live)
        buf.out[ob + w] = __ldcg(buf.oi + w * n_batch + b) | delta;
    }
  }
}

}  // namespace bfs
