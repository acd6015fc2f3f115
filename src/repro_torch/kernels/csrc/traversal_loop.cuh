// The in-kernel layer loop of the whole-traversal kernels, shared by K6
// (traversal_fused.cu, CSR) and K10 (sell_traversal_fused.cu, SELL-C-σ).
//
// From the initial (frontier, visited, P) of B roots, the engine's layer
// loop until every frontier is empty or max_layers layers ran.  Each
// layer:
//   decide   the direction policy on the layer's Table-1 counters (per
//            root the frontier's popcount and degree sum and, for
//            BeamerHybrid, the unvisited set's, exact int64 from the
//            padded degree array `deg`; the batch sums are float32 of
//            the exact int64 sums, the same numbers the engine's
//            policies compare; `count4`, `flush_counters` and `decide`
//            are counters.cuh's, shared with the host loops' measure
//            kernel, measure.cu);
//   1. plan  root masks of the CTA's chunk of items from the planning
//            words (the frontier, or visited bottom-up) and per-CTA
//            counts (`Layer::masks`, `union_counts`, union_phases.cuh);
//   2.       the ascending union of the batch's lists, its count and
//            each root's n_active (`union_write`);
//   3. walk  one CTA per union item for every root of its mask
//            (`Layer::walk`: `walk_csr`, or on K6's bottom-up layers
//            `walk_csr_bottom_up`, or `walk_sell`), on the
//            root-interleaved state;
//   4. update restore P, frontier = out | delta, visited |= frontier,
//            the interleaved out zeroed, and the next layer's counters,
//            in one pass (`update_state`);
//   then CTA 0 writes the stats row (launches column 1 on layer 0 only;
//   tiles column the batch's n_active sum in every mode), the depths
//   and the layer count.
// Outputs: (frontier, visited, P, depths (B,), layers (1,), stats
// (max_layers, 8)) — the engine's whole-traversal contract.
//
// The phases are separated by grid barriers of a cooperative launch: 2
// at start-up, 4 per layer.  Every CTA reads the same counters after a
// barrier and decides the same direction, so the loop needs no
// broadcast and ends in step.
//
// Phase tracing (`Traversal::stamps`, `waits` and `walked`).  The
// kernels are built twice, untraced and traced (`kTraced`), and
// `launch_traversal` launches the traced one where any is set, so the
// untraced loop carries no line of tracing; the traced one writes each
// buffer that is set and changes no output.  stamps, int64 %globaltimer ns
// written by CTA 0's thread 0: [0] at entry, [1], [2] after the start-up
// barriers, [3 + 4 l + k] after barrier k of layer l; as every CTA has
// arrived when CTA 0 leaves a barrier, consecutive stamps bound a phase
// of the whole grid.  waits, uint64 SM cycles (`clock64`, divided only
// by cycles): [4 l + k] the summed wait of every CTA at barrier k of
// layer l (from its `__syncthreads` before the barrier to its exit),
// [4 max_layers + k] the start-up barriers', then [4 (max_layers + 1)]
// every CTA's entry-to-exit cycles and [4 (max_layers + 1) + 1] the
// CTAs that exited.  walked (K6 only), uint64: [2 l] the neighbour
// entries layer l's bottom-up walk tested, [2 l + 1] the slots of the
// blocks it walked (`walk_csr_bottom_up`; 0 on other layers).
//
// State across layers.  The planning reads each root's words in rows,
// (B, n_words); the walk reads them root-interleaved, (n_words, B), so
// that the B words of one vertex share a sector.  The start-up pass
// writes the initial state into both layouts and every update pass
// writes the new frontier and visited into both, so no phase restages
// the state; the rows are the outputs.  Loads: the planning words, P
// and the counters through L2 (ld.global.cg); the walk's masks, list and
// interleaved words, and the update's interleaved words, by plain loads
// (`ld_walk<false>`) after a grid barrier, whose acquire invalidates the
// SM's L1 (bfs_common.cuh), so that no layer reads a line an earlier
// layer left in L1.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "union_phases.cuh"
#include "counters.cuh"

namespace bfs {

// K6's and K10's minimum of resident CTAs per SM (`__launch_bounds__`;
// tools/sweep_launch_bounds.py rebuilds them at other values)
constexpr int kTraversalCtas = 5;

struct Traversal {
  const unsigned* f0;
  const unsigned* vis0;
  const int* p0;
  unsigned* frontier;
  unsigned* visited;
  int* p;
  unsigned long long* acc;   // (max_layers + 1, B, 4) counters
  int* depths;               // (B,)
  int* layers;               // (1,)
  int* stats;                // (max_layers, 8)
  long long* stamps;         // (3 + 4 max_layers) or null: phase stamps
  unsigned long long* waits; // (4 (max_layers + 1) + 2) or null
  int n_batch, max_layers, depth;
  unsigned long long* walked = nullptr;  // (2 max_layers) or null: K6's
                                         // bottom-up examined, slots
};

__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// grid.sync(), with the barrier's stamp and wait in the traced loop
// (the slots as in the header above)
template <bool kTraced>
__device__ __forceinline__ void grid_barrier(
    cooperative_groups::grid_group& grid, const Traversal& t, int stamp,
    int wait) {
  if constexpr (!kTraced) {
    grid.sync();
  } else {
    long long before = 0;
    if (t.waits != nullptr) {
      __syncthreads();
      before = clock64();
    }
    grid.sync();
    if (threadIdx.x == 0) {
      const long long after = clock64();
      if (t.stamps != nullptr && blockIdx.x == 0)
        t.stamps[stamp] = global_ns();
      if (t.waits != nullptr)
        atomicAdd(t.waits + wait,
                  static_cast<unsigned long long>(after - before));
    }
  }
}

// A CTA's entry (`sign` -1) and exit (+1) into the cycle total: the
// sum of (exit - entry) modulo 2^64, with no clock held across the loop
__device__ __forceinline__ void cta_cycles(const Traversal& t, int sign) {
  if (t.waits == nullptr || threadIdx.x != 0) return;
  unsigned long long* total = t.waits + 4LL * (t.max_layers + 1);
  const unsigned long long now = clock64();
  atomicAdd(total, sign < 0 ? 0ull - now : now);
  if (sign > 0) atomicAdd(total + 1, 1ull);
}

// Launch the traced instantiation where `t` carries a tracing buffer,
// else the untraced one, on the untraced one's grid: the traced build
// holds the same registers (the launch bounds) and shared memory, so
// its CTAs are as co-resident (a grid that were not would fail the
// launch, cudaErrorCooperativeLaunchTooLarge).
template <class Kernel>
int launch_traversal(Kernel plain, Kernel traced, const Traversal& t,
                     int grid, size_t smem, void* stream, void** args) {
  const bool on =
      t.stamps != nullptr || t.waits != nullptr || t.walked != nullptr;
  return launch_cooperative(on ? traced : plain, grid, smem, stream, args);
}

// The start-up pass (kStart) or a layer's update pass over every root's
// state, counting the next layer's counters into acc ((B, 4)).  A warp
// takes 4 words (128 vertices) at a time, lane l the 4 entries
// 4 (l & 7) .. 4 (l & 7) + 3 of word l >> 3, with their 4 degrees in one
// 16-byte load that serves every root of a chunk of 32; per root:
//   kStart: P copied from p0 by one 16-byte load per lane, the words
//           from f0 and vis0;
//   update: P restored by one 16-byte load per lane where the word's
//           interleaved out is not zero (every negative mark was
//           written with a bit of its out word; `full`, on layer 0,
//           restores every word, as the plain version restores any mark
//           p0 carries), the 8 lanes of a word ORing their pieces of the
//           delta; frontier = out | delta, visited |= frontier;
// then the words go to both layouts and the interleaved out is zeroed.
// Lane j of each warp sums root b0 + j's counters of the warp's steps,
// in int32 (every count and degree sum fits: colstarts are int32); they
// are reduced over the CTA at the chunk's end.  G has deg, n_words and
// v_pad (= 32 n_words).
template <bool kStart, class G>
__device__ void update_state(const G& g, const Traversal& t,
                             const UnionBuffers& buf, bool unvisited,
                             bool full, unsigned long long* acc) {
  const int lane = threadIdx.x & 31, piece = lane & 7;
  const long long n_batch = t.n_batch;
  const long long n_steps = (g.n_words + 3) / 4;
  for (int b0 = 0; b0 < t.n_batch; b0 += 32) {
    const int nb = min(32, t.n_batch - b0);
    int mine[4] = {0, 0, 0, 0};
    for (long long s = grid_warp(); s < n_steps; s += grid_warps()) {
      const long long w = 4 * s + (lane >> 3);
      const bool live = w < g.n_words;
      const long long e = 32 * w + 4 * piece;
      const int4 d = live ? __ldg(reinterpret_cast<const int4*>(g.deg + e))
                          : make_int4(0, 0, 0, 0);
      for (int j = 0; j < nb; ++j) {
        const long long b = b0 + j;
        const long long r = b * g.n_words + w;      // (B, n_words)
        const long long q = w * n_batch + b;        // (n_words, B)
        int4* at = reinterpret_cast<int4*>(t.p + b * g.v_pad + e);
        unsigned fw = 0u, vw = ~0u;
        if constexpr (kStart) {
          if (live) {
            *at = __ldg(reinterpret_cast<const int4*>(t.p0 + b * g.v_pad +
                                                      e));
            fw = __ldg(t.f0 + r);
            vw = __ldg(t.vis0 + r);
          }
        } else {
          unsigned m = 0u, ow = 0u, old_vw = 0u;
          if (live) {
            ow = ld_walk<false>(buf.oi + q);
            old_vw = ld_walk<false>(buf.vi + q);
            if (full || ow) {
              int4 v = __ldcg(at);
              m = (v.x < 0) | (v.y < 0) << 1 | (v.z < 0) << 2 |
                  (v.w < 0) << 3;
              if (m) {
                if (v.x < 0) v.x += g.n_vertices;
                if (v.y < 0) v.y += g.n_vertices;
                if (v.z < 0) v.z += g.n_vertices;
                if (v.w < 0) v.w += g.n_vertices;
                *at = v;
              }
            }
          }
          unsigned delta = m << (4 * piece);
          delta |= __shfl_xor_sync(0xffffffffu, delta, 1);
          delta |= __shfl_xor_sync(0xffffffffu, delta, 2);
          delta |= __shfl_xor_sync(0xffffffffu, delta, 4);
          if (live) {
            fw = ow | delta;
            vw = old_vw | fw;
          }
        }
        if (piece == 0 && live) {
          t.frontier[r] = fw;
          t.visited[r] = vw;
          buf.fi[q] = fw;
          buf.vi[q] = vw;
          buf.oi[q] = 0u;
        }
        int n, deg_sum;
        count4((fw >> (4 * piece)) & 0xfu, d, &n, &deg_sum);
        if (lane == j) {
          mine[0] += n;
          mine[1] += deg_sum;
        }
        if (unvisited) {
          count4((~vw >> (4 * piece)) & 0xfu, d, &n, &deg_sum);
          if (lane == j) {
            mine[2] += n;
            mine[3] += deg_sum;
          }
        }
      }
    }
    for (int j = 0; j < nb; ++j) {
      long long c[4];
      for (int k = 0; k < 4; ++k) c[k] = lane == j ? mine[k] : 0;
      flush_counters(c, acc + 4 * (b0 + j));
    }
  }
}

// The whole loop; every CTA calls it.  Layer provides `g` (deg,
// n_words, v_pad, n_vertices), n_items(), masks(words, complement,
// n_batch, rmask, begin, end) (the root masks of items [begin, end))
// and walk<kTraced>(buf, p, n_batch, bottom_up, scalar, depth, smem,
// walked) (walked: the layer's slots of `Traversal::walked`, null in
// the untraced loop).  buf.out is unused: the update pass writes the
// frontier rows.
template <bool kTraced, class Layer>
__device__ void traversal_loop(const Layer& L, const Traversal& t,
                               const UnionBuffers& buf, const Policy& pol,
                               int* smem) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const auto& g = L.g;
  const int n_batch = t.n_batch;
  const int n_mask_words = (n_batch + 31) >> 5;
  const long long n_acc = (t.max_layers + 1LL) * n_batch * 4;
  const long long n_stats = static_cast<long long>(t.max_layers) * kStatCols;
  const bool unvisited = pol.kind == kBeamer;
  const int startup = 4 * t.max_layers;    // the start-up barriers' waits
  if constexpr (kTraced) {
    cta_cycles(t, -1);
    if (t.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      t.stamps[0] = global_ns();
  }

  // start-up: zero counters and outputs; copy the initial state into
  // both layouts and count layer 0
  for (long long i = grid.thread_rank(); i < max(n_acc, n_stats);
       i += grid.size()) {
    if (i < n_acc) t.acc[i] = 0ull;
    if (i < n_stats) t.stats[i] = 0;
    if (i < n_batch) t.depths[i] = 0;
    if (i == 0) t.layers[0] = 0;
  }
  grid_barrier<kTraced>(grid, t, 1, startup);
  update_state<true>(g, t, buf, unvisited, false, t.acc);
  grid_barrier<kTraced>(grid, t, 2, startup + 1);

  int begin, end;
  chunk_of_cta(L.n_items(), &begin, &end);
  bool bottom_up = false;
  for (int l = 0; l < t.max_layers; ++l) {
    const unsigned long long* acc_l = t.acc + 4LL * n_batch * l;
    int mode;
    {
      long long tot[4] = {0, 0, 0, 0};
      for (int b = 0; b < n_batch; ++b)
        for (int k = 0; k < 4; ++k)
          tot[k] += static_cast<long long>(__ldcg(acc_l + 4 * b + k));
      if (tot[0] == 0) break;               // every frontier is empty
      mode = decide(pol, l, __ll2float_rn(tot[0]), __ll2float_rn(tot[1]),
                    __ll2float_rn(tot[2]), __ll2float_rn(tot[3]),
                    &bottom_up);
    }
    const bool is_bu = mode == kModeBottomUp;

    // 1. root masks of the CTA's chunk, per-CTA counts
    L.masks(is_bu ? t.visited : t.frontier, is_bu, n_batch, buf.rmask,
            begin, end);
    union_counts(buf.rmask, n_mask_words, n_batch, begin, end, buf.cnt);
    grid_barrier<kTraced>(grid, t, 3 + 4 * l, 4 * l);
    // 2. the union list, its count, each root's count
    union_write<true>(buf.rmask, buf.cnt, buf.ulist, buf.ucount, buf.na,
                      L.n_items(), n_batch);
    grid_barrier<kTraced>(grid, t, 4 + 4 * l, 4 * l + 1);
    // 3. one CTA per union item for every root of its mask
    L.template walk<kTraced>(
        buf, t.p, n_batch, is_bu, mode == kModeScalar, t.depth, smem,
        kTraced && t.walked != nullptr ? t.walked + 2LL * l : nullptr);
    grid_barrier<kTraced>(grid, t, 5 + 4 * l, 4 * l + 2);
    // 4. restoration, the new state in both layouts, next counters
    update_state<false>(g, t, buf, unvisited, l == 0,
                        t.acc + 4LL * n_batch * (l + 1));
    grid_barrier<kTraced>(grid, t, 6 + 4 * l, 4 * l + 3);

    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long* acc_n = acc_l + 4LL * n_batch;
      long long f_count = 0, f_edges = 0, discovered = 0, tiles = 0;
      for (int b = 0; b < n_batch; ++b) {
        f_count += static_cast<long long>(__ldcg(acc_l + 4 * b));
        f_edges += static_cast<long long>(__ldcg(acc_l + 4 * b + 1));
        discovered += static_cast<long long>(__ldcg(acc_n + 4 * b));
        tiles += __ldcg(buf.na + b);
        if (__ldcg(acc_l + 4 * b) > 0) t.depths[b] += 1;
      }
      int* row = t.stats + kStatCols * l;
      row[0] = static_cast<int>(f_count);
      row[1] = static_cast<int>(f_edges);
      row[2] = static_cast<int>(discovered);
      row[3] = mode;
      row[4] = 1;
      row[5] = static_cast<int>(tiles);
      row[6] = 0;
      row[7] = l == 0 ? 1 : 0;
      t.layers[0] = l + 1;
    }
  }
  if constexpr (kTraced) cta_cycles(t, 1);
}

}  // namespace bfs
