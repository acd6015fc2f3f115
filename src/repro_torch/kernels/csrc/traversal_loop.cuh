// The in-kernel layer loop of the whole-traversal kernels, shared by K6
// (traversal_fused.cu, CSR) and K10 (sell_traversal_fused.cu, SELL-C-σ).
//
// From the initial (frontier, visited, P) of B roots, the engine's layer
// loop until every frontier is empty or max_layers layers ran.  Each
// layer:
//   measure  per-root frontier popcount and degree sum (and, for
//            BeamerHybrid, the unvisited set's), exact int64, from the
//            padded degree array `deg`;
//   decide   the direction policy on those counters (kind + parameters;
//            the batch sums are float32 of the exact int64 sums, the
//            same numbers the engine's policies compare);
//   sweep    the layout's plan (count, write) and gather with the
//            layer's direction (`Layer::plan_count`, `plan_write`,
//            `gather`);
//   update   restore P, frontier = out, visited |= out, next layer's
//            counters, the stats row (launches column 1 on layer 0 only;
//            tiles column the batch's n_active sum in every mode).
// Outputs: (frontier, visited, P, depths (B,), layers (1,), stats
// (max_layers, 8)) — the engine's whole-traversal contract.
//
// The phases are separated by grid barriers of a cooperative launch: 2
// at start-up, 4 per layer.  Every CTA reads the same counters after a
// barrier and decides the same direction, so the loop needs no
// broadcast and ends in step.  CTA 0 alone writes the stats row, depths
// and layer count.  State rewritten between layers is read with
// ld.global.cg only.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fused_phases.cuh"

namespace bfs {

constexpr int kModeScalar = 0, kModeSimd = 1, kModeBottomUp = 2;
constexpr int kTopDown = 0, kThresholdSimd = 1, kPaperLayers = 2,
              kBeamer = 3;
constexpr int kStatCols = 8;

struct Policy {
  int kind;
  float alpha;           // BeamerHybrid: unexplored-edges divisor
  float v_over_beta;     // BeamerHybrid: V * B / beta, as float32
  float threshold;       // ThresholdSimd: simd_threshold, as float32
  const int* simd_layer; // PaperLiteralLayers: (max_layers,) 0/1
};

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
  int n_batch, max_layers, depth;
};

// The policies of core/engine.py on float32 batch sums.
__device__ inline int decide(const Policy& pol, int layer, float f_count,
                             float f_edges, float u_count, float u_edges,
                             bool* bottom_up) {
  switch (pol.kind) {
    case kThresholdSimd:
      *bottom_up = false;
      return f_edges >= pol.threshold ? kModeSimd : kModeScalar;
    case kPaperLayers:
      *bottom_up = false;
      return __ldg(pol.simd_layer + layer) ? kModeSimd : kModeScalar;
    case kBeamer: {
      const bool bu = *bottom_up;
      const bool down = !bu && (f_edges > __fdiv_rn(u_edges, pol.alpha));
      const bool up = bu && (f_count < pol.v_over_beta);
      *bottom_up = down || (!up && bu);
      return (*bottom_up && u_count > 0.f) ? kModeBottomUp : kModeSimd;
    }
    case kTopDown:
    default:
      *bottom_up = false;
      return kModeScalar;
  }
}

// Add one word's counters (lane k: vertex 32 w + k) to c: frontier
// count and degree sum, and the unvisited set's when asked.  G has deg.
template <class G>
__device__ __forceinline__ void count_word(const G& g, long long w,
                                           unsigned fw, unsigned vw,
                                           bool unvisited, int lane,
                                           long long (&c)[4]) {
  const bool in_f = (fw >> lane) & 1u;
  const bool in_u = unvisited && !((vw >> lane) & 1u);
  if (in_f || in_u) {
    const int d = __ldg(g.deg + w * 32 + lane);
    if (in_f) { c[0] += 1; c[1] += d; }
    if (in_u) { c[2] += 1; c[3] += d; }
  }
}

// One root's counters, reduced over the CTA, added to acc (4 values).
__device__ __forceinline__ void flush_counters(long long (&c)[4],
                                               unsigned long long* acc) {
  block_sum(c);
  if (threadIdx.x == 0)
    for (int k = 0; k < 4; ++k)
      if (c[k]) atomicAdd(acc + k, static_cast<unsigned long long>(c[k]));
}

// Layer 0's counters from the initial state.
template <class G>
__device__ void count_state(const G& g, const Traversal& t, bool unvisited,
                            unsigned long long* acc) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < t.n_batch; ++b) {
    long long c[4] = {0, 0, 0, 0};
    for (long long w = grid_warp(); w < g.n_words; w += grid_warps()) {
      const long long q = static_cast<long long>(b) * g.n_words + w;
      count_word(g, w, __ldcg(t.frontier + q), __ldcg(t.visited + q),
                 unvisited, lane, c);
    }
    flush_counters(c, acc + 4 * b);
  }
}

// Restore P, move out into the frontier, OR it into visited, zero out
// for the next layer, and count the next layer's counters.
template <class G>
__device__ void restore_update(const G& g, const Traversal& t,
                               unsigned* out, bool unvisited,
                               unsigned long long* acc) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < t.n_batch; ++b) {
    long long c[4] = {0, 0, 0, 0};
    for (long long w = grid_warp(); w < g.n_words; w += grid_warps()) {
      const long long q = static_cast<long long>(b) * g.n_words + w;
      const unsigned delta = restore_word(
          t.p + static_cast<long long>(b) * g.v_pad + w * 32, lane,
          g.n_vertices);
      const unsigned fw = __ldcg(out + q) | delta;
      const unsigned vw = __ldcg(t.visited + q) | fw;
      __syncwarp();
      if (lane == 0) {
        t.frontier[q] = fw;
        t.visited[q] = vw;
        out[q] = 0u;
      }
      count_word(g, w, fw, vw, unvisited, lane, c);
    }
    flush_counters(c, acc + 4 * b);
  }
}

// The whole loop.  Layer provides `g` (deg, n_words, v_pad, n_vertices)
// and plan_count(words, complement, n_batch, buf), plan_write(words,
// complement, n_batch, buf) and gather(frontier, visited, p, buf,
// n_batch, bottom_up, scalar, depth, ring); every CTA calls it.
template <class Layer>
__device__ void traversal_loop(const Layer& L, const Traversal& t,
                               const LayerBuffers& buf, const Policy& pol,
                               int* ring) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const auto& g = L.g;
  const int n_batch = t.n_batch;
  const long long n_bits = static_cast<long long>(n_batch) * g.n_words;
  const long long n_p = static_cast<long long>(n_batch) * g.v_pad;
  const long long n_acc = (t.max_layers + 1LL) * n_batch * 4;
  const long long n_stats = static_cast<long long>(t.max_layers) * kStatCols;
  const long long n_init = max(max(n_p, n_acc), n_stats);
  const bool unvisited = pol.kind == kBeamer;

  // start-up: copy the initial state, zero outputs and counters
  for (long long i = grid.thread_rank(); i < n_init; i += grid.size()) {
    if (i < n_p) t.p[i] = __ldg(t.p0 + i);
    if (i < n_bits) {
      t.frontier[i] = __ldg(t.f0 + i);
      t.visited[i] = __ldg(t.vis0 + i);
      buf.out[i] = 0u;
    }
    if (i < n_acc) t.acc[i] = 0ull;
    if (i < n_stats) t.stats[i] = 0;
    if (i < n_batch) t.depths[i] = 0;
    if (i == 0) t.layers[0] = 0;
  }
  grid.sync();
  count_state(g, t, unvisited, t.acc);
  grid.sync();

  bool bottom_up = false;
  for (int l = 0; l < t.max_layers; ++l) {
    const unsigned long long* acc_l = t.acc + 4LL * n_batch * l;
    long long tot[4] = {0, 0, 0, 0};
    for (int b = 0; b < n_batch; ++b)
      for (int k = 0; k < 4; ++k)
        tot[k] += static_cast<long long>(__ldcg(acc_l + 4 * b + k));
    if (tot[0] == 0) break;                 // every frontier is empty
    const int mode = decide(pol, l, __ll2float_rn(tot[0]),
                            __ll2float_rn(tot[1]), __ll2float_rn(tot[2]),
                            __ll2float_rn(tot[3]), &bottom_up);
    const bool is_bu = mode == kModeBottomUp;
    const unsigned* plan_words = is_bu ? t.visited : t.frontier;

    L.plan_count(plan_words, is_bu, n_batch, buf);
    grid.sync();
    L.plan_write(plan_words, is_bu, n_batch, buf);
    grid.sync();
    L.gather(t.frontier, t.visited, t.p, buf, n_batch, is_bu,
             mode == kModeScalar, t.depth, ring);
    grid.sync();
    restore_update(g, t, buf.out, unvisited, t.acc + 4LL * n_batch * (l + 1));
    grid.sync();

    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long* acc_n = acc_l + 4LL * n_batch;
      long long discovered = 0, tiles = 0;
      for (int b = 0; b < n_batch; ++b) {
        discovered += static_cast<long long>(__ldcg(acc_n + 4 * b));
        tiles += __ldcg(buf.na + b);
        if (__ldcg(acc_l + 4 * b) > 0) t.depths[b] += 1;
      }
      int* row = t.stats + kStatCols * l;
      row[0] = static_cast<int>(tot[0]);
      row[1] = static_cast<int>(tot[1]);
      row[2] = static_cast<int>(discovered);
      row[3] = mode;
      row[4] = 1;
      row[5] = static_cast<int>(tiles);
      row[6] = 0;
      row[7] = l == 0 ? 1 : 0;
      t.layers[0] = l + 1;
    }
  }
}

}  // namespace bfs
