// K6: a whole multi-root BFS traversal in ONE cooperative launch, for
// Hopper.
//
// Replaces: src/repro/kernels/traversal_fused.py,
// `traversal_fused_batched` (Pallas body `_traversal_kernel`:
// `_init_state`, `_persistent_layer_loop` with `_layer_counters`,
// `_decide` and the `_gather_tile_dyn` sweep).  The SELL variant
// (`sell_traversal_fused_batched`) is not ported here.
//
// What it computes: from the initial (frontier, visited, P) of B roots,
// the layer loop of the engine until every frontier is empty or
// max_layers layers ran.  Each layer:
//   measure  per-root frontier popcount and degree sum (and, for
//            BeamerHybrid, the unvisited set's), exact int64;
//   decide   the direction policy on those counters (kind + parameters;
//            the batch sums are float32 of the exact int64 sums, the
//            same numbers the engine's policies compare);
//   sweep    K5's plan, gather and restore (fused_phases.cuh) with the
//            layer's direction; a scalar-mode layer tests the pre-layer
//            visited only (`_gather_tile_dyn`);
//   update   frontier = out, visited |= out, next layer's counters, the
//            stats row (launches column 1 on layer 0 only; tiles column
//            the batch's n_active sum in every mode).
// Outputs: (frontier, visited, P, depths (B,), layers (1,), stats
// (max_layers, 8)) — the engine's whole-traversal contract.
//
// The TPU kernel keeps the state in VMEM across layers; here it lives in
// device memory (and mostly L2) and the layers' phases are separated by
// grid barriers of a cooperative launch: 2 at start-up, 4 per layer.
// Every CTA reads the same counters after a barrier and decides the
// same direction, so the loop needs no broadcast and ends in step.
// CTA 0 alone writes the stats row, depths and layer count.
//
// What bounds it on this card: the gathers, as K5; plus per layer one
// pass over P (restoration) and over the bitmaps and degrees (counters).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fused_phases.cuh"

namespace cg = cooperative_groups;

namespace {

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
__device__ int decide(const Policy& pol, int layer, float f_count,
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
// count and degree sum, and the unvisited set's when asked.
__device__ __forceinline__ void count_word(const bfs::FusedGraph& g,
                                           long long w, unsigned fw,
                                           unsigned vw, bool unvisited,
                                           int lane, long long (&c)[4]) {
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
  bfs::block_sum(c);
  if (threadIdx.x == 0)
    for (int k = 0; k < 4; ++k)
      if (c[k]) atomicAdd(acc + k, static_cast<unsigned long long>(c[k]));
}

// Layer 0's counters from the initial state.
__device__ void count_state(const bfs::FusedGraph& g, const Traversal& t,
                            bool unvisited, unsigned long long* acc) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < t.n_batch; ++b) {
    long long c[4] = {0, 0, 0, 0};
    for (long long w = bfs::grid_warp(); w < g.n_words;
         w += bfs::grid_warps()) {
      const long long q = static_cast<long long>(b) * g.n_words + w;
      count_word(g, w, __ldcg(t.frontier + q), __ldcg(t.visited + q),
                 unvisited, lane, c);
    }
    flush_counters(c, acc + 4 * b);
  }
}

// Restore P, move out into the frontier, OR it into visited, zero out
// for the next layer, and count the next layer's counters.
__device__ void restore_update(const bfs::FusedGraph& g, const Traversal& t,
                               unsigned* out, bool unvisited,
                               unsigned long long* acc) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < t.n_batch; ++b) {
    long long c[4] = {0, 0, 0, 0};
    for (long long w = bfs::grid_warp(); w < g.n_words;
         w += bfs::grid_warps()) {
      const long long q = static_cast<long long>(b) * g.n_words + w;
      const unsigned delta = bfs::restore_word(
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

__global__ void __launch_bounds__(bfs::kThreads)
    traversal_fused_kernel(bfs::FusedGraph g, Traversal t,
                           bfs::LayerBuffers buf, Policy pol) {
  extern __shared__ __align__(16) int stage[];
  cg::grid_group grid = cg::this_grid();
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

    bfs::plan_count(g, plan_words, is_bu, n_batch, buf.cnt);
    grid.sync();
    bfs::plan_write(g, plan_words, is_bu, n_batch, buf);
    grid.sync();
    bfs::gather(g, t.frontier, t.visited, t.p, buf, n_batch, is_bu,
                mode == kModeScalar, t.depth, stage);
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

size_t stage_bytes(int depth, int tile) {
  return depth > 0 ? static_cast<size_t>(depth + 1) * tile * sizeof(int)
                   : 0;
}

}  // namespace

extern "C" int repro_traversal_fused_grid(int depth, int tile,
                                          int ctas_per_sm, int* grid) {
  return bfs::cooperative_grid(traversal_fused_kernel,
                               stage_bytes(depth, tile), ctas_per_sm, grid);
}

// f0, vis0: (B, n_words) words and p0: (B, v_pad) int32, read only.
// frontier, visited, p, depths (B,), layers (1,), stats (max_layers, 8)
// are the outputs; out (B, n_words), wl (B, n_blocks), cnt (B, grid),
// na (B,) and acc ((max_layers + 1) * B * 4 uint64) are scratch.
// simd_layer: (max_layers,) int32 (PaperLiteralLayers only; may be
// null for other kinds).
extern "C" int repro_traversal_fused(
    const void* rows, const void* cs, const void* blk_lo, const void* blk_hi,
    const void* nz, const void* deg, const void* f0, const void* vis0,
    const void* p0, void* frontier, void* visited, void* p, void* out,
    void* wl, void* cnt, void* na, void* acc, void* depths, void* layers,
    void* stats, const void* simd_layer, int n_batch, int n_blocks,
    int tile, int n_cs, int n_words, int v_pad, int n_vertices, int depth,
    int max_layers, int kind, float alpha, float v_over_beta,
    float threshold, int grid, void* stream) {
  if (n_batch == 0) return 0;
  bfs::FusedGraph g{static_cast<const int*>(rows),
                    static_cast<const int*>(cs),
                    static_cast<const int*>(blk_lo),
                    static_cast<const int*>(blk_hi),
                    static_cast<const unsigned*>(nz),
                    static_cast<const int*>(deg),
                    n_blocks, tile, n_cs, n_words, v_pad, n_vertices};
  Traversal t{static_cast<const unsigned*>(f0),
              static_cast<const unsigned*>(vis0),
              static_cast<const int*>(p0),
              static_cast<unsigned*>(frontier),
              static_cast<unsigned*>(visited),
              static_cast<int*>(p),
              static_cast<unsigned long long*>(acc),
              static_cast<int*>(depths),
              static_cast<int*>(layers),
              static_cast<int*>(stats),
              n_batch, max_layers, depth};
  bfs::LayerBuffers buf{static_cast<unsigned*>(out), static_cast<int*>(wl),
                        static_cast<int*>(cnt), static_cast<int*>(na)};
  Policy pol{kind, alpha, v_over_beta, threshold,
             static_cast<const int*>(simd_layer)};
  void* args[] = {&g, &t, &buf, &pol};
  return bfs::launch_cooperative(traversal_fused_kernel, grid,
                                 stage_bytes(depth, tile), stream, args);
}
