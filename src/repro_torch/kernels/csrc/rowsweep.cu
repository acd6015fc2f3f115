// The distributed step's rowsweep for Hopper (not a TPU kernel: the
// reference writes it in jnp, src/repro/core/bfs_distributed.py
// `_local_step` = src/repro/core/engine.py `rowsweep_stream` +
// `candidate_scatter`).
//
// Replaces: the plain-torch `engine.rowsweep_stream` + `candidate_scatter`
// on the card: a degree expansion and a bitmap gate over every edge slot
// of the shard, then a scatter-min over int64 indices (five temporaries
// of e_loc entries each layer, ~0.5 GB apiece at SCALE 22 on one shard).
//
// What it computes: one shard's top-down layer.  The shard owns vertices
// [base, base + v_loc) and their out-edges as a rebased CSR slice
// (colstarts (v_loc + 1,), rows (e_loc,) of global neighbour ids); the
// frontier and visited bitmaps are the replicated (w_cap,) global words.
// cand (v_cap,) arrives filled with n_vertices (INF, by the wrapper) and
// leaves holding, for every vertex v < n_vertices that is not visited,
// the least global id base + u of a frontier vertex u of the shard with
// an edge to v.  atomicMin does not depend on order, so the result
// equals the plain version bitwise.
//
// Design: one warp per 32-bit word of the shard's frontier slice (a
// grid-stride loop over the words base/32 .. base/32 + v_loc/32); a zero
// word leaves at once.  Lane j loads colstarts[u0 + j] and [u0 + j + 1];
// the degrees of the word's set bits are scanned across the warp, so the
// warp walks the word's adjacency lists as one run of `total` slots, 32
// at a time and kSlots runs in flight per lane: slot s belongs to the
// first lane whose inclusive degree sum exceeds s (a five-step shuffle
// search), and reads rows[start of that lane + s - its exclusive sum].
// Every lane stays busy whatever the degrees, and the rows of one list
// are read in order.  A hub's list is walked by its word's one warp: a
// degree-300k vertex is ~2,400 warp steps of kSlots loads; that tail is
// the kernel's known weakness (ROADMAP §3b).
//
// What bounds it on this card: bytes.  The shard's frontier words, its
// colstarts, the rows of the active owners and the visited words read
// once, the candidate array written once (by the wrapper's fill) and
// written again where a candidate lands; the rows dominate on a large
// layer.  `chip_smoke.py` phase 13a counts these bytes per shard.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;            // slot runs in flight per lane
constexpr unsigned kFull = 0xffffffffu;

struct Sweep {
  const int* rows;              // (e_loc,) global neighbour ids
  const int* colstarts;         // (v_loc + 1,) rebased
  const unsigned* frontier;     // (w_cap,) global words
  const unsigned* visited;      // (w_cap,) global words
  int* cand;                    // (v_cap,) filled with n_vertices
  int n_words;                  // v_loc / 32: the shard's words
  int word0;                    // base / 32
  int base;
  int n_vertices;
};

__global__ void __launch_bounds__(kThreads) rowsweep_kernel(Sweep sw) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  for (int w = (blockIdx.x * kThreads + threadIdx.x) >> 5; w < sw.n_words;
       w += warps) {
    const unsigned word = __ldg(sw.frontier + sw.word0 + w);
    if (word == 0u) continue;                       // warp-uniform
    const int u0 = w * 32;
    const int start = __ldg(sw.colstarts + u0 + lane);
    const int deg =
        (word >> lane) & 1u ? __ldg(sw.colstarts + u0 + lane + 1) - start
                            : 0;
    int cum = deg;                                  // inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, cum, d);
      if (lane >= d) cum += x;
    }
    const int total = __shfl_sync(kFull, cum, 31);
    // rows index of slot s, for the slots this lane owns: first + s
    const int first = start - (cum - deg);
    for (int s0 = 0; s0 < total; s0 += 32 * kSlots) {
      int v[kSlots], owner[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int s = s0 + i * 32 + lane;
        // the lanes with cum <= s (31 when s >= total, masked below)
        int k = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, cum, k + step - 1) <= s) k += step;
        const int f = __shfl_sync(kFull, first, k);
        owner[i] = k;
        v[i] = s < total ? __ldg(sw.rows + f + s) : -1;
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int x = v[i];
        if (x < 0 || x >= sw.n_vertices) continue;
        const unsigned vis = __ldg(sw.visited + (x >> 5));
        if (!((vis >> (x & 31)) & 1u))
          atomicMin(sw.cand + x, sw.base + u0 + owner[i]);
      }
    }
  }
}

}  // namespace

// rows (e_loc,), colstarts (v_loc + 1,), frontier and visited (w_cap,)
// int32; cand (v_cap,) int32 filled with n_vertices, min-updated.
extern "C" int repro_rowsweep(const void* rows, const void* colstarts,
                              const void* frontier, const void* visited,
                              void* cand, int n_words, int word0, int base,
                              int n_vertices, int grid, void* stream) {
  if (n_words == 0 || grid <= 0) return 0;
  Sweep sw{static_cast<const int*>(rows), static_cast<const int*>(colstarts),
           static_cast<const unsigned*>(frontier),
           static_cast<const unsigned*>(visited), static_cast<int*>(cand),
           n_words, word0, base, n_vertices};
  rowsweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sw);
  return static_cast<int>(cudaGetLastError());
}
